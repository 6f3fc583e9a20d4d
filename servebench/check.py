"""The comparison that decides ``correct``.

After the window, a sample of the requests the service finished, drawn from
the seed, is run once through the plain float32 reference (``reference/``)
over each prompt and its served tokens. The sample always holds the longest
finished request and, in a cell with a kill, up to half of it is requests
that resumed on the ring peer from replicated KV. For every served token the
gap by which the reference's logit of that token lies below the reference's
best is read. With greedy decoding the program serves the reference's best
token up to its own rounding, so a sound run reads small gaps, and a wrong
token, a lost KV row or a bad replica large ones.

The configuration file's ``check`` block gives the limit of each number it
compares, ``max_logit_gap`` (the widest gap) and ``mean_logit_gap`` (the
mean over the served tokens), and ``sample_requests`` and ``min_tokens``
(fewer compared tokens fail). In a cell whose traffic has a kill, a run
that compares no request resumed on the peer from replicated KV fails:
the continuation through the replica is what such a cell exists for.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch


def reference_logits(model: dict):
    if model.get("n_experts", 0):
        from servebench.reference import moe
        return moe.logits
    from servebench.reference import dense
    return dense.logits


def expected_length(req: dict, max_seq: int) -> int:
    """Tokens a finished request serves: its budget, or what the slot's
    sequence limit leaves (the engine stops at position max_seq - 1)."""
    return min(req["max_new"], max_seq - req["prompt_len"])


def sample(record, seed: int, n: int) -> List[dict]:
    """Up to ``n`` finished requests: the longest, then up to half resumed
    victims, then the rest, each group in the seed's order."""
    done = [r for r in record.requests if r["finish"] >= 0 and r["output"]]
    if not done:
        return []
    rng = np.random.default_rng([seed % (1 << 63), 7])
    longest = max(done, key=lambda r: (r["prompt_len"] + len(r["output"]),
                                       -r["rid"]))
    rest = [r for r in done if r is not longest]
    order = [rest[i] for i in rng.permutation(len(rest))]
    resumed = [r for r in order if r["migrations"] > 0][: max(0, n // 2)]
    others = [r for r in order if r not in resumed]
    return ([longest] + resumed + others)[:n]


def served_gaps(model: dict, params, reqs: List[dict],
                precision: str = "f32") -> List[np.ndarray]:
    """Per request, for each served token: the reference's best logit minus
    its logit of that token. With ``precision`` other than f32 the token is
    not the served one but the one a reference in that precision puts first
    at the same position (the control)."""
    if not reqs:
        return []
    fn = reference_logits(model)
    seqs = [r["prompt"] + r["output"][:-1] for r in reqs]
    wanted = [range(r["prompt_len"] - 1, r["prompt_len"] - 1 + len(r["output"]))
              for r in reqs]
    ref = fn(model, params, seqs, wanted)
    if precision == "f32":
        picks = [r["output"] for r in reqs]
    else:
        low = fn(model, params, seqs, wanted, precision=precision)
        picks = [x.argmax(-1).tolist() for x in low]
    out = []
    for logits, toks in zip(ref, picks):
        idx = torch.as_tensor(toks, device=logits.device)[:, None]
        gap = logits.max(-1).values - logits.gather(1, idx)[:, 0]
        out.append(gap.cpu().numpy())
    return out


def verdict(config: dict, record, reqs: List[dict],
            gaps: List[np.ndarray]) -> Dict:
    """The numbers compared, each with its limit and whether it holds: those
    of the configuration's ``check`` block, the count of compared tokens,
    and the served lengths."""
    spec = config["check"]
    max_seq = config["engine"]["max_seq"]
    bad_len = sum(1 for r in reqs
                  if len(r["output"]) != expected_length(r, max_seq))
    allg = np.concatenate(gaps) if gaps else np.zeros(0)
    n_tok = int(len(allg))
    numbers = {
        "max_logit_gap": lambda: float(allg.max()),
        "mean_logit_gap": lambda: float(allg.mean()),
    }
    out = {}
    for name, value in numbers.items():
        if name in spec:
            v = value() if n_tok else float("inf")
            out[name] = {"value": v, "limit": float(spec[name]),
                         "ok": v <= float(spec[name])}
    out["tokens_compared"] = {"value": n_tok, "min": int(spec["min_tokens"]),
                              "ok": n_tok >= int(spec["min_tokens"])}
    if record.traffic.get("kill"):
        resumed = sum(1 for r in reqs if r["migrations"] > 0)
        out["resumed_compared"] = {"value": resumed, "min": 1,
                                   "ok": resumed >= 1}
    out["length_errors"] = {"value": bad_len, "limit": 0, "ok": bad_len == 0}
    return out


def check(config: dict, model: dict, params, record, seed: int) -> Dict:
    reqs = sample(record, seed, int(config["check"]["sample_requests"]))
    return verdict(config, record, reqs, served_gaps(model, params, reqs))
