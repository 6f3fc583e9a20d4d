"""The comparison that decides ``correct``.

After the window, a sample of the requests the service finished, drawn from
the seed, is run once through the plain float32 reference of the model's
family (``families/<arch_type>.py``, whose reference is under
``reference/``) over each prompt and its served tokens. The sample always holds the longest
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

Where the configuration replicates (``engine.replicate``, on by default as
in the port), the replicas are read back as well: just after the window
closes, with the engine held between two steps, ``read_back_replicas``
ships what replication has staged (the engine's own barrier, the one a
failover takes) and compares every KV block and state blob of every
decoding request on a live instance with its copy on the ring peer, byte
for byte. A run in which no block was compared, or one differs, or a block
has no copy while the ring has a peer, fails: a replica that would not
resume the request is a weaker guarantee, whatever the served tokens say.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from servebench import families


def reference_logits(model: dict):
    """The plain reference of the model's family (``families/<arch_type>.py``
    names its file under ``reference/``)."""
    return families.load(model).logits


READ_BACK_CHUNK = 64     # blocks compared at a time (~50 MB a tensor at yi-9b)


def _blocks_differing(src_pool, dst_pool, src: List[int], dst: List[int],
                      names) -> torch.Tensor:
    """How many of the blocks ``src`` of ``src_pool`` differ in any byte of
    the buffers ``names`` from the blocks ``dst`` of ``dst_pool`` (buffers
    laid out with the block on axis 2, as the port's pool keeps them)."""
    dev = getattr(src_pool, names[0]).device
    total = torch.zeros((), dtype=torch.long, device=dev)
    for i in range(0, len(src), READ_BACK_CHUNK):
        s = torch.as_tensor(src[i:i + READ_BACK_CHUNK], device=dev)
        d = torch.as_tensor(dst[i:i + READ_BACK_CHUNK], device=dev)
        bad = torch.zeros(len(s), dtype=torch.bool, device=dev)
        for name in names:
            a = getattr(src_pool, name).index_select(2, s)
            b = getattr(dst_pool, name).index_select(2, d)
            ne = a.view(torch.uint8) != b.view(torch.uint8)
            bad |= ne.movedim(2, 0).reshape(len(s), -1).any(1)
        total += bad.sum()
    return total


def read_back_replicas(engine) -> Dict[str, int]:
    """Compare every decoding request's KV blocks (and state blob) on each
    live instance with their replicas on its ring peer. Call it with the
    engine held between two steps. Returns ``compared`` (blocks and blobs
    with a copy), ``differing`` (of those, copies that differ in any byte)
    and ``missing`` (blocks and blobs with no copy while the ring has a
    live peer)."""
    from repro_torch.serving.request import RequestState
    engine.flush_replication(block=True)
    compared = missing = 0
    differing = []
    for inst in engine.instances:
        if not inst.alive:
            continue
        tgt = engine._ring_target(inst.instance_id)
        if tgt < 0 or tgt == inst.instance_id:
            continue
        src_pool, dst_pool = inst.pool, engine.instances[tgt].pool
        kv_names = ("k", "v", "k_scale", "v_scale") if src_pool.quantized \
            else ("k", "v")
        src, dst, bsrc, bdst = [], [], [], []
        for rid, req in inst.requests.items():
            if req.state != RequestState.DECODE:
                continue
            hosted = {r.logical_idx: r.slot for r in
                      dst_pool.replica_table(inst.instance_id, rid)}
            for ref in src_pool.table(rid):
                if ref.logical_idx in hosted:
                    src.append(ref.slot)
                    dst.append(hosted[ref.logical_idx])
                else:
                    missing += 1
            blob = src_pool.blob_ref(rid)
            if blob is not None:
                copy = dst_pool.blob_replica_ref(inst.instance_id, rid)
                if copy is None:
                    missing += 1
                else:
                    bsrc.append(blob.slot)
                    bdst.append(copy.slot)
        compared += len(src) + len(bsrc)
        if src:
            differing.append(_blocks_differing(src_pool, dst_pool, src, dst,
                                               kv_names))
        if bsrc:
            # a blob store is (n_blobs, words): its slot on axis 0
            blob_names = ("blobs", "blob_scales") if src_pool.quantized \
                else ("blobs",)
            for name in blob_names:
                a = getattr(src_pool, name)[bsrc]
                b = getattr(dst_pool, name)[bdst]
                differing.append((a.view(torch.uint8) != b.view(torch.uint8))
                                 .reshape(len(bsrc), -1).any(1).sum())
    return {"compared": compared, "missing": missing,
            "differing": int(sum(int(x) for x in differing))}


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
    if config["engine"].get("replicate", True):
        rb = getattr(record, "replicas", None) or \
            {"compared": 0, "differing": 0, "missing": 0}
        out["replica_blocks_compared"] = {
            "value": rb["compared"], "min": 1, "ok": rb["compared"] >= 1}
        for name in ("differing", "missing"):
            out[f"replica_blocks_{name}"] = {
                "value": rb[name], "limit": 0, "ok": rb[name] == 0}
    out["length_errors"] = {"value": bad_len, "limit": 0, "ok": bad_len == 0}
    return out


def check(config: dict, model: dict, params, record, seed: int) -> Dict:
    reqs = sample(record, seed, int(config["check"]["sample_requests"]))
    return verdict(config, record, reqs, served_gaps(model, params, reqs))
