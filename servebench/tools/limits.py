"""Readings for a cell's check limit, in one process: for each seed one run
of the cell as the benchmark makes it, then the served tokens' gaps to the
float32 reference (the program) and, on the control seeds, the gaps of the
tokens that the reference computed in float8 puts first at the same
positions (the control). Prints one JSON line per seed and a summary.

    python servebench/tools/limits.py --workload <cell> --seconds 51 \\
        --seeds 11,12,... --control-seeds 11,12,13
"""
import argparse
import json
import os
import sys
import time
from pathlib import Path

T_START = time.time()
ROOT = Path(__file__).resolve().parents[2]
for path in (ROOT / "src", ROOT):
    sys.path.insert(0, str(path))
os.environ.setdefault("USE_FLAX", "0")

import numpy as np  # noqa: E402

from servebench import bench, check as CHECK, harness  # noqa: E402


def stats(gaps):
    g = np.concatenate(gaps) if gaps else np.zeros(0)
    if not len(g):
        return {}
    return {"widest": float(g.max()), "p99": float(np.percentile(g, 99)),
            "p95": float(np.percentile(g, 95)), "mean": float(g.mean()),
            "mismatch_share": float((g > 0).mean()), "tokens": int(len(g))}


def routing_look(config, model, params, reqs, gaps):
    """For an MoE model: at which served positions the program's routing
    differs from the reference's. The program's experts are read from the
    port's own prefill over each prompt and its served tokens (its routing
    function, hooked); the reference's from the float32 reference. A
    served token far below the reference's best (gap > 0.1) at a position
    where some layer routed a token to another expert points at a discrete
    flip on rounding, not at drift."""
    import torch
    from repro_torch.models import moe as PM
    from repro_torch.models import paged_decode as PD
    from servebench import harness
    from servebench.reference import moe as RM
    cfg = harness.port_config(config)
    k = model["top_k"]
    ref_rows, prog = [], []
    real_ref, real_route = RM.routed_mlp, PM.route

    def ref_hook(model_, lp, x, mm, precision):
        probs = torch.softmax(mm(x, lp["router"].float()), dim=-1)
        ref_rows.append(probs.topk(k, dim=-1).indices.sort(-1).values.cpu())
        return real_ref(model_, lp, x, mm, precision)

    def prog_hook(cfg_, router, xg, capacity, rows=0):
        out = real_route(cfg_, router, xg, capacity, rows)
        prog[-1].append(out[1].reshape(-1, k).sort(-1).values.cpu())
        return out
    RM.routed_mlp, PM.route = ref_hook, prog_hook
    try:
        CHECK.served_gaps(model, params, reqs)
        differs = []
        for r in reqs:
            seq = r["prompt"] + r["output"][:-1]
            n = len(seq)
            bucket = PD.next_bucket(n, lo=cfg.page_size)
            dev = params["embed"]["tok"].device
            toks = torch.zeros((1, bucket), dtype=torch.int32, device=dev)
            toks[0, :n] = torch.tensor(seq, device=dev)
            prog.append([])
            with torch.no_grad():
                PD.prefill_bucketed(cfg, params, toks, n)
            differs.append(torch.stack([p[:n] for p in prog[-1]]))
    finally:
        RM.routed_mlp, PM.route = real_ref, real_route
    ref = torch.stack(ref_rows)                      # (layers, rows, k)
    lens = [len(r["prompt"]) + len(r["output"]) - 1 for r in reqs]
    offs = np.concatenate([[0], np.cumsum(lens)[:-1]])
    flips = []
    for o, r, p in zip(offs, reqs, differs):
        lo = r["prompt_len"] - 1
        pos = np.arange(lo, lo + len(r["output"]))
        diff = (p[:, pos] != ref[:, o + pos]).any(-1).any(0).numpy()
        flips.append(diff)
    f = np.concatenate(flips)
    g = np.concatenate(gaps)
    far = g > 0.1
    return {"far_tokens": int(far.sum()), "tokens": int(len(g)),
            "far_at_flip": float(f[far].mean()) if far.any() else None,
            "near_at_flip": float(f[~far].mean()) if (~far).any() else None,
            "all_at_flip": float(f.mean())}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--dump", default="",
                    help="directory for each run's per-request record")
    args = ap.parse_args()
    cell = bench.resolve(args.workload)
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    rows, keep = [], {}
    for seed in (int(s) for s in args.seeds.split(",")):
        row = {"seed": seed}

        def check_fn(config, model, params, record, seed_):
            keep["record"] = record
            reqs = CHECK.sample(record, seed_,
                                int(config["check"]["sample_requests"]))
            gaps = CHECK.served_gaps(model, params, reqs)
            row["program"] = stats(gaps)
            row["resumed"] = sum(1 for r in reqs if r["migrations"] > 0)
            if model.get("n_experts") and seed_ in controls:
                row["look"] = routing_look(config, model, params, reqs, gaps)
            if seed_ in controls:
                t0 = time.time()
                row["control"] = stats(CHECK.served_gaps(
                    model, params, reqs, precision="fp8"))
                row["control_s"] = time.time() - t0
            return CHECK.verdict(config, record, reqs, gaps)

        t0 = time.time()
        res = harness.run_cell(cell, seed, args.seconds, False,
                               t_start=t0, check_fn=check_fn)
        row["run_s"] = time.time() - t0
        if args.dump:
            rec = keep["record"]
            Path(args.dump).mkdir(parents=True, exist_ok=True)
            with open(Path(args.dump) / f"{seed}.json", "w") as f:
                json.dump({"t_open": rec.t_open, "t_close": rec.t_close,
                           "failure_events": rec.failure_events,
                           "steps": rec.steps,
                           "requests": [{k: v for k, v in r.items()
                                         if k not in ("prompt", "output")}
                                        for r in rec.requests]}, f)
        row["correct"] = res["correct"]
        row["metrics"] = {k: v["value"] for k, v in res["metrics"].items()}
        rows.append(row)
        print(json.dumps(row), flush=True)
    prog = [r["program"]["widest"] for r in rows if r.get("program")]
    ctrl = [r["control"]["widest"] for r in rows if r.get("control")]
    print(json.dumps({"lower_widest": max(prog, default=None),
                      "upper_widest": min(ctrl, default=None),
                      "seeds": len(prog), "control_seeds": len(ctrl),
                      "forbidden_modules": harness.forbidden_modules()}))


if __name__ == "__main__":
    main()
