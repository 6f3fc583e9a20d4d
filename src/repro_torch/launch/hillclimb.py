"""Hillclimb driver: the reference's three (arch x shape) pairs, each
variant one ``dry_run_one`` with a different knob (the params' profile, the
sequence-sharding hint, an int8 KV cache, a decode capacity factor), each
record set beside the roofline of an H100 SXM mesh.

  PYTHONPATH=src python -m repro_torch.launch.hillclimb --device cpu

Roofline constants, per card:
  * PEAK: 989e12 FLOP/s, dense bf16 on the tensor cores (NVIDIA H100 SXM
    data sheet);
  * HBM: 3.35e12 B/s (same sheet);
  * LINK: one NDR InfiniBand port per card, 400 Gb/s (a DGX H100 node has
    eight ConnectX-7 400 Gb/s ports, one per GPU). The 16-wide model axis
    spans two 8-card NVLink nodes, so a collective over it runs at the pace
    of this inter-node link; within one node NVLink 4 gives 450 GB/s a
    direction, which no mesh axis here stays inside.
"""
from __future__ import annotations

import argparse

from repro_torch.launch.dryrun import dry_run_one, write_json

PEAK, HBM, LINK = 989e12, 3.35e12, 400e9 / 8


def terms(r):
    """Seconds of one step if bound by compute, by HBM, by the link."""
    return (r["flops"] / PEAK, r["hlo_bytes"] / HBM, r["coll_total"] / LINK)


def report(tag, r):
    if r["status"] != "ok":
        print(f"{tag:44s} {r['status'].upper()} {r.get('error', '')[:80]}",
              flush=True)
        return
    tc, tm, tx = terms(r)
    dom = max((tc, "compute"), (tm, "memory"), (tx, "collective"))[1]
    print(f"{tag:44s} comp={tc * 1e3:9.2f}ms mem={tm * 1e3:9.2f}ms "
          f"coll={tx * 1e3:9.2f}ms  <-{dom}", flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="the fake tensors' device: cuda (the default) or "
                         "cpu")
    ap.add_argument("--out", default="artifacts/torch_hillclimb.json")
    args = ap.parse_args(argv)
    dev = args.device
    results = {}

    def run(key, tag, arch, shape, **kw):
        r = dry_run_one(arch, shape, verbose=False, device=dev, **kw)
        results[key] = r
        report(tag, r)

    print("== PAIR 1: deepseek-67b x decode_32k (paper-representative) ==")
    run("ds_base", "baseline (2D FSDPxTP weights)", "deepseek-67b",
        "decode_32k")
    run("ds_model_only", "iter1: serve_model_only weights", "deepseek-67b",
        "decode_32k", profile="serve_model_only")
    run("ds_seq_hint", "iter2: + seq-sharded attention hint", "deepseek-67b",
        "decode_32k", profile="serve_model_only", seq_hint=True)
    run("ds_int8", "iter3: + int8 KV cache", "deepseek-67b", "decode_32k",
        profile="serve_model_only", seq_hint=True, kv_dtype="int8")

    print("\n== PAIR 2: dbrx-132b x decode_32k ==")
    run("dbrx_base", "baseline", "dbrx-132b", "decode_32k")
    run("dbrx_ep", "iter1: expert-parallel + seq hint", "dbrx-132b",
        "decode_32k", profile="expert_parallel", seq_hint=True)
    from repro_torch.models import moe
    moe.DECODE_CAPACITY_FACTOR = 2.0
    try:
        run("dbrx_cf2", "iter2: + decode capacity factor 2.0", "dbrx-132b",
            "decode_32k", profile="expert_parallel", seq_hint=True)
    finally:
        moe.DECODE_CAPACITY_FACTOR = None

    print("\n== PAIR 3: mamba2-130m x train_4k (tiny model over-sharded) ==")
    run("mamba_base", "baseline", "mamba2-130m", "train_4k")
    run("mamba_dp", "iter1: pure data-parallel (256-way)", "mamba2-130m",
        "train_4k", profile="pure_dp")

    write_json(args.out, results)
    print(f"\nwritten to {args.out}")


if __name__ == "__main__":
    main()
