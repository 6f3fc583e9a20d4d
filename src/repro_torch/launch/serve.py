"""Serving launcher: the real-serving path through the port's
``RealEngine`` — 12 requests of 16 prompt tokens and 32 new tokens on 2
instances, as the reference's launcher does.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-0.5b
  PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-9b --device cpu
  # one serve step sized and costed on the 16x16 / 2x16x16 mesh:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-9b \
      --shape decode_32k --dry-run [--multi-pod] [--device cpu]

A config over 3e8 params serves its reduced variant (the reference's
rule). On the card decode attention runs through the ``paged_attention``
kernel; the launcher prints its launch count. ``--dry-run`` runs
``launch/dryrun.py``'s record of ``--shape`` (prefill or decode) instead of
serving, on fake tensors of ``--device``, and exits 0 when it is ``ok`` or
``skipped``.
"""
import argparse
import sys


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default="decode_32k")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--dry-run", action="store_true",
                    help="size and cost one step on the production mesh")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    if args.dry_run:
        from repro_torch.launch.dryrun import dry_run_one
        rec = dry_run_one(args.arch, args.shape, multi_pod=args.multi_pod,
                          device=args.device)
        sys.exit(0 if rec["status"] in ("ok", "skipped") else 1)

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.kernels import paged_attention
    from repro_torch.serving.engine import EngineConfig, RealEngine
    from repro_torch.serving.request import Request

    cfg = get_config(args.arch)
    if cfg.n_params() > 3e8:
        print(f"{args.arch} is {cfg.n_params() / 1e9:.1f}B params; serving "
              "the reduced variant")
        cfg = cfg.reduced()
    if cfg.arch_type not in ("dense", "vlm"):
        print(f"RealEngine serves the dense family here; {cfg.arch_type} "
              "archs serve via api.decode_step (see the model API)")
        sys.exit(0)
    eng = RealEngine(cfg, EngineConfig(max_slots=8, max_seq=128),
                     n_instances=2, device=args.device)
    rng = np.random.default_rng(0)
    paged_attention.launches = 0
    for i in range(12):
        eng.submit(Request(rid=i, prompt_len=16, max_new_tokens=32,
                           arrival_time=0.0,
                           prompt_tokens=rng.integers(
                               1, cfg.vocab_size, 16).tolist()))
    done = eng.run(3000)
    print(f"served {len(done)} requests; sample output tokens: "
          f"{done[0].output_tokens[:8]}")
    print(f"paged_attention launches: {paged_attention.launches}")
    if len(done) != 12:
        sys.exit(1)


if __name__ == "__main__":
    main()
