"""Training launcher.

  PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-130m --steps 100
  PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-130m \
      --device cpu --steps 20

A config over 3e8 params trains its reduced variant (the reference's rule).
On the card the Mamba-2 scan runs through the ``ssd_scan`` kernel, its
gradient through ``models.ssm.SSDScan``. ``--dry-run`` (compile-only
against a TPU mesh) is the reference's TPU lowering tool, which the port
does not have, and ``--multi-pod`` picks that tool's mesh: either exits
non-zero and says so.
"""
import argparse
import sys

def refuse_tpu_flag(flag: str):
    """Exits 2: ``flag`` belongs to the reference's TPU lowering."""
    print(f"{flag} belongs to the reference's lowering of the program for "
          "a TPU mesh (launch/dryrun.py); the port has no TPU lowering "
          "tools: ROADMAP.md Queue 1 item 13 (the TPU lowering tools)",
          file=sys.stderr)
    sys.exit(2)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--multi-pod", action="store_true",
                    help="the TPU lowering's 2-pod mesh (not in the port)")
    ap.add_argument("--dry-run", action="store_true",
                    help="lower + compile only (TPU mesh; not in the port)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    for flag in ("dry_run", "multi_pod"):
        if getattr(args, flag):
            refuse_tpu_flag("--" + flag.replace("_", "-"))

    from repro_torch.configs import get_config
    from repro_torch.training.data import DataConfig
    from repro_torch.training.optimizer import OptimizerConfig
    from repro_torch.training.train_loop import TrainerConfig, train

    cfg = get_config(args.arch)
    if cfg.n_params() > 3e8:
        print(f"{args.arch} too large for this host; training reduced variant")
        cfg = cfg.reduced()
    out = train(cfg, DataConfig(batch_size=4, seq_len=256),
                OptimizerConfig(warmup_steps=20, total_steps=args.steps),
                TrainerConfig(steps=args.steps, log_every=10),
                on_metrics=lambda m: print(m), device=args.device)
    print(f"final loss: {out['history'][-1]['loss']:.4f}")


if __name__ == "__main__":
    main()
