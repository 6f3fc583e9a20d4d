"""Training launcher.

  PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-130m --steps 100
  PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-130m \
      --device cpu --steps 20
  # one train_4k step sized and costed on the 16x16 / 2x16x16 mesh:
  PYTHONPATH=src python -m repro_torch.launch.train --arch deepseek-67b \
      --dry-run [--multi-pod] [--device cpu]

A config over 3e8 params trains its reduced variant (the reference's rule).
On the card the Mamba-2 scan runs through the ``ssd_scan`` kernel, its
gradient through ``models.ssm.SSDScan``. ``--dry-run`` runs
``launch/dryrun.py``'s record of ``train_4k`` instead of training, on fake
tensors of ``--device``, and exits 0 when it is ``ok`` or ``skipped``.
"""
import argparse
import sys


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--dry-run", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    if args.dry_run:
        from repro_torch.launch.dryrun import dry_run_one
        rec = dry_run_one(args.arch, "train_4k", multi_pod=args.multi_pod,
                          device=args.device)
        sys.exit(0 if rec["status"] in ("ok", "skipped") else 1)

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
