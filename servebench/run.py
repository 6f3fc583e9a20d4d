"""Run one cell of the port's benchmark once and print its result line.

    python servebench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1`` also
``breakdown``, and last ``checks``: each number the check compared with its
limit, which also close standard error). With ``--trace 0`` the metrics are
the cell's end-to-end metrics, with ``--trace 1`` its per-layer metrics.
Without a CUDA card, or with fewer cards than the cell asks for, it prints no
result and exits with 2; if JAX or the JAX package was loaded, with 3.
"""
import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# the compile caches stay inside the checkout, at fixed paths
os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                      str(ROOT / "build" / "torch_extensions"))
os.environ.setdefault("USE_FLAX", "0")
for path in (ROOT / "src", ROOT):
    if str(path) not in sys.path:
        sys.path.insert(0, str(path))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from servebench import bench, harness
    cell = bench.resolve(args.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"servebench: cell {cell.name} needs {cell.chips} CUDA "
              f"card(s); found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = harness.run_cell(cell, args.seed, args.seconds,
                              bool(args.trace), t_start=T_START)
    found = harness.forbidden_modules()
    if found:
        print(f"servebench: loaded {found}: the benchmark runs without JAX "
              "and the JAX package", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        bound = {k: v for k, v in c.items() if k != "value"}
        print(f"check {name}: {c['value']} {bound}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
