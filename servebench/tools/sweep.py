"""The knee of an open-loop traffic, in one process: the cell's traffic with
its kill taken out, at each given rate, one window each. The knee is the
highest rate at which the admission wait does not grow through the window:
the median wait of requests due in the window's last third is at most twice
that of its first third plus 0.25 s. Prints one JSON line per rate.

    python servebench/tools/sweep.py --workload <cell> --seconds 40 --rates 1.5,2,2.5,3
"""
import argparse
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for path in (ROOT / "src", ROOT):
    sys.path.insert(0, str(path))
os.environ.setdefault("USE_FLAX", "0")

from servebench import bench, harness, stats  # noqa: E402


def growth(record):
    due = sorted(stats.due_in_window(record), key=lambda r: r["due"])
    third = max(1, len(due) // 3)

    def wait(rs):
        return stats.median([r["admit"] - r["due"] if r["admit"] >= 0
                             else record.t_stop - r["due"] for r in rs])
    first, last = wait(due[:third]), wait(due[-third:])
    return first, last, last <= 2 * first + 0.25


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--trace", type=int, default=0)
    args = ap.parse_args()
    cell = bench.resolve(args.workload)
    cell.traffic = dict(cell.traffic, kill=None)
    keep = {}

    def no_check(config, model, params, record, seed):
        keep["record"] = record
        return {}

    for rate in (float(r) for r in args.rates.split(",")):
        cell.traffic["rate_rps"] = rate
        res = harness.run_cell(cell, args.seed, args.seconds,
                               bool(args.trace),
                               t_start=time.time(), check_fn=no_check)
        rec = keep["record"]
        first, last, steady = growth(rec)
        due = sorted(stats.due_in_window(rec), key=lambda r: r["due"])
        third = max(1, len(due) // 3)
        ttft = [stats.median(stats.ttft(r) for r in part)
                for part in (due[:third], due[-third:])]
        offered = sum(r["max_new"] for r in due) / args.seconds
        print(json.dumps({"rate_rps": rate, "offered_out_tok_s": offered,
                          "wait_first_third_s": first,
                          "wait_last_third_s": last, "steady": steady,
                          "ttft_first_third_s": ttft[0],
                          "ttft_last_third_s": ttft[1],
                          "steps": len(rec.steps),
                          "step_s_median": stats.median(s[1] for s in rec.steps),
                          "active_median": stats.median(s[0] for s in rec.steps),
                          "attempted": res["attempted"],
                          "failed": res["failed"],
                          "metrics": {k: v["value"]
                                      for k, v in res["metrics"].items()},
                          "device": res["device"],
                          "breakdown": res.get("breakdown")}),
              flush=True)


if __name__ == "__main__":
    main()
