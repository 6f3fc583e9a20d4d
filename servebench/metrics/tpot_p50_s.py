"""Median over completed requests of (finish - first token) / (generated -
1): seconds per output token after the first, a migrated request's pause
included. The median is the highest percentile with ten requests beyond it
at the few tens of completions a window holds."""
from servebench import stats


def compute(record):
    values = [stats.tpot(r) for r in stats.completed(record)]
    return stats.percentile([v for v in values if v is not None], 50)
