"""90th percentile of the gap between two consecutive tokens of one
request, in s, over every such pair with both stamps in the window (the
port's per-token stamps). A request resumed on the peer keeps its id, so
its pause is one of its gaps; chunked prefill's stalls between a decoding
request's tokens show here, where a per-request mean hides them."""
from collections import defaultdict

from servebench import program, stats


def compute(record):
    by_rid = defaultdict(list)
    for rid, t in program.tokens(record):
        by_rid[rid].append(t)
    gaps = []
    for stamps in by_rid.values():
        stamps.sort()
        gaps += [(b - a) / 1e9 for a, b in zip(stamps, stamps[1:])]
    return stats.percentile(gaps, 90)
