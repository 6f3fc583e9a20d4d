"""The benchmark's own statistics over a run's record.

Times are host-clock seconds (``time.time``, the engine's clock). A request's
due time is when the schedule said to send it, not when it was sent, so a
generator or a service loop that falls behind shows in the latency. A
request that never got its first token counts as infinitely late.
"""
from __future__ import annotations

import math
from typing import Iterable, List, Optional

INF = math.inf


def percentile(values: Iterable[float], q: float) -> Optional[float]:
    """Nearest-rank percentile: the smallest value with at least q% of the
    values at or below it. Infinite values take part like any other, so a
    failed request counted as infinitely late can be the answer. None when
    there are no values."""
    xs = sorted(values)
    if not xs:
        return None
    k = max(1, math.ceil(q / 100.0 * len(xs)))
    return xs[k - 1]


def ttft(req: dict) -> float:
    """Time to first token from the due time; infinite without one."""
    if req["first"] < 0:
        return INF
    return req["first"] - req["due"]


def tpot(req: dict) -> Optional[float]:
    """(finish - first token) / (generated - 1) of a completed request
    (None otherwise). A request that migrated keeps its pause in it."""
    if req["finish"] < 0 or req["first"] < 0 or req["generated"] < 2:
        return None
    return (req["finish"] - req["first"]) / (req["generated"] - 1)


def due_in_window(record) -> List[dict]:
    """Requests whose due time lies inside the window."""
    return [r for r in record.requests
            if record.t_open <= r["due"] < record.t_close]


def completed(record) -> List[dict]:
    return [r for r in record.requests if r["finish"] >= 0]


def tokens_in_window(record) -> int:
    """Output tokens produced inside the window: the sum of ``generated``
    at the close minus at the open."""
    return sum(r["gen_close"] - r["gen_open"] for r in record.requests)


def median(values: Iterable[float]) -> Optional[float]:
    return percentile(values, 50)
