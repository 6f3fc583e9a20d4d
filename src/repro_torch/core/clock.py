"""Deterministic clocks. The cluster control plane is written against this
interface so the *same* scheduler/router/replication/recovery code runs under
a discrete simulation clock (cluster-scale benchmarks) and wall time (real
compute on CPU with reduced models)."""
from __future__ import annotations

import time


class SimClock:
    def __init__(self, t0: float = 0.0):
        self._t = t0

    def now(self) -> float:
        return self._t

    def advance(self, dt: float):
        self._t += dt


class WallClock:
    def __init__(self):
        self._t0 = time.monotonic()

    def now(self) -> float:
        return time.monotonic() - self._t0

    def advance(self, dt: float):  # real time advances itself
        pass
