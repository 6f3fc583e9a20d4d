"""Failure injection + heartbeat detection (paper Sec 4.2 scenarios)."""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Tuple

from repro_torch.core.cluster import LoadBalancerGroup, NodeState


@dataclasses.dataclass
class FailureEvent:
    at: float
    node_id: int
    detected_at: float = -1.0
    recovered_at: float = -1.0       # service resumed (KevlarFlow: re-formed)
    replaced_at: float = -1.0        # background replacement online

    @property
    def mttr(self) -> float:
        """Paper Fig 8 metric: failure -> requests flowing again."""
        return self.recovered_at - self.at if self.recovered_at >= 0 else -1.0


@dataclasses.dataclass
class DetectorConfig:
    heartbeat_interval: float = 2.5
    missed_to_declare: int = 1       # declare failed after N missed beats
                                     # (gRPC channel breaks fail fast)


class FailureInjector:
    """Schedules node failures at absolute sim times."""

    def __init__(self, group: LoadBalancerGroup):
        self.group = group
        self._schedule: List[Tuple[float, int]] = []
        self.events: List[FailureEvent] = []

    def inject_at(self, t: float, node_id: int):
        self._schedule.append((t, node_id))
        self._schedule.sort()

    def tick(self, now: float) -> List[FailureEvent]:
        fired = []
        while self._schedule and self._schedule[0][0] <= now:
            t, node_id = self._schedule.pop(0)
            node = self.group.node_by_id[node_id]
            if node.state == NodeState.HEALTHY:
                node.fail()
                ev = FailureEvent(at=t, node_id=node_id)
                self.events.append(ev)
                fired.append(ev)
        return fired


class HeartbeatMonitor:
    """Detects failures via missed heartbeats (the gRPC health-check
    analogue). Detection latency = interval * missed_to_declare on average,
    deterministic here for reproducible MTTR numbers."""

    def __init__(self, group: LoadBalancerGroup, cfg: DetectorConfig,
                 on_detect: Callable):
        self.group = group
        self.cfg = cfg
        self.on_detect = on_detect
        self._last_beat: Dict[int, float] = {}
        self._reported: set = set()

    def tick(self, now: float):
        for node in self.group.nodes:
            if node.state == NodeState.HEALTHY:
                # healthy nodes beat on schedule
                self._last_beat[node.node_id] = now
            elif node.state == NodeState.FAILED and \
                    node.node_id not in self._reported:
                last = self._last_beat.get(node.node_id, now)
                deadline = last + self.cfg.heartbeat_interval * self.cfg.missed_to_declare
                if now >= deadline:
                    self._reported.add(node.node_id)
                    self.on_detect(node.node_id, now)

    def reset(self, node_id: int):
        self._reported.discard(node_id)
