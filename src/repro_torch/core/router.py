"""Load balancer + dynamic traffic rerouting (paper Sec 3.2 mechanism #2).

Normal operation: requests route to the least-loaded instance (queue depth
+ running requests — the same policy ``RealEngine`` applies on the real
path; ``policy="round_robin"`` keeps the paper-evaluation-setup spread).
Under partial failure, *instance-level* rerouting is implicit — a DEGRADED
instance keeps serving through its patched pipeline — and *request-level*
rerouting moves work off OFFLINE instances (standard fault behaviour) or
pauses it briefly during communicator re-form (KevlarFlow)."""
from __future__ import annotations

from typing import List

from repro_torch.core.cluster import (InstanceState, LoadBalancerGroup,
                                      PipelineInstance)
from repro_torch.serving.controlplane import LeastLoadedRouting
from repro_torch.serving.request import Request


def _sim_load(inst) -> int:
    """The sim's load metric: queue depth + running requests."""
    return len(inst.waiting) + len(inst.running)


class LoadBalancer:
    def __init__(self, group: LoadBalancerGroup,
                 policy: str = "least_loaded"):
        assert policy in ("least_loaded", "round_robin"), policy
        self.group = group
        self.policy = policy
        # the SAME least-loaded implementation RealEngine routes with —
        # shared via the control plane so sim and real path cannot drift
        self._least_loaded = LeastLoadedRouting()
        self._rr = 0

    def submit(self, req: Request):
        """Route a new request to a serving instance. New traffic avoids
        RECOVERING instances — they resume their in-flight work after the
        re-form, but fresh requests go to live pipelines."""
        targets = [i for i in self.group.instances
                   if i.state in (InstanceState.HEALTHY, InstanceState.DEGRADED)]
        if not targets:
            targets = [i for i in self.group.instances
                       if i.state == InstanceState.RECOVERING] or self.group.instances
        if self.policy == "least_loaded":
            inst = self._least_loaded.pick(targets, _sim_load)
        else:
            inst = targets[self._rr % len(targets)]
            self._rr += 1
        inst.waiting.append(req)
        req.instance_id = inst.instance_id

    def drain_instance(self, inst: PipelineInstance) -> List[Request]:
        """Pull every request off an instance (offline path). Running
        requests are restarted by the caller per the fault policy."""
        out = list(inst.running) + list(inst.waiting)
        inst.running.clear()
        inst.waiting.clear()
        return out

    def requeue(self, reqs: List[Request]):
        for r in reqs:
            self.submit(r)

    def queue_depth(self) -> int:
        return sum(len(i.waiting) for i in self.group.instances)
