"""Recovery orchestrator: the paper's two fault policies side by side.

KEVLARFLOW (Sec 4.3): detect -> locate donor holding the same stage weights
(preferring the failed node's replication target, Fig 2b) -> re-form the
communicator via decoupled init -> resume; in-flight requests continue from
replicated KV on the donor. A replacement node is provisioned in the
background and swapped in when ready (no hot spares).

STANDARD: the whole pipeline goes offline, in-flight requests are restarted
on surviving instances, and the instance returns only after a full
re-initialization (~10 min: provision + store + communicator + weight load).
"""
from __future__ import annotations

import dataclasses
from typing import List

from repro_torch.core.cluster import (InstanceState, LoadBalancerGroup,
                                      NodeState, StageSignature, VirtualNode)
from repro_torch.core.communicator import CommunicatorManager
from repro_torch.core.failure import FailureEvent
from repro_torch.core.replication import ReplicationManager
from repro_torch.core.router import LoadBalancer
from repro_torch.serving.request import RequestState

MODE_KEVLARFLOW = "kevlarflow"
MODE_STANDARD = "standard"


@dataclasses.dataclass
class PendingReform:
    instance_id: int
    stage: int
    donor_id: int
    done_at: float
    event: FailureEvent


@dataclasses.dataclass
class PendingReplacement:
    instance_id: int
    stage: int
    failed_node_id: int
    done_at: float
    event: FailureEvent


class RecoveryOrchestrator:
    def __init__(self, group: LoadBalancerGroup, comms: CommunicatorManager,
                 router: LoadBalancer, replication: ReplicationManager,
                 mode: str = MODE_KEVLARFLOW, arch: str = "llama3-8b",
                 migration_delay: float = 1.5):
        self.group = group
        self.comms = comms
        self.router = router
        self.replication = replication
        self.mode = mode
        self.arch = arch
        self.migration_delay = migration_delay
        self._reforms: List[PendingReform] = []
        self._replacements: List[PendingReplacement] = []
        self._offline: List = []     # (instance_id, back_at, event)
        self.events: List[FailureEvent] = []   # wired to the injector's list
        self._next_node_id = max(n.node_id for n in group.nodes) + 1
        self.stats = {"reforms": 0, "restarts": 0, "seamless_resumes": 0,
                      "partial_resumes": 0}

    # ------------------------------------------------------------------
    # detection entry point
    # ------------------------------------------------------------------
    def on_node_failure_detected(self, node_id: int, now: float):
        node = self.group.node_by_id[node_id]
        event = next((e for e in reversed(self.events) if
                      e.node_id == node_id and e.detected_at < 0), None)
        if event:
            event.detected_at = now
        # every instance whose current pipeline used this node is affected
        affected = [inst for inst in self.group.instances
                    if any(n is node for n in inst.stage_nodes)]
        for inst in affected:
            if self.mode == MODE_KEVLARFLOW:
                self._kevlarflow_recover(inst, node, now, event)
            else:
                self._standard_recover(inst, node, now, event)

    # ------------------------------------------------------------------
    # KevlarFlow path
    # ------------------------------------------------------------------
    def _kevlarflow_recover(self, inst, node: VirtualNode, now: float, event):
        stage = next(s for s, n in enumerate(inst.stage_nodes) if n is node)
        # prefer the failed node's ring replication target: replicated KV
        # already lives there, so in-flight requests resume in place
        preferred = self.replication.target_for_failed(node)
        donor = None
        if preferred is not None and \
                preferred.signature.compatible(node.signature) and \
                preferred.state == NodeState.HEALTHY:
            donor = preferred
        if donor is None:
            donor = self.group.find_donor(node.signature,
                                          exclude={node.node_id})
        if donor is None:
            # no compatible healthy node in the group: degrade to standard
            self._standard_recover(inst, node, now, event)
            return
        inst.state = InstanceState.RECOVERING
        # requests with no user-visible output yet (queued or mid-prefill)
        # don't wait for the re-form: the LB reroutes them to live instances
        # immediately — restarting a prefill is cheap, and this is what keeps
        # KevlarFlow's p99 TTFT flat through the failure (paper Fig 6)
        pending = list(inst.waiting)
        inst.waiting.clear()
        for req in [r for r in inst.running
                    if r.state == RequestState.PREFILL]:
            inst.running.remove(req)
            req.state = RequestState.QUEUED
            req.prefill_progress = 0.0
            pending.append(req)
        if pending:
            self.router.requeue(pending)
        comm, cost = self.comms.form(
            self.arch,
            [donor if s == stage else n for s, n in enumerate(inst.stage_nodes)],
            now)
        done_at = now + cost
        inst.recovering_until = done_at
        self._reforms.append(PendingReform(inst.instance_id, stage,
                                           donor.node_id, done_at, event))
        # background replacement starts immediately (full init, overlapped
        # with degraded serving — the paper's no-hot-spare cost argument)
        self._replacements.append(PendingReplacement(
            inst.instance_id, stage, node.node_id,
            now + self.comms.legacy_init_cost(), event))

    def _complete_reform(self, pr: PendingReform, now: float):
        inst = self.group.instances[pr.instance_id]
        donor = self.group.node_by_id[pr.donor_id]
        if donor.state != NodeState.HEALTHY:       # donor died meanwhile
            inst.state = InstanceState.OFFLINE
            return
        failed = inst.stage_nodes[pr.stage]
        inst.stage_nodes[pr.stage] = donor
        if (inst.instance_id, pr.stage) not in donor.roles:
            donor.roles.append((inst.instance_id, pr.stage))
        inst.state = InstanceState.DEGRADED
        inst.recovering_until = -1.0
        self.stats["reforms"] += 1
        if pr.event and pr.event.recovered_at < 0:
            pr.event.recovered_at = now
        # resume in-flight requests from replicated state
        for req in list(inst.running):
            if req.state not in (RequestState.DECODE, RequestState.PREFILL,
                                 RequestState.MIGRATING):
                continue
            replicated = req.replicated_through
            total = req.total_len
            req.n_migrations += 1
            if replicated >= total:
                self.stats["seamless_resumes"] += 1
                req.migrate_pause = self.migration_delay
            else:
                # unreplicated KV suffix is recomputed (fast prefill-rate
                # pass over already-known tokens); output already streamed
                # is NOT lost
                missing = total - replicated
                self.stats["partial_resumes"] += 1
                req.migrate_pause = self.migration_delay + missing * 0.002
            req.state = RequestState.MIGRATING
            failed_id = failed.node_id if failed is not None else -1
            if failed_id >= 0:
                tbl = donor.kv_pool.replica_table(failed_id, req.rid)
                if tbl and req.rid not in donor.kv_pool.live_requests():
                    self.replication.promote(failed_id, donor, req.rid)

    def _complete_replacement(self, pp: PendingReplacement, now: float):
        inst = self.group.instances[pp.instance_id]
        # fresh node takes over the home slot; donor sheds the extra role
        old = next((n for n in inst.home_nodes
                    if n.node_id == pp.failed_node_id), None)
        sig = StageSignature(self.arch, pp.stage, inst.n_stages)
        new_node = self._new_node(inst, pp.stage, sig)
        new_node.last_heartbeat = now
        self.group.nodes.append(new_node)
        self.group.node_by_id[new_node.node_id] = new_node
        current = inst.stage_nodes[pp.stage]
        if current is not None and current.state == NodeState.HEALTHY and \
                (inst.instance_id, pp.stage) in current.roles and \
                current.home_instance != inst.instance_id:
            current.roles.remove((inst.instance_id, pp.stage))
        inst.stage_nodes[pp.stage] = new_node
        inst.home_nodes[pp.stage] = new_node
        if all(n.state == NodeState.HEALTHY for n in inst.stage_nodes) and \
                not inst.patched_stages():
            inst.state = InstanceState.HEALTHY
        if pp.event and pp.event.replaced_at < 0:
            pp.event.replaced_at = now

    def _new_node(self, inst, stage: int, sig) -> VirtualNode:
        """A freshly initialized node for ``inst``'s ``stage``, its pool
        built like the one it replaces: real buffers of the same geometry,
        dtype, device and quantization, or metadata only."""
        template = inst.home_nodes[stage].kv_pool
        node = VirtualNode(self._next_node_id, inst.instance_id, sig,
                           template.empty_like())
        self._next_node_id += 1
        self.replication.watch(node)
        return node

    # ------------------------------------------------------------------
    # standard fault behaviour path
    # ------------------------------------------------------------------
    def _standard_recover(self, inst, node: VirtualNode, now: float, event):
        inst.state = InstanceState.OFFLINE
        back_at = now + self.comms.legacy_init_cost()
        inst.offline_until = back_at
        self._offline.append((inst.instance_id, back_at, event,
                              node.node_id, _stage_of(inst, node)))
        # paper: "Any in-progress requests will be immediately retried"
        reqs = self.router.drain_instance(inst)
        for r in reqs:
            if r.state in (RequestState.PREFILL, RequestState.DECODE,
                           RequestState.MIGRATING):
                r.restart()
                self.stats["restarts"] += 1
            r.instance_id = None
        healthy = [i for i in self.group.instances if i.is_serving()]
        if healthy:
            self.router.requeue(reqs)
        else:
            # total outage: requests wait at the LB for any instance to return
            self.group.instances[0].waiting.extend(reqs)

    def _complete_offline_return(self, instance_id: int, now: float, event,
                                 failed_node_id: int, stage: int):
        inst = self.group.instances[instance_id]
        # replace failed node with a freshly initialized one
        sig = StageSignature(self.arch, stage, inst.n_stages)
        new_node = self._new_node(inst, stage, sig)
        self.group.nodes.append(new_node)
        self.group.node_by_id[new_node.node_id] = new_node
        inst.stage_nodes[stage] = new_node
        inst.home_nodes[stage] = new_node
        inst.state = InstanceState.HEALTHY
        inst.offline_until = -1.0
        if event and event.recovered_at < 0:
            event.recovered_at = now
        if event and event.replaced_at < 0:
            event.replaced_at = now

    # ------------------------------------------------------------------
    def tick(self, now: float):
        for pr in [p for p in self._reforms if p.done_at <= now]:
            self._reforms.remove(pr)
            self._complete_reform(pr, now)
        for pp in [p for p in self._replacements if p.done_at <= now]:
            self._replacements.remove(pp)
            self._complete_replacement(pp, now)
        for item in [o for o in self._offline if o[1] <= now]:
            self._offline.remove(item)
            self._complete_offline_return(item[0], now, item[2], item[3], item[4])


def _stage_of(inst, node) -> int:
    return next(s for s, n in enumerate(inst.stage_nodes) if n is node)
