"""ServingSystem: the full KevlarFlow control plane wired together.

One object owns the LB group, router, failure detection, recovery
orchestrator, replication manager, and the per-instance continuous-batching
execution. Execution runs on PerfModel, a calibrated cost model driven by
the sim clock; this is what the paper-figure experiments run ("the
simulation is in the clock, not in the logic").

The calibration constants are the reference's, fitted to the paper's
published numbers (they are not measurements of any device). They reproduce
the paper's measured baseline: TPOT 163 ms avg (Sec 4.1), TTFT ~0.2 s at low
load, saturation knee at ~1.5 RPS per 4-stage Llama-3.1-8B pipeline (Figs
3-4 knees: 8-node cluster at RPS 3-4, 16-node at 6-7).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from repro_torch.core.clock import SimClock
from repro_torch.core.cluster import (InstanceState, LoadBalancerGroup,
                                      build_group)
from repro_torch.core.communicator import CommunicatorManager, InitCosts
from repro_torch.core.failure import (DetectorConfig, FailureInjector,
                                      HeartbeatMonitor)
from repro_torch.core.recovery import (MODE_KEVLARFLOW, MODE_STANDARD,
                                       RecoveryOrchestrator)
from repro_torch.core.replication import ReplicationConfig, ReplicationManager
from repro_torch.core.router import LoadBalancer
from repro_torch.serving.request import Request, RequestState, summarize


@dataclasses.dataclass
class PerfModel:
    """Calibrated serving-time constants (paper Sec 4.1), as the reference
    sets them: sim-clock seconds, not measured on any device."""
    tpot: float = 0.163                 # s/token, TensorRT-LLM default scheduler
    prefill_base: float = 0.10          # s
    prefill_per_token: float = 0.0005   # s/prompt-token (~0.2s at 200 tokens)
    max_decode_slots: int = 96          # concurrent decodes per instance
    recompute_per_token: float = 0.002  # KV recompute rate during migration

    def prefill_time(self, prompt_len: int) -> float:
        return self.prefill_base + self.prefill_per_token * prompt_len


class ServingSystem:
    def __init__(self, n_instances: int = 2, n_stages: int = 4,
                 mode: str = MODE_KEVLARFLOW, arch: str = "llama3-8b",
                 perf: Optional[PerfModel] = None,
                 repl_cfg: Optional[ReplicationConfig] = None,
                 costs: Optional[InitCosts] = None,
                 detector: Optional[DetectorConfig] = None,
                 kv_blocks_per_node: int = 8192,
                 clock: Optional[SimClock] = None,
                 group: Optional[LoadBalancerGroup] = None):
        self.clock = clock or SimClock()
        self.perf = perf or PerfModel()
        self.mode = mode
        self.group = group or build_group(n_instances, n_stages, arch,
                                          kv_blocks_per_node)
        self.router = LoadBalancer(self.group)
        self.comms = CommunicatorManager(costs or InitCosts())
        repl_cfg = repl_cfg or ReplicationConfig()
        if mode == MODE_STANDARD:
            repl_cfg = dataclasses.replace(repl_cfg, enabled=False)
        self.replication = ReplicationManager(self.group, repl_cfg)
        self.recovery = RecoveryOrchestrator(
            self.group, self.comms, self.router, self.replication,
            mode=mode, arch=arch)
        self.injector = FailureInjector(self.group)
        self.recovery.events = self.injector.events
        self.monitor = HeartbeatMonitor(
            self.group, detector or DetectorConfig(),
            on_detect=self.recovery.on_node_failure_detected)
        self.requests: Dict[int, Request] = {}
        self._progress: Dict[int, float] = {}    # rid -> fractional tokens
        # form the initial communicators (decoupled init happy path)
        for inst in self.group.instances:
            self.comms.form(arch, inst.stage_nodes, self.clock.now())

    # ------------------------------------------------------------------
    def submit(self, req: Request):
        self.requests[req.rid] = req
        self.router.submit(req)

    def inject_failure(self, at: float, node_id: int):
        self.injector.inject_at(at, node_id)

    # ------------------------------------------------------------------
    def step(self, dt: float):
        now = self.clock.now()
        self.injector.tick(now)
        self.monitor.tick(now)
        self.recovery.tick(now)
        for inst in self.group.instances:
            self._step_instance(inst, dt, now)
        self.replication.tick(dt, self.requests)
        self.clock.advance(dt)

    def run_until(self, t_end: float, dt: float = 0.05,
                  arrivals: Optional[List[Request]] = None):
        """Advance the system, submitting pre-scheduled arrivals on time."""
        arrivals = sorted(arrivals or [], key=lambda r: r.arrival_time)
        idx = 0
        while self.clock.now() < t_end:
            now = self.clock.now()
            while idx < len(arrivals) and arrivals[idx].arrival_time <= now:
                self.submit(arrivals[idx])
                idx += 1
            self.step(dt)

    # ------------------------------------------------------------------
    # per-instance continuous batching
    # ------------------------------------------------------------------
    def _step_instance(self, inst, dt: float, now: float):
        if inst.state == InstanceState.OFFLINE:
            return
        if inst.state == InstanceState.RECOVERING:
            return        # requests pause during communicator re-form
        mult = inst.throughput_multiplier()
        if mult <= 0:
            return
        overhead = self.replication.overhead_factor()
        rate = mult / (self.perf.tpot * overhead)     # tokens/s per request

        finished = []
        for req in inst.running:
            if req.migrate_pause > 0:                 # KevlarFlow migration
                req.migrate_pause -= dt
                if req.migrate_pause <= 0 and req.state == RequestState.MIGRATING:
                    req.state = RequestState.DECODE
                continue
            if req.state == RequestState.PREFILL:
                req.prefill_progress += dt / self.perf.prefill_time(req.prompt_len) * mult
                if req.prefill_progress >= 1.0:
                    if not self._kv_on_prefill(inst, req):
                        # pool truly full even after replica eviction:
                        # back to the queue (a real engine would preempt)
                        req.state = RequestState.QUEUED
                        req.prefill_progress = 0.0
                        finished.append(req)          # remove from running
                        inst.waiting.insert(0, req)
                        continue
                    req.state = RequestState.DECODE
                    req.generated = 1                 # first token
                    if req.first_token_time < 0:
                        req.first_token_time = now
                    self._progress[req.rid] = 0.0
            elif req.state == RequestState.DECODE:
                p = self._progress.get(req.rid, 0.0) + dt * rate
                whole = int(p)
                if whole:
                    self._emit_tokens(inst, req, whole, now)
                self._progress[req.rid] = p - whole
                if req.generated >= req.max_new_tokens:
                    req.state = RequestState.DONE
                    req.finish_time = now
                    finished.append(req)
        for req in finished:
            inst.running.remove(req)
            self._kv_free(inst, req)
            self._progress.pop(req.rid, None)

        # admission: fill free decode slots from the waiting queue
        while inst.waiting and len(inst.running) < self.perf.max_decode_slots:
            req = inst.waiting.pop(0)
            if not self._kv_admit(inst, req):
                inst.waiting.insert(0, req)
                break
            req.state = RequestState.PREFILL
            req.prefill_progress = 0.0
            req.instance_id = inst.instance_id
            inst.running.append(req)

    def _emit_tokens(self, inst, req, n: int, now: float):
        req.generated = min(req.generated + n, req.max_new_tokens)
        if req.first_token_time < 0:
            req.first_token_time = now
        # account KV growth block-by-block on every stage node
        for node in set(inst.stage_nodes):
            if node is None:
                continue
            for _ in range(n):
                try:
                    node.kv_pool.append_token(req.rid)
                except MemoryError:
                    node.kv_pool.evict_replicas_for_pressure(1)
                    try:
                        node.kv_pool.append_token(req.rid)
                    except MemoryError:
                        break     # pool hard-full: stop KV accounting growth

    # ------------------------------------------------------------------
    # KV accounting across the pipeline's nodes
    # ------------------------------------------------------------------
    def _kv_admit(self, inst, req) -> bool:
        need = req.prompt_len
        for node in inst.stage_nodes:
            if node is None:
                return False
            pool = node.kv_pool
            if not pool.can_allocate(need):
                pool.evict_replicas_for_pressure(pool.blocks_for_tokens(need))
                if not pool.can_allocate(need):
                    return False
        return True

    def _kv_on_prefill(self, inst, req) -> bool:
        done = []
        # stage order, not set order: a node that cannot allocate ends the
        # loop, so which nodes evicted replicas first depends on the order,
        # and a set of nodes iterates in object-hash order
        for node in dict.fromkeys(inst.stage_nodes):
            if node is None:
                continue
            if req.rid not in node.kv_pool.live_requests():
                try:
                    node.kv_pool.allocate(req.rid, req.prompt_len + 1)
                except MemoryError:
                    node.kv_pool.evict_replicas_for_pressure(
                        node.kv_pool.blocks_for_tokens(req.prompt_len + 1))
                    try:
                        node.kv_pool.allocate(req.rid, req.prompt_len + 1)
                    except MemoryError:
                        for d in done:      # roll back partial allocations
                            d.kv_pool.free(req.rid)
                        return False
            done.append(node)
        return True

    def _kv_free(self, inst, req):
        for node in self.group.nodes:
            node.kv_pool.free(req.rid)
            # replicas of a finished request are dropped everywhere
            for peer in list(self.group.node_by_id):
                node.kv_pool.drop_replica(peer, req.rid)

    # ------------------------------------------------------------------
    def metrics(self):
        return summarize(list(self.requests.values()))

    def mttr_events(self):
        return [e for e in self.injector.events if e.mttr >= 0]
