"""Real-compute serving engine: continuous batching over PyTorch forward
passes (the card by default; ``device="cpu"`` for the tests).

``RealInstance`` is one serving instance's worth of compute. KevlarFlow's
mechanisms appear here for real:

  * decoupled init — ``RealEngine`` builds params ONCE and hands the same
    tensors to every instance; a warm spare rejoining after a failure reuses
    them (no re-init, no reload);
  * paged KV — every instance's cache IS a ``PagedKVPool`` (kernel-layout
    buffers, bf16 or int8 with per-token scales under ``kv_quant``); decode
    attends through block tables with the paged-attention kernel (its int8
    counterpart on an int8 pool), prefill is bucketed to power-of-2 lengths
    — in one pass at admission, or chunk by chunk interleaved with decode
    steps under ``prefill_chunk``;
  * KV replication — block-granular deltas: only blocks dirtied by
    ``append_token`` since the last pass are copied to the ring target, so
    a decode step ships at most ONE block per active request;
  * failover — ``fail_instance`` promotes the hosted replica blocks in
    place (``promote_replica``) and the request continues byte-identically
    on the target.

Dynamic traffic rerouting (paper Sec 3.2 mechanism #2) is the LB layer of
``RealEngine``: every instance owns a waiting queue, new arrivals route to
the least-loaded alive instance, queued work an instance cannot place flows
to any peer with headroom, and ``fail_instance`` drains the dead instance's
queue onto the survivors while in-flight requests resume from promoted
replicas. ``EngineConfig.recovery`` picks ``kevlarflow`` (warm-spare
rejoin) or ``standard`` (every victim restarts and the group stalls for
``reload_penalty`` clock units).

This port serves the dense family with colocated roles, monolithic or
chunked prefill, and a bf16 or int8 KV pool. The knobs of later slices —
prefix caching, disaggregation and shard-granularity faults — raise until
then.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.models import paged_decode as PD
from repro_torch.models import transformer
from repro_torch.serving.api_types import FaultSpec
from repro_torch.serving.controlplane import ControlPlane
from repro_torch.serving.kvcache import PagedKVPool
from repro_torch.serving.request import Request, RequestState
from repro_torch.serving.sampling import sample
from repro_torch.serving.transport import (TransportChannel, collect_dirty,
                                           host_table_growth,
                                           reconcile_replica)

SCRATCH_RID = -7  # pool rid reserved for the idle-slot scratch block


@dataclasses.dataclass
class EngineConfig:
    max_slots: int = 8
    max_seq: int = 256
    temperature: float = 0.0
    replicate: bool = True
    replication: str = "delta"   # "delta" (dirty blocks) | "full" (all blocks)
    # int8 KV pool: pages stored as int8 + per-row bf16 scales, decode runs
    # through the int8 kernel, replication ships the quantized bytes
    kv_quant: bool = False
    # chunked prefill: each admitted prompt runs in chunks of this many
    # tokens (rounded up to a power of two >= the page size), ONE chunk per
    # mid-prefill slot per engine step, interleaved with the decode batch.
    # 0 = monolithic prefill inline at admission
    prefill_chunk: int = 0
    prefix_cache: bool = False   # not ported yet: must stay False
    # async double-buffered replication: _replicate STAGES the step's dirty
    # block ids and the copies ship at the top of the NEXT step.
    # flush_replication is the barrier — fail_instance/rejoin_instance flush
    # before touching replicas, so failover stays byte-identical. False =
    # ship in-step and block until the replica is durable.
    repl_async: bool = True
    disaggregate: bool = False   # not ported yet: must stay False
    # replication placement policy (controlplane.PlacementPolicy)
    placement: str = "successor"
    # recovery policy applied by fail_instance (see module docstring)
    recovery: str = "kevlarflow"   # "kevlarflow" | "standard"
    auto_rejoin: bool = False      # schedule rejoin_instance automatically
    rejoin_delay: float = 1.0      # kevlarflow spare re-form (clock units)
    reload_penalty: float = 20.0   # standard full re-init (clock units)
    # tensor-parallel shards per instance: the /health schema reports it;
    # shard-granularity faults are not ported yet
    n_shards: int = 4


def _check_ported(cfg, ecfg: EngineConfig):
    if cfg.arch_type not in PD.PAGED_FAMILIES:
        raise NotImplementedError(
            f"the port serves {PD.PAGED_FAMILIES}, not {cfg.arch_type!r}")
    for name in ("prefix_cache", "disaggregate"):
        if getattr(ecfg, name):
            raise NotImplementedError(f"EngineConfig.{name} is not ported yet")


class FamilyExecutor:
    """The prefill + decode programs for one (cfg, EngineConfig) pair, shared
    by every instance — including a warm spare rejoining after a failure.
    Decode updates the pool buffers (and an int8 pool's scales, None
    otherwise) in place; a prefill chunk updates its carry buffers in
    place."""

    def __init__(self, cfg, ecfg: EngineConfig):
        _check_ported(cfg, ecfg)
        temp = ecfg.temperature

        def decode(p, tok, k_pages, v_pages, ks, vs, bt, pos, base,
                   generator):
            return PD.decode_step_paged(cfg, p, tok, k_pages, v_pages, bt,
                                        pos, generator, base=base,
                                        k_scales=ks, v_scales=vs,
                                        temperature=temp)

        self.decode = decode
        self.prefill = lambda p, toks, n: PD.prefill_bucketed(cfg, p, toks, n)
        self.prefill_chunk = (
            lambda p, toks, start, take, kb, vb:
            PD.prefill_chunk(cfg, p, toks, start, take, kb, vb))
        # chunk size normalized to a power of two >= the page size, so
        # chunks tile the power-of-two prefill bucket exactly
        self.chunk = PD.next_bucket(ecfg.prefill_chunk, lo=cfg.page_size) \
            if ecfg.prefill_chunk > 0 else 0


class RealInstance:
    """One serving instance: the dense family over a paged KV pool."""

    def __init__(self, cfg, params, ecfg: EngineConfig, instance_id: int = 0,
                 executor: Optional[FamilyExecutor] = None,
                 clock: Optional[Callable[[], float]] = None,
                 device="cuda"):
        self.cfg = cfg
        self.family = cfg.arch_type
        self.params = params          # node-resident weights (shared ref!)
        self.ecfg = ecfg
        self.instance_id = instance_id
        self.device = torch.device(device)
        self.alive = True
        self.role = "both"            # colocated serving
        self.n_shards = max(1, ecfg.n_shards)
        B, S = ecfg.max_slots, ecfg.max_seq
        page = cfg.page_size
        self.window = cfg.sliding_window
        self.pages_per_seq = PD.table_pages(cfg, S)
        n_blocks = 2 * B * self.pages_per_seq + 1  # primaries+replicas+scratch
        self.pool = PagedKVPool(
            n_blocks, page, n_layers=len(PD.kv_layer_indices(cfg)),
            n_kv_heads=cfg.n_kv_heads, head_dim=cfg.head_dim, real=True,
            dtype=PD.kv_dtype(cfg), window=self.window, device=self.device,
            quantized=ecfg.kv_quant)
        # idle batch slots write/attend into one scratch block, never freed
        self.scratch = self.pool.allocate(SCRATCH_RID, 1)[0].slot
        self.block_table = np.full((B, self.pages_per_seq), self.scratch,
                                   np.int32)
        self.slot_rid = [-1] * B      # request id per slot
        self.slot_pos = np.zeros(B, np.int32)
        # absolute position of each slot's first resident page (recycling)
        self.slot_base = np.zeros(B, np.int32)
        # (rid, logical_idx) of pages recycled this step: the engine turns
        # these into retire messages for the ring peer hosting the replica
        self.pending_retires: List[tuple] = []
        self.requests: Dict[int, Request] = {}
        # per-instance sampling stream (used only when temperature > 0)
        self._generator = torch.Generator(device=self.device)
        self._generator.manual_seed(instance_id + 1)
        self.clock = clock
        ex = executor or FamilyExecutor(cfg, ecfg)
        self._decode = ex.decode
        self._prefill = ex.prefill
        self._prefill_chunk = ex.prefill_chunk
        self.chunk = ex.chunk
        # slot -> chunked-prefill job (request, pages, carry buffers,
        # progress); empty under monolithic prefill
        self.prefill_jobs: Dict[int, dict] = {}
        self.prefill_total_tokens = 0

    def _stamp(self, now: float) -> float:
        """Timestamp an event: fresh wall-clock reading when a clock is
        wired (admission/prefill take real time), else the caller's tick."""
        return self.clock() if self.clock is not None else now

    def _tensor(self, arr) -> torch.Tensor:
        return torch.as_tensor(arr, device=self.device)

    # -- admission -----------------------------------------------------------
    @property
    def slot_cap(self) -> int:
        return self.ecfg.max_slots

    def capacity_frac(self) -> float:
        """Throughput cap as a fraction of the whole instance (0 dead)."""
        return 1.0 if self.alive else 0.0

    def free_slots(self) -> List[int]:
        return [i for i, r in enumerate(self.slot_rid) if r < 0]

    def _allocate(self, rid: int, n_tokens: int):
        """Allocate primary blocks, evicting hosted replicas under pressure
        (the paper's rule: replicas are the first thing dropped)."""
        need = self.pool.resident_blocks_for(n_tokens)
        if need > self.pool.n_free and not self.pool.window:
            self.pool.evict_replicas_for_pressure(need)
        try:
            refs = self.pool.allocate(rid, n_tokens)
        finally:
            # allocate's windowed fallback may have recycled other requests'
            # out-of-window head pages: their hosted replicas need retiring
            self.pending_retires.extend(
                (r.rid, r.logical_idx)
                for r in self.pool.drain_pending_recycles())
        return refs

    def admit(self, req: Request, now: float = 0.0) -> bool:
        slots = self.free_slots()
        if not slots or not self.alive:
            return False
        slot = slots[0]
        n = req.prompt_len
        try:                           # reserve blocks BEFORE prefill so a
            refs = self._allocate(req.rid, n)   # full pool costs no compute
        except MemoryError:
            return False
        self.prefill_total_tokens += n
        page = self.pool.page_size
        req.admit_time = self._stamp(now)       # prefill starts now
        bucket = PD.next_bucket(n, lo=page)
        toks = np.zeros((1, bucket), np.int32)
        toks[0, :n] = req.prompt_tokens
        req.instance_id = self.instance_id
        self.slot_rid[slot] = req.rid
        self.requests[req.rid] = req
        if self.chunk:
            # chunked admission: pages are reserved, compute is deferred —
            # prefill_step runs one chunk per engine step so the decode
            # batch never stalls on a whole-prompt forward pass
            req.state = RequestState.PREFILL
            k_buf, v_buf = PD.init_chunk_buffers(self.cfg, bucket,
                                                 device=self.device)
            self.prefill_jobs[slot] = {
                "req": req, "refs": refs, "toks": toks, "bucket": bucket,
                "done": 0, "pages_written": 0, "k_buf": k_buf,
                "v_buf": v_buf}
            return True
        logits, k_seq, v_seq = self._prefill(self.params, self._tensor(toks), n)
        # windowed archs: only the window-covering tail pages were allocated
        # (refs[0].logical_idx > 0 for long prompts) — write just those
        span = refs[0].logical_idx * page
        self.pool.write_blocks(
            [r.slot for r in refs],
            *PD.pack_pages(k_seq[:, span:], v_seq[:, span:], len(refs), page))
        self._seat(slot, req, refs, logits, now)
        return True

    def _first_token(self, req: Request, logits, now: float):
        """Sample the prompt's first token off the final prefill logits and
        stamp TTFT."""
        first = sample(logits, generator=self._generator,
                       temperature=self.ecfg.temperature)
        req.output_tokens = [int(first[0])]
        req.generated = 1
        req.prefill_progress = 1.0
        if req.first_token_time < 0:
            # stamp AFTER the prefill (first_token_time - admit_time is the
            # prefill cost)
            req.first_token_time = self._stamp(now)

    def _seat(self, slot: int, req: Request, refs, logits, now: float):
        """Admission tail: point the slot at its pages, sample the prompt's
        first token, and flip the request to DECODE."""
        row = np.full(self.pages_per_seq, self.scratch, np.int32)
        row[:len(refs)] = [r.slot for r in refs]
        self.block_table[slot] = row
        self.slot_base[slot] = refs[0].logical_idx * self.pool.page_size
        self._first_token(req, logits, now)
        req.state = RequestState.DECODE
        self.slot_pos[slot] = req.prompt_len

    # -- chunked prefill -------------------------------------------------------
    def prefill_depth(self) -> int:
        """Slots currently mid-chunked-prefill (pending work for the service
        loop and the /health endpoint)."""
        return len(self.prefill_jobs)

    def prefill_step(self, now: float = 0.0) -> int:
        """Advance every mid-prefill slot by ONE chunk — the interleaving
        policy: each engine step gives each admitted-but-unprefilled slot
        one chunk of prompt compute next to the ongoing decodes. Returns the
        number of chunks run."""
        if not self.alive or not self.prefill_jobs:
            return 0
        ran = 0
        for slot in sorted(self.prefill_jobs):
            job = self.prefill_jobs[slot]
            req = job["req"]
            n = req.prompt_len
            # short prompts collapse to a single whole-bucket chunk; both
            # sizes are powers of two, so chunks tile the bucket exactly
            c = min(self.chunk, job["bucket"])
            c0 = job["done"]
            take = min(c, n - c0)
            logits, _, _ = self._prefill_chunk(
                self.params, self._tensor(job["toks"][:, c0:c0 + c]), c0,
                take, job["k_buf"], job["v_buf"])
            job["done"] = c0 + take
            req.prefill_progress = job["done"] / n
            ran += 1
            final = job["done"] >= n
            self._write_ready_pages(job, final)
            if final:
                self._seat(slot, req, job["refs"], logits, now)
                del self.prefill_jobs[slot]
        return ran

    def _write_ready_pages(self, job: dict, final: bool):
        """Incremental page writes: pages fully covered by the rows prefilled
        so far land in the pool as soon as their last row is computed (the
        final chunk also flushes the partial tail page). On a windowed pool
        only the allocated window-tail pages exist — writes start at the
        first allocated logical page. Rows are cast to the pool's KV dtype
        here; an int8 pool's ``write_blocks`` then quantizes them."""
        page = self.pool.page_size
        refs = job["refs"]
        first_page = refs[0].logical_idx
        if final:
            ready = len(refs)
        else:
            ready = min(max(0, job["done"] // page - first_page), len(refs))
        lo = job["pages_written"]
        if ready <= lo:
            return
        kv_dt = PD.kv_dtype(self.cfg)
        span0 = (first_page + lo) * page
        span1 = (first_page + ready) * page
        self.pool.write_blocks(
            [r.slot for r in refs[lo:ready]],
            *PD.pack_pages(job["k_buf"][:, span0:span1].to(kv_dt),
                           job["v_buf"][:, span0:span1].to(kv_dt),
                           ready - lo, page))
        job["pages_written"] = ready

    # -- one continuous-batching iteration ------------------------------------
    def step(self, now: float = 0.0) -> List[Request]:
        if not self.alive:
            return []
        # mid-chunked-prefill slots (PREFILL state) hold pages but no first
        # token yet — they join the decode batch the step after their final
        # chunk lands
        active = [i for i, r in enumerate(self.slot_rid)
                  if r >= 0 and self.requests[r].state == RequestState.DECODE]
        if not active:
            return []
        toks = np.zeros(self.ecfg.max_slots, np.int32)
        for i in active:
            rid = self.slot_rid[i]
            toks[i] = self.requests[rid].output_tokens[-1]
            # sliding window: pages fully below the window of the position
            # this step writes are recycled BEFORE allocating the new page
            recycled = self.pool.recycle_out_of_window(rid) \
                if self.window else []
            self.pending_retires.extend(
                (rid, r.logical_idx) for r in recycled)
            # account the KV row this step writes; may open a fresh block
            # (marks the receiving block dirty -> delta replication unit)
            try:
                ref = self.pool.append_token(rid)
            except MemoryError:
                self.pool.evict_replicas_for_pressure(1)
                ref = self.pool.append_token(rid)
            self.pending_retires.extend(
                (r.rid, r.logical_idx)
                for r in self.pool.drain_pending_recycles())
            if self.window:
                # window-relative row: column j = j-th resident page
                table = self.pool.table(rid)
                row = np.full(self.pages_per_seq, self.scratch, np.int32)
                row[:len(table)] = [r.slot for r in table]
                self.block_table[i] = row
                self.slot_base[i] = \
                    table[0].logical_idx * self.pool.page_size
            else:
                self.block_table[i, ref.logical_idx] = ref.slot
        pool = self.pool
        nxt, _ = self._decode(
            self.params, self._tensor(toks), pool.k, pool.v, pool.k_scale,
            pool.v_scale, self._tensor(self.block_table),
            self._tensor(self.slot_pos), self._tensor(self.slot_base),
            self._generator)
        nxt = nxt.cpu().numpy()        # the step's single host sync
        finished = []
        for i in active:
            req = self.requests[self.slot_rid[i]]
            req.output_tokens.append(int(nxt[i]))
            req.generated += 1
            self.slot_pos[i] += 1
            if req.generated >= req.max_new_tokens or \
                    self.slot_pos[i] >= self.ecfg.max_seq - 1:
                req.state = RequestState.DONE
                req.finish_time = self._stamp(now)
                finished.append(req)
                self.release(req.rid)
        return finished

    def release(self, rid: int):
        """Free a request's engine slot + primary blocks."""
        if rid in self.requests:
            slot = self.slot_rid.index(rid)
            self.prefill_jobs.pop(slot, None)
            self.slot_rid[slot] = -1
            self.slot_pos[slot] = 0
            self.slot_base[slot] = 0
            self.block_table[slot] = self.scratch
            self.pool.free(rid)
            self.requests.pop(rid)

    def slot_of(self, rid: int) -> int:
        return self.slot_rid.index(rid)

    def drain_retires(self) -> List[tuple]:
        """(rid, logical_idx) pages recycled since the last drain."""
        out, self.pending_retires = self.pending_retires, []
        return out

    # -- failover --------------------------------------------------------------
    def adopt_replica(self, peer: int, req: Request, meta,
                      migration: bool = True) -> bool:
        """Failover entry: promote hosted replica blocks to primary and
        resume the request here — no buffer copy, just ownership flip. The
        promoted table must contiguously cover every page the next decode
        step can attend to."""
        slots = self.free_slots()
        if not slots or not self.alive:
            return False
        page = self.pool.page_size
        total = meta["pos"]
        refs = self.pool.promote_replica(peer, req.rid)
        for ref in refs:
            ref.n_filled = max(0, min(page, total - ref.logical_idx * page))
            ref.replicated = False     # re-replicate to OUR ring target
        # the replica may carry one page the primary had already recycled
        # (hosting lags the live window by the in-flight retire): drop it
        self.pool.recycle_out_of_window(req.rid)
        refs = self.pool.table(req.rid)
        pages = [r.logical_idx for r in refs]
        first_needed = max(0, total + 1 - self.window) // page \
            if self.window else 0
        complete = (
            pages and pages[0] <= first_needed
            and pages[-1] == (total - 1) // page
            and pages == list(range(pages[0], pages[0] + len(pages)))
            and len(refs) <= self.pages_per_seq
            and all(r.n_filled > 0 for r in refs))
        if not complete:
            self.pool.free(req.rid)    # incomplete replica: can't resume
            return False
        slot = slots[0]
        row = np.full(self.pages_per_seq, self.scratch, np.int32)
        row[:len(refs)] = [r.slot for r in refs]
        self.block_table[slot] = row
        self.slot_base[slot] = refs[0].logical_idx * page
        self.slot_pos[slot] = total
        req.output_tokens = list(meta["tokens"])
        req.state = RequestState.DECODE
        req.instance_id = self.instance_id
        if migration:
            req.n_migrations += 1
        self.slot_rid[slot] = req.rid
        self.requests[req.rid] = req
        return True

    def fail(self):
        self.alive = False
        self.pending_retires.clear()   # a dead primary sends no retires
        self.prefill_jobs.clear()      # mid-chunk work is lost with the node
        # a dead instance holds no requests (its memory is lost) — the
        # engine captures the victims first
        self.requests = {}


class RealEngine:
    """LB group of RealInstances with ring block-delta replication, dynamic
    traffic rerouting, and mode-switched failover/recovery.

    ``params`` (optional) supplies the weights — e.g. the reference's params
    converted with ``repro_torch.convert``; by default they are initialised
    at random from a ``torch.Generator`` seeded with ``seed`` on ``device``.
    """

    def __init__(self, cfg, ecfg: Optional[EngineConfig] = None,
                 n_instances: int = 2, seed: int = 0,
                 clock: Optional[Callable[[], float]] = None,
                 device="cuda", params=None):
        self.cfg = cfg
        self.ecfg = ecfg or EngineConfig()
        self.device = torch.device(device)
        # monotonic engine time: ticks (one per step) by default, or the
        # injected wall clock
        self.clock = clock
        self.executor = FamilyExecutor(cfg, self.ecfg)
        # decoupled init: ONE weight materialization shared by all replicas
        if params is None:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(seed)
            params = transformer.init_params(cfg, gen, device=self.device)
        self.params = params
        self.roles = {i: "both" for i in range(n_instances)}
        # the control plane: membership/epoch, replication placement,
        # least-loaded routing, and the multi-failure recovery planner
        self.control = ControlPlane(
            n_instances, placement=self.ecfg.placement, roles=self.roles)
        self.instances = [self._make_instance(i) for i in range(n_instances)]
        # rid -> {"peer", "home", "pos", "tokens"} (tiny host-side metadata;
        # the KV payload lives in the target pool's hosted replica blocks)
        self.replica_meta: Dict[int, dict] = {}
        # staged copies at the end of step N ship at the top of step N+1 (or
        # at the fail/rejoin barrier); totals count at FLUSH time
        self.transport = TransportChannel(self.instances,
                                          view=self.control.view)
        # arrivals not yet routed (hold work only while NO instance is alive)
        self.waiting: List[Request] = []
        self.queues: Dict[int, List[Request]] = {
            i: [] for i in range(n_instances)}
        self.done: List[Request] = []
        self.t = self.clock() if self.clock is not None else 0.0
        # standard-recovery stall: until this time the WHOLE group is down
        self.stall_until = -1.0
        # one dict per fail_instance call; "mttr" lands at rejoin time
        self.failure_events: List[dict] = []
        self.repl_steps = 0
        self.active_request_steps = 0
        self.retire_msgs_total = 0
        # (n_active_slots, wall_seconds) per engine step that decoded
        self.step_samples: List[tuple] = []

    def _make_instance(self, instance_id: int) -> RealInstance:
        return RealInstance(self.cfg, self.params, self.ecfg, instance_id,
                            executor=self.executor, clock=self.clock,
                            device=self.device)

    # -- replication traffic accounting --------------------------------------
    @property
    def repl_blocks_total(self) -> int:
        return self.transport.shipped.blocks

    @property
    def repl_bytes_total(self) -> int:
        return self.transport.shipped.bytes

    def submit(self, req: Request):
        self.waiting.append(req)

    # -- dynamic traffic rerouting (LB) ---------------------------------------
    def _load(self, inst: RealInstance) -> int:
        """Instance load as the LB sees it: active slots + queued depth."""
        return len(inst.requests) + len(self.queues[inst.instance_id])

    def _route(self, req: Request, front: bool = False):
        """Place the request on the least-loaded ALIVE instance's queue
        (front=True keeps requeued work ahead of later arrivals)."""
        alive = [i for i in self.instances if i.alive]
        if not alive:
            self.waiting.insert(0, req) if front else self.waiting.append(req)
            return
        tgt = self.control.routing.pick(alive, self._load)
        req.instance_id = tgt.instance_id
        q = self.queues[tgt.instance_id]
        q.insert(0, req) if front else q.append(req)

    def has_pending(self) -> bool:
        """True while any request is waiting, queued, or in flight."""
        return bool(self.waiting) or \
            any(self.queues.values()) or \
            any(i.requests for i in self.instances)

    def queue_depth(self) -> int:
        return len(self.waiting) + sum(len(q) for q in self.queues.values())

    def recovery_pending(self) -> bool:
        """True while a spare is waiting to rejoin or the group is inside a
        standard-mode reload stall."""
        return self.control.planner.has_pending() or self.t < self.stall_until

    def _ring_target(self, instance_id: int) -> int:
        return self.control.placement.target(instance_id, self.control.view)

    def step(self) -> int:
        """One engine iteration: rejoin a due spare, route + admit, decode
        everywhere, replicate deltas. Returns the number of requests that
        made forward progress (0 while stalled or idle)."""
        self.t = self.clock() if self.clock is not None else self.t + 1.0
        _t0 = time.perf_counter()
        # async shipping: flush the PREVIOUS step's staged deltas before
        # anything here mutates the pools
        self.flush_replication()
        due = self.control.planner.next_due(self.t)
        if due is not None:
            self.rejoin_instance(due)
        if self.t < self.stall_until:
            return 0       # standard recovery: group-wide weight reload
        alive = [i for i in self.instances if i.alive]
        while self.waiting and alive:
            self._route(self.waiting.pop(0))
        progressed = 0
        for inst in alive:
            q = self.queues[inst.instance_id]
            while q and inst.free_slots() and inst.admit(q[0], self.t):
                q.pop(0)
                progressed += 1
        # queued work an instance cannot place flows to any peer with
        # headroom (free slots and pool pages are separate limits)
        for inst in alive:
            q = self.queues[inst.instance_id]
            if not q:
                continue
            for other in self.control.routing.order(alive, self._load):
                if other is inst:
                    continue
                while q and other.free_slots() and other.admit(q[0], self.t):
                    q.pop(0)
                    progressed += 1
        n_active = sum(len(i.requests) for i in alive)
        for inst in alive:
            self.active_request_steps += len(inst.requests)
            progressed += len(inst.requests)
            # one prompt chunk per mid-prefill slot, then the decode batch:
            # admissions interleave with generation instead of stalling it
            inst.prefill_step(self.t)
            finished = inst.step(self.t)
            # retire hosted replicas of pages the primary recycled this step
            # BEFORE the delta pass, so replica tables mirror the window
            for rid, lidx in inst.drain_retires():
                meta = self.replica_meta.get(rid)
                if meta is None or not self.instances[meta["home"]].alive:
                    continue
                if self.instances[meta["home"]].pool.retire_replica_block(
                        meta["peer"], rid, lidx):
                    self.retire_msgs_total += 1
            for req in finished:
                self._drop_replica_of(req.rid)
                self.done.append(req)
        # slots and pages freed by this step's completions admit queued
        # work now instead of a full iteration later
        for inst in alive:
            q = self.queues[inst.instance_id]
            while q and inst.free_slots() and inst.admit(q[0], self.t):
                q.pop(0)
                progressed += 1
        if self.ecfg.replicate:
            self._replicate()
            self.repl_steps += 1
        if n_active:
            self.step_samples.append((n_active, time.perf_counter() - _t0))
            if len(self.step_samples) > 20000:      # bound long-run memory
                del self.step_samples[:10000]
        return progressed

    def _drop_replica_of(self, rid: int):
        meta = self.replica_meta.pop(rid, None)
        if meta is not None:
            self.instances[meta["home"]].pool.drop_replica(meta["peer"], rid)

    def _replicate(self):
        """Background KV replication at block granularity. Delta mode copies
        only blocks with ``replicated == False``; full mode re-copies every
        live block. ``_stage_replication`` does all the metadata work now;
        the copies ship at the top of the next step (``flush_replication``)
        unless ``repl_async`` is off."""
        self._stage_replication()
        if not self.ecfg.repl_async:
            self.flush_replication(block=True)

    def flush_replication(self, block: bool = False,
                          exclude: Optional[int] = None):
        """Ship every staged copy job now — the async double-buffer's
        barrier. Called at the top of every step and by ``fail_instance`` /
        ``rejoin_instance`` BEFORE they touch replicas, so a promoted
        replica always carries the bytes of the primary's last completed
        step. Jobs toward a dead target (or ``exclude``) are dropped."""
        self.transport.flush(block=block, exclude=exclude)

    def _stage_replication(self):
        full = self.ecfg.replication == "full"
        for inst in self.instances:
            if not inst.alive:
                continue
            tgt_id = self._ring_target(inst.instance_id)
            if tgt_id < 0:
                continue
            tgt = self.instances[tgt_id]
            src_slots: List[int] = []
            dst_slots: List[int] = []
            for rid, req in inst.requests.items():
                if req.state != RequestState.DECODE:
                    continue
                # the ring target can change (failure, spare rejoin): drop
                # the replica still hosted on the PREVIOUS home
                meta = self.replica_meta.get(rid)
                if meta is not None and meta["home"] != tgt_id and \
                        self.instances[meta["home"]].alive:
                    self.instances[meta["home"]].pool.drop_replica(
                        meta["peer"], rid)
                table = inst.pool.table(rid)
                reconcile_replica(tgt.pool, inst.instance_id, rid, table)
                if not host_table_growth(tgt.pool, inst.instance_id, rid,
                                         table):
                    continue   # no headroom on target; retry next pass
                rtab = tgt.pool.replica_table(inst.instance_id, rid)
                # copy when the primary block is dirty OR the hosted block
                # has never received content (fresh hosting)
                s, d = collect_dirty(table, rtab, full=full)
                src_slots += s
                dst_slots += d
                self.replica_meta[rid] = {
                    "peer": inst.instance_id, "home": tgt_id,
                    "pos": int(inst.slot_pos[inst.slot_of(rid)]),
                    "tokens": list(req.output_tokens),
                }
                req.replicated_through = req.total_len
            if src_slots:
                self.transport.stage(inst.instance_id, tgt_id,
                                     (src_slots, dst_slots))

    def replication_stats(self) -> dict:
        steps = max(self.repl_steps, 1)
        req_steps = max(self.active_request_steps, 1)
        return {
            "mode": self.ecfg.replication if self.ecfg.replicate else "off",
            "blocks_total": self.repl_blocks_total,
            "bytes_total": self.repl_bytes_total,
            "blocks_per_step": self.repl_blocks_total / steps,
            "bytes_per_step": self.repl_bytes_total / steps,
            "blocks_per_request_step": self.repl_blocks_total / req_steps,
            "retire_msgs_total": self.retire_msgs_total,
            "retires_per_request_step": self.retire_msgs_total / req_steps,
        }

    def prefix_stats(self) -> dict:
        """Prefill accounting (the prefix cache is not ported yet)."""
        insts = self.instances
        return {"enabled": False,
                "prefill_total_tokens": sum(i.prefill_total_tokens
                                            for i in insts)}

    def disagg_stats(self) -> dict:
        """Disaggregation status (not ported yet: every instance colocated)."""
        return {"enabled": False,
                "roles": {i.instance_id: i.role for i in self.instances}}

    # -- fault entry points ------------------------------------------------------
    def apply_fault(self, spec: FaultSpec) -> Optional[List[int]]:
        """THE fault entry point (``POST /v1/admin/fault``). Malformed specs
        raise ValueError before any state changes; ``if_busy`` specs no-op
        (return None) on an idle instance. Returns the rids that resumed
        seamlessly."""
        spec.validate(len(self.instances), self.ecfg.n_shards)
        if spec.if_busy and not self.instances[spec.instance_id].requests:
            return None
        if spec.granularity == "shard":
            raise ValueError("shard-granularity faults are not ported yet")
        return self._apply_instance_fault(spec.instance_id)

    def recover(self, spec: FaultSpec):
        """THE recovery entry point (``POST /v1/admin/recover``). State
        conflicts — rejoining an alive instance, restoring shards of an
        instance that lost none — raise ValueError (HTTP 409)."""
        spec.validate(len(self.instances), self.ecfg.n_shards,
                      for_recover=True)
        if spec.granularity == "shard":
            raise ValueError(f"instance {spec.instance_id} is not degraded")
        return self._recover_instance(spec.instance_id)

    def fail_instance(self, instance_id: int) -> List[int]:
        """Kill a whole instance (thin wrapper over ``apply_fault``)."""
        return self.apply_fault(
            FaultSpec(granularity="instance", instance_id=instance_id))

    def rejoin_instance(self, instance_id: int) -> RealInstance:
        """Warm-spare rejoin (thin wrapper over ``recover``)."""
        return self.recover(
            FaultSpec(granularity="instance", instance_id=instance_id))

    def _apply_instance_fault(self, instance_id: int) -> List[int]:
        """Kill an instance and run the configured recovery policy.

        kevlarflow: in-flight requests resume from the replica blocks
        already hosted on the ring target (``promote_replica``), the dead
        instance's waiting queue drains onto the survivors, and the failure
        is handed to the recovery planner (auto or manual rejoin).
        standard: every victim restarts from scratch, and the whole group
        stalls for ``reload_penalty`` clock units.

        Returns the rids that resumed seamlessly."""
        inst = self.instances[instance_id]
        if not inst.alive:
            return []      # already dead: idempotent (e.g. an HTTP retry)
        if self.clock is not None:
            self.t = self.clock()   # admin-thread call: stamp failure now
        # async-replication barrier: the last step's staged delta lands on
        # the hosts before any replica is promoted or dropped; copies INTO
        # the dying instance are dropped
        self.flush_replication(exclude=instance_id)
        standard = self.ecfg.recovery == "standard"
        victims = list(inst.requests.values())
        drained = self.queues[instance_id]
        self.queues[instance_id] = []
        inst.fail()
        self.control.view.mark_failed(instance_id)
        event = {"instance": instance_id, "granularity": "instance",
                 "shard_idx": None, "mode": self.ecfg.recovery,
                 "t_fail": self.t, "n_victims": len(victims),
                 "requeued": len(drained), "resumed": 0, "restarted": 0,
                 "t_rejoin": -1.0, "mttr": -1.0}
        self.failure_events.append(event)
        resumed = []
        restarted: List[Request] = []
        for req in victims:
            meta = self.replica_meta.pop(req.rid, None)
            target = None
            if meta is not None and self.instances[meta["home"]].alive:
                target = self.instances[meta["home"]]
            if not standard and target is not None and \
                    target.adopt_replica(meta["peer"], req, meta):
                resumed.append(req.rid)
                event["resumed"] += 1
            else:
                if target is not None:
                    target.pool.drop_replica(meta["peer"], req.rid)
                req.restart()
                req.state = RequestState.QUEUED
                event["restarted"] += 1
                restarted.append(req)
        # restarted victims requeue ahead of everything else, in their
        # original order
        for req in reversed(restarted):
            self._route(req, front=True)
        for req in drained:
            self._route(req)
        # replicas the dead instance hosted for others are gone: mark those
        # primaries dirty so the next pass re-replicates to a new target
        for other in self.instances:
            if not other.alive:
                continue
            for rid in other.requests:
                meta = self.replica_meta.get(rid)
                if meta is not None and meta["home"] == instance_id:
                    self.replica_meta.pop(rid)
                    for ref in other.pool.table(rid):
                        ref.replicated = False
        if standard:
            self.stall_until = self.t + self.ecfg.reload_penalty
        if self.ecfg.auto_rejoin:
            delay = self.ecfg.reload_penalty if standard \
                else self.ecfg.rejoin_delay
            self.control.planner.on_failure(instance_id, self.t,
                                            rejoin_at=self.t + delay,
                                            kind="instance")
        else:
            self.control.planner.on_failure(instance_id, self.t,
                                            kind="instance")
        return resumed

    def _recover_instance(self, instance_id: int) -> RealInstance:
        """Warm-spare rejoin (decoupled init, paper Sec 3.2 mechanism #1):
        rebuild the failed instance around the shared weights and programs
        — no weight reload — and re-enter the LB group and the replication
        ring."""
        if self.instances[instance_id].alive:
            raise ValueError(f"instance {instance_id} is alive")
        if self.clock is not None:
            self.t = self.clock()       # admin-thread call: stamp MTTR now
        # barrier before the instance object (and its pool) is replaced
        self.flush_replication()
        self.control.planner.on_rejoined(instance_id, self.t)
        inst = self._make_instance(instance_id)
        self.instances[instance_id] = inst
        self.queues[instance_id] = []
        self.control.view.mark_alive(instance_id)
        for event in reversed(self.failure_events):
            if event["instance"] == instance_id and event["t_rejoin"] < 0:
                event["t_rejoin"] = self.t
                event["mttr"] = self.t - event["t_fail"]
                break
        # parked arrivals (possible while NO instance was alive) flow again
        while self.waiting:
            self._route(self.waiting.pop(0))
        return inst

    def mttr_events(self) -> List[dict]:
        """Completed failure->rejoin cycles (mttr in engine clock units)."""
        return [e for e in self.failure_events if e["mttr"] >= 0]

    def run(self, max_iters: int = 1000):
        while self.has_pending() and max_iters > 0:
            self.step()
            max_iters -= 1
        return self.done
