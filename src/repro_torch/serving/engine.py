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
    on the target;
  * prefix caching (``prefix_cache``) — fully-covered prompt pages are
    interned by chain hash and attached by reference on admission; writes
    that land on a shared page copy-on-write first, and a shared page
    ships at most once per ring target;
  * disaggregation (``disaggregate``) — prefill-role instances stream each
    finished prompt page over the same transport to a decode-role peer,
    which seats the request when the final chunk's pages land.

Dynamic traffic rerouting (paper Sec 3.2 mechanism #2) is the LB layer of
``RealEngine``: every instance owns a waiting queue, new arrivals route to
the least-loaded alive instance, queued work an instance cannot place flows
to any peer with headroom, and ``fail_instance`` drains the dead instance's
queue onto the survivors while in-flight requests resume from promoted
replicas. ``EngineConfig.recovery`` picks ``kevlarflow`` (warm-spare
rejoin) or ``standard`` (every victim restarts and the group stalls for
``reload_penalty`` clock units).

A shard-granularity fault (``fail_shard``) degrades an instance instead of
killing it: its slot capacity drops to the surviving fraction of its
``n_shards``, the excess requests migrate, and the instance serves on.
One card runs no tensor parallelism, so the degraded layout (which tensors
stay model-sharded over the surviving shards, the bytes per shard) is
computed over shapes (``distributed/sharding.py``) and reported, not
executed; decode on the surviving slots is unchanged.

This port serves the dense family with monolithic or chunked prefill, a
bf16 or int8 KV pool, prefix caching and prefill/decode disaggregation.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.distributed import sharding as SH
from repro_torch.models import layers as L
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
    # prefix caching: fully-covered prompt pages are content-hashed (token
    # ids + arch + kv dtype chain key), interned in the pool's prefix index
    # and attached by reference on admission — the longest cached
    # page-aligned prefix costs no fresh pages, no prefill compute (chunked
    # prefill resumes past it when the page bytes are the activation
    # dtype), and no replication bytes beyond one ship per (ring target,
    # page). Writes landing on a shared page copy-on-write first.
    prefix_cache: bool = False
    # async double-buffered replication: _replicate STAGES the step's dirty
    # block ids and the copies ship at the top of the NEXT step.
    # flush_replication is the barrier — fail_instance/rejoin_instance flush
    # before touching replicas, so failover stays byte-identical. False =
    # ship in-step and block until the replica is durable.
    repl_async: bool = True
    # prefill/decode disaggregation: the first max(1, n//2) instances run
    # chunked prefill ONLY and stream each fully-covered prompt page (the
    # chain key for prefix-cached pages, which the decode side interns
    # rather than copies) to a decode-role instance over the transport
    # replication uses; the decode instance seats the request when the
    # final chunk's pages land. Byte-identical to colocated serving.
    # Requires prefill_chunk > 0 and >= 2 instances. Roles are soft: with
    # every prefill-role instance dead the survivors serve colocated.
    disaggregate: bool = False
    # replication placement policy (controlplane.PlacementPolicy)
    placement: str = "successor"
    # recovery policy applied by fail_instance (see module docstring)
    recovery: str = "kevlarflow"   # "kevlarflow" | "standard"
    auto_rejoin: bool = False      # schedule rejoin_instance automatically
    rejoin_delay: float = 1.0      # kevlarflow spare re-form (clock units)
    reload_penalty: float = 20.0   # standard full re-init (clock units)
    # modeled tensor-parallel shards per instance. A shard-granularity
    # fault (apply_fault / fail_shard) degrades the instance onto its
    # surviving slice instead of killing it: slot capacity drops to
    # floor(max_slots * surviving / n_shards), the layout re-derived over
    # the smaller model axis is reported (distributed.sharding —
    # replicate-fallback where divisibility breaks), and the ClusterView
    # marks it DEGRADED (its own epoch bump) so placement deprioritizes it
    # and routing discounts it. Under "standard" recovery a shard fault
    # escalates to whole-instance failure
    n_shards: int = 4


def _check_ported(cfg):
    if cfg.arch_type not in PD.PAGED_FAMILIES:
        raise NotImplementedError(
            f"the port serves {PD.PAGED_FAMILIES}, not {cfg.arch_type!r}")


class FamilyExecutor:
    """The prefill + decode programs for one (cfg, EngineConfig) pair, shared
    by every instance — including a warm spare rejoining after a failure.
    Decode updates the pool buffers (and an int8 pool's scales, None
    otherwise) in place; a prefill chunk updates its carry buffers in
    place."""

    def __init__(self, cfg, ecfg: EngineConfig):
        _check_ported(cfg)
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
                 device="cuda", role: str = "both"):
        self.cfg = cfg
        self.family = cfg.arch_type
        self.params = params          # node-resident weights (shared ref!)
        self.ecfg = ecfg
        self.instance_id = instance_id
        self.device = torch.device(device)
        self.alive = True
        # disaggregation role: "prefill" instances run chunked prefill only
        # and hand finished prompts to the engine's handoff stream instead
        # of seating them; "decode" instances receive streamed pages and
        # decode; "both" is colocated serving
        self.role = role
        self.handoff_mode = role == "prefill"
        # prefill jobs whose final chunk just ran under handoff_mode: the
        # engine drains these into its handoff records each step
        self.ready_handoffs: List[dict] = []
        # shard-level degradation: lost shard indices; a degraded instance
        # serves on with its slots capped (slot_cap) and the layout summary
        # of the surviving slice in degraded_layout
        self.n_shards = max(1, ecfg.n_shards)
        self.lost_shards: set = set()
        self.degraded_layout: Optional[dict] = None
        B, S = ecfg.max_slots, ecfg.max_seq
        page = cfg.page_size
        self.window = cfg.sliding_window
        self.pages_per_seq = PD.table_pages(cfg, S)
        n_blocks = 2 * B * self.pages_per_seq + 1  # primaries+replicas+scratch
        self.pool = PagedKVPool(
            n_blocks, page, n_layers=len(PD.kv_layer_indices(cfg)),
            n_kv_heads=cfg.n_kv_heads, head_dim=cfg.head_dim, real=True,
            dtype=PD.kv_dtype(cfg), window=self.window, device=self.device,
            quantized=ecfg.kv_quant, prefix_cache=ecfg.prefix_cache,
            # chain-hash identity: a page is only reusable under the same
            # model AND the same on-page byte representation
            arch_key=f"{cfg.name}|{cfg.arch_type}"
                     f"|{str(PD.kv_dtype(cfg)).removeprefix('torch.')}"
                     f"|q{int(ecfg.kv_quant)}")
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
        # prefix-cache accounting (prefix_stats aggregates across instances)
        self.prefill_total_tokens = 0
        self.prefill_compute_tokens = 0
        self.prefix_cached_tokens = 0
        # chunk buffers can be seeded from pool pages only when the page
        # bytes ARE the activation dtype (int8 pages are lossy) — shared by
        # the prefix cache's compute skip and the streamed-handoff resume.
        # Ineligible configs still share pages: they recompute the whole
        # prompt but skip the writes to shared pages (deterministic
        # recompute reproduces the interned bytes)
        self._can_seed_chunks = (
            self.chunk > 0 and not ecfg.kv_quant
            and L.torch_dtype(cfg.dtype) == PD.kv_dtype(cfg))
        self.prefix_skip_compute = ecfg.prefix_cache and self._can_seed_chunks

    def _stamp(self, now: float) -> float:
        """Timestamp an event: fresh wall-clock reading when a clock is
        wired (admission/prefill take real time), else the caller's tick."""
        return self.clock() if self.clock is not None else now

    def _tensor(self, arr) -> torch.Tensor:
        return torch.as_tensor(arr, device=self.device)

    # -- admission -----------------------------------------------------------
    @property
    def slot_cap(self) -> int:
        """Concurrent-slot capacity under the current shard set: the full
        ``max_slots`` when whole, scaled by the surviving fraction when
        degraded (never below 1 — a degraded instance still serves)."""
        if not self.lost_shards:
            return self.ecfg.max_slots
        surviving = self.n_shards - len(self.lost_shards)
        return max(1, (self.ecfg.max_slots * surviving) // self.n_shards)

    def capacity_frac(self) -> float:
        """Throughput cap as a fraction of the whole instance (0 dead)."""
        if not self.alive:
            return 0.0
        if not self.lost_shards:
            return 1.0
        return (self.n_shards - len(self.lost_shards)) / self.n_shards

    def free_slots(self) -> List[int]:
        """Admittable slot indices, capped by ``slot_cap``: every admission
        path — queue admit, replica adoption, handoff seating — respects a
        degraded instance's reduced capacity."""
        free = [i for i, r in enumerate(self.slot_rid) if r < 0]
        headroom = max(0, self.slot_cap - (len(self.slot_rid) - len(free)))
        return free[:headroom]

    def degrade(self, shard_idx: int) -> List[Request]:
        """Lose one shard: record it, shrink capacity, and hand back the
        EXCESS in-flight requests (the highest occupied slots). The engine
        migrates them; the pool and every request that stays are
        untouched, so decode on the survivors is byte-identical."""
        self.lost_shards.add(shard_idx)
        occupied = [i for i, r in enumerate(self.slot_rid) if r >= 0]
        excess = len(occupied) - self.slot_cap
        if excess <= 0:
            return []
        return [self.requests[self.slot_rid[i]] for i in occupied[-excess:]]

    def restore_shards(self):
        """Every lost shard rejoined: full layout, full capacity."""
        self.lost_shards.clear()
        self.degraded_layout = None

    def _allocate(self, rid: int, n_tokens: int, token_ids=None):
        """Allocate primary blocks, evicting hosted replicas under pressure
        (the paper's rule: replicas are the first thing dropped)."""
        need = self.pool.resident_blocks_for(n_tokens)
        protect = ()
        if self.ecfg.prefix_cache and token_ids is not None \
                and not self.pool.window:
            # pressure estimate: pages the prefix cache will cover cost no
            # fresh slots — don't evict failover state to make room for them
            matched, partial = self.pool.match_prefix(
                token_ids[:n_tokens], peek=True)
            need -= len(matched) + (1 if partial else 0)
            protect = {e.key for e in matched}
            if partial:
                protect.add(partial[0].key)
        if need > self.pool.n_free and not self.pool.window:
            # warm refcount-0 prefix pages are pure cache: reclaim them
            # before dropping peers' failover state
            self.pool.evict_cached_prefixes(need, protect=protect)
            if need > self.pool.n_free:
                self.pool.evict_replicas_for_pressure(need)
        try:
            refs = self.pool.allocate(rid, n_tokens, token_ids=token_ids)
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
            refs = self._allocate(     # full pool costs no compute
                req.rid, n, token_ids=req.prompt_tokens)
        except MemoryError:
            return False
        # prefix-cache hit accounting: tokens covered by interned pages
        # attached during allocation (0 when the cache is off or cold)
        cached = self.pool.prefix_hits_by_rid.pop(req.rid, 0) \
            if self.ecfg.prefix_cache else 0
        self.prefill_total_tokens += n
        self.prefix_cached_tokens += cached
        page = self.pool.page_size
        # write plan over the cached run: fully-covered shared pages are
        # never written; a shared page the prompt diverges INSIDE is CoW'd
        # to a private slot and rewritten (cow_page); a shared page the
        # prompt merely ends inside is kept shared (rows past the prompt
        # are masked by the sequence length)
        skip_pages, cow_page = 0, -1
        if cached:
            skip_pages = cached // page
            if cached % page:
                if n > cached:
                    cow_page = skip_pages
                else:
                    skip_pages += 1
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
            done = 0
            if cached and self.prefix_skip_compute:
                # resume past the cached run, floored to a chunk boundary
                # (the chunks keep the cold run's shapes); the final chunk
                # always runs (its logits sample the first token), so the
                # resume point stays < n
                c = min(self.chunk, bucket)
                done = (min(cached, n - 1) // c) * c
                if done:
                    PD.seed_chunk_buffers(
                        k_buf, v_buf, self.pool.k, self.pool.v,
                        [r.slot for r in refs[:-(-cached // page)]])
            self.prefill_jobs[slot] = {
                "req": req, "refs": refs, "toks": toks, "bucket": bucket,
                "done": done,
                "pages_written": skip_pages if cow_page < 0 else cow_page,
                "cow_page": cow_page, "k_buf": k_buf, "v_buf": v_buf}
            return True
        logits, k_seq, v_seq = self._prefill(self.params, self._tensor(toks), n)
        self.prefill_compute_tokens += n   # monolithic: always full compute
        # windowed archs: only the window-covering tail pages were allocated
        # (refs[0].logical_idx > 0 for long prompts) — write just those.
        # Shared prefix pages already hold these exact bytes and are never
        # written in place; the diverging page goes private first
        first_page = refs[0].logical_idx
        lo = skip_pages if cow_page < 0 else cow_page
        if cow_page >= 0:
            self.pool.ensure_private(req.rid, cow_page)
        if lo < len(refs):
            span = (first_page + lo) * page
            self.pool.write_blocks(
                [r.slot for r in refs[lo:]],
                *PD.pack_pages(k_seq[:, span:], v_seq[:, span:],
                               len(refs) - lo, page))
        self._seat(slot, req, refs, logits, now)
        return True

    def _first_token(self, req: Request, logits, now: float):
        """Sample the prompt's first token off the final prefill logits and
        stamp TTFT — shared by colocated seating and the handoff path (the
        PREFILL side samples, so TTFT means prefill completion in both
        modes)."""
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
        if self.ecfg.prefix_cache and req.prompt_tokens is not None:
            # prefill wrote every prompt page: publish the fully-covered
            # ones into the prefix index (no-op for pages already shared)
            self.pool.intern_prefix(req.rid,
                                    req.prompt_tokens[:req.prompt_len])
        row = np.full(self.pages_per_seq, self.scratch, np.int32)
        row[:len(refs)] = [r.slot for r in refs]
        self.block_table[slot] = row
        self.slot_base[slot] = refs[0].logical_idx * self.pool.page_size
        if req.generated == 0:
            # a handoff that fell back to local seating already sampled
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
            self.prefill_compute_tokens += take
            req.prefill_progress = job["done"] / n
            ran += 1
            final = job["done"] >= n
            self._write_ready_pages(job, final)
            if final:
                if self.handoff_mode:
                    # disaggregation: the prompt's pages are in the pool but
                    # the slot parks in PREFILL state — the engine streams
                    # the remaining pages to the decode target and seats the
                    # request THERE. The first token is sampled now, so TTFT
                    # means prefill completion, as colocated.
                    self._first_token(req, logits, now)
                    self.ready_handoffs.append(
                        {"slot": slot, "req": req, "refs": job["refs"],
                         "logits": logits})
                else:
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
        cow = job["cow_page"]
        if 0 <= cow < ready:
            # this batch writes into a shared page the prompt diverges
            # inside: copy-on-write to a private slot before the write
            # lands (the interned page is never mutated in place)
            self.pool.ensure_private(job["req"].rid, refs[cow].logical_idx)
            job["cow_page"] = -1
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

    def drain_ready_handoffs(self) -> List[dict]:
        """Prefill jobs whose final chunk ran since the last drain (handoff
        mode): their pages are written and the request is ready to stream
        to its decode target."""
        out, self.ready_handoffs = self.ready_handoffs, []
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

    # -- disaggregated handoff (decode side) -----------------------------------
    def seat_handoff(self, peer: int, req: Request) -> bool:
        """Seat a fully-streamed prefill: promote the hosted pages to
        primary and start decoding — the handoff twin of ``adopt_replica``,
        minus the migration count (a handoff is the normal path, not a
        failure). The promoted pages carry the exact bytes the prefill
        wrote, so decode is byte-identical to colocated serving. Returns
        False (hosted table untouched) when no slot is free yet — the
        engine retries next step."""
        meta = {"pos": req.prompt_len, "tokens": list(req.output_tokens)}
        if not self.adopt_replica(peer, req, meta, migration=False):
            return False
        if self.ecfg.prefix_cache and req.prompt_tokens is not None:
            # same publication a colocated _seat does: the streamed prompt
            # pages become this pool's warm prefix chain
            self.pool.intern_prefix(req.rid,
                                    req.prompt_tokens[:req.prompt_len])
        return True

    def adopt_prefill_stream(self, peer: int, req: Request) -> bool:
        """Streamed-handoff recovery: the prefill source died mid-stream,
        and the pages it already shipped are hosted HERE. Promote them and
        resume the chunked prefill from the first unstreamed chunk, seeding
        the chunk buffers from the streamed pages — no recompute for work
        that already crossed the wire. Only bitwise-lossless configs can
        seed (``_can_seed_chunks``); everything else returns False and the
        caller restarts the request from scratch (deterministic recompute
        keeps the stream byte-identical either way)."""
        hosted = self.pool.replica_table(peer, req.rid)
        page = self.pool.page_size
        n = req.prompt_len
        usable = 0
        for i, ref in enumerate(hosted):
            if ref.logical_idx != i or ref.n_filled < page:
                break
            usable += 1
        slots = self.free_slots()
        if not (slots and self.alive and self._can_seed_chunks
                and usable and usable == len(hosted)
                and usable * page < n):
            # nothing streamed, a windowed tail (logical start > 0), or a
            # config that cannot seed buffers losslessly: full restart
            self.pool.drop_replica(peer, req.rid)
            return False
        # snapshot: promote returns the LIVE table list, which the extending
        # allocate below appends into
        refs = list(self.pool.promote_replica(peer, req.rid))
        for ref in refs:
            ref.n_filled = page
            ref.replicated = False
        try:
            refs = refs + self.pool.allocate(req.rid, n - usable * page)
        except MemoryError:
            self.pool.free(req.rid)
            return False
        slot = slots[0]
        bucket = PD.next_bucket(n, lo=page)
        toks = np.zeros((1, bucket), np.int32)
        toks[0, :n] = req.prompt_tokens
        k_buf, v_buf = PD.init_chunk_buffers(self.cfg, bucket,
                                             device=self.device)
        c = min(self.chunk, bucket)
        # resume floored to a chunk boundary; the final chunk always runs
        # (its logits sample the first token), so resume stays < n
        done = (min(usable * page, n - 1) // c) * c
        if done:
            PD.seed_chunk_buffers(k_buf, v_buf, self.pool.k, self.pool.v,
                                  [r.slot for r in refs[:usable]])
        self.slot_rid[slot] = req.rid
        self.requests[req.rid] = req
        req.state = RequestState.PREFILL
        req.instance_id = self.instance_id
        req.prefill_progress = done / n
        req.n_migrations += 1
        self.prefill_jobs[slot] = {
            "req": req, "refs": refs, "toks": toks, "bucket": bucket,
            "done": done, "pages_written": usable, "cow_page": -1,
            "k_buf": k_buf, "v_buf": v_buf}
        return True

    def finish_handoff(self, rid: int):
        """The decode side seated the streamed request: publish its prompt
        pages into OUR prefix index (warm for future arrivals with the same
        prefix) and free the parked slot."""
        req = self.requests.get(rid)
        if req is None:
            return
        if self.ecfg.prefix_cache and req.prompt_tokens is not None:
            self.pool.intern_prefix(rid, req.prompt_tokens[:req.prompt_len])
        self.release(rid)

    def fail(self):
        self.alive = False
        self.pending_retires.clear()   # a dead primary sends no retires
        self.prefill_jobs.clear()      # mid-chunk work is lost with the node
        self.ready_handoffs.clear()
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
        # prefill/decode disaggregation: the first max(1, n//2) instances
        # take the prefill role, the rest decode; without it every
        # instance is colocated ("both")
        if self.ecfg.disaggregate:
            if n_instances < 2:
                raise ValueError("disaggregate=True needs >= 2 instances "
                                 "(one per role)")
            if self.ecfg.prefill_chunk <= 0:
                raise ValueError(
                    "disaggregate=True requires prefill_chunk > 0 — pages "
                    "stream to the decode side as chunks complete")
            n_pre = max(1, n_instances // 2)
            self.roles = {i: "prefill" if i < n_pre else "decode"
                          for i in range(n_instances)}
        else:
            self.roles = {i: "both" for i in range(n_instances)}
        # the control plane: membership/epoch, replication placement,
        # least-loaded routing, and the multi-failure recovery planner
        self.control = ControlPlane(
            n_instances, placement=self.ecfg.placement, roles=self.roles)
        self.instances = [self._make_instance(i) for i in range(n_instances)]
        # rid -> {"peer", "home", "pos", "tokens"} (tiny host-side metadata;
        # the KV payload lives in the target pool's hosted replica blocks)
        self.replica_meta: Dict[int, dict] = {}
        # the staged block transport both byte streams ride: ring
        # replication ("repl") and the prefill->decode handoff ("handoff").
        # Copies staged at the end of step N ship at the top of step N+1
        # (or at the fail/rejoin barrier); totals count at FLUSH time
        self.transport = TransportChannel(self.instances,
                                          view=self.control.view)
        # rid -> in-flight handoff record (disaggregation): which prefill
        # instance is streaming it, the decode target, and whether the
        # final chunk's pages have landed (seat condition)
        self._handoffs: Dict[int, dict] = {}
        self.handoffs_seated = 0
        self.handoff_streams_resumed = 0
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
        # shared-page replication: a prefix page ships AT MOST ONCE per
        # (ring target, chain key); later requests referencing it on the
        # same target add a refcount, not bytes. Hosting events count per
        # (target, key) MEMBERSHIP: fail_instance prunes a dead target's
        # keys, so a rejoin's fresh pool re-counts the hosting when the key
        # ships again and the ship ratio stays exact across failures
        self.repl_shared_refs_total = 0
        self.repl_shared_hostings_total = 0
        self._shared_hosted_keys: set = set()   # live (target, key) pairs
        # (n_active_slots, wall_seconds, capacity_frac) per engine step that
        # decoded; capacity_frac < 1.0 marks steps served while some
        # instance ran degraded (a shard loss caps its slots)
        self.step_samples: List[tuple] = []
        # the degraded-layout census's inputs, made on the first shard
        # fault: the serving mesh and the decode cache's shapes
        self._shard_mesh: Optional[dict] = None
        self._cache_struct: Optional[dict] = None

    def _make_instance(self, instance_id: int) -> RealInstance:
        return RealInstance(self.cfg, self.params, self.ecfg, instance_id,
                            executor=self.executor, clock=self.clock,
                            device=self.device, role=self.roles[instance_id])

    # -- replication traffic accounting (shipped = bytes that LANDED) ---------
    @property
    def repl_blocks_total(self) -> int:
        return self.transport.shipped["repl"].blocks

    @property
    def repl_bytes_total(self) -> int:
        return self.transport.shipped["repl"].bytes

    @property
    def repl_shared_copies_total(self) -> int:
        return self.transport.shipped["repl"].shared_copies

    # state blobs ride only with the hybrid family, not ported yet
    repl_blobs_total = 0
    repl_blobs_staged = 0

    @property
    def repl_blocks_staged(self) -> int:
        return self.transport.staged["repl"].blocks

    @property
    def repl_bytes_staged(self) -> int:
        return self.transport.staged["repl"].bytes

    @property
    def repl_bytes_dropped(self) -> int:
        return self.transport.dropped["repl"].bytes

    @property
    def _pending_ship(self) -> List[dict]:
        return self.transport.pending

    def submit(self, req: Request):
        self.waiting.append(req)

    # -- dynamic traffic rerouting (LB) ---------------------------------------
    def _load(self, inst: RealInstance) -> int:
        """Instance load as the LB sees it: active slots + queued depth."""
        return len(inst.requests) + len(self.queues[inst.instance_id])

    def _admit_targets(self) -> List[RealInstance]:
        """Instances that accept NEW work. With disaggregation, arrivals go
        to prefill-role instances only (decode instances receive requests
        by handoff, not admission); if every prefill-role instance is dead
        the survivors serve colocated — roles are soft."""
        alive = [i for i in self.instances if i.alive]
        if not self.ecfg.disaggregate:
            return alive
        return [i for i in alive if i.role == "prefill"] or alive

    def _route(self, req: Request, front: bool = False):
        """Place the request on the least-loaded admitting instance's queue
        (front=True keeps requeued work ahead of later arrivals)."""
        alive = self._admit_targets()
        if not alive:
            self.waiting.insert(0, req) if front else self.waiting.append(req)
            return
        tgt = self.control.routing.pick(alive, self._load)
        req.instance_id = tgt.instance_id
        q = self.queues[tgt.instance_id]
        q.insert(0, req) if front else q.append(req)

    def queued_requests(self) -> List[Request]:
        """Requests routed to an instance but not yet admitted."""
        return [r for q in self.queues.values() for r in q]

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

    @property
    def _pending_rejoins(self) -> List[tuple]:
        """(instance_id, ready_at) recoveries scheduled — a read view over
        the recovery planner."""
        return self.control.planner.pending_rejoins()

    def _ring_target(self, instance_id: int) -> int:
        return self.control.placement.target(instance_id, self.control.view)

    def step(self) -> int:
        """One engine iteration: rejoin a due spare, route + admit, decode
        everywhere, replicate deltas. Returns the number of requests that
        made forward progress (0 while stalled or idle)."""
        self.t = self.clock() if self.clock is not None else self.t + 1.0
        _t0 = time.perf_counter()
        # async shipping: flush the PREVIOUS step's staged jobs (replica
        # deltas AND handoff pages) before anything here mutates the pools,
        # then seat any handoff whose final pages landed
        self.flush_replication()
        if self._handoffs:
            self._complete_handoffs()
        # at most one due recovery per step, earliest failure first; the
        # plan interleaves both granularities: a shard rejoin restores the
        # full layout in place, an instance rejoin brings back a warm spare
        due = self.control.planner.next_due(self.t)
        if due is not None:
            if self.control.planner.pending_kind(due) == "shard":
                self.rejoin_shards(due)
            else:
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
        # headroom (free slots and pool pages are separate limits; under
        # disaggregation only prefill-capable peers take overflow)
        overflow = self._admit_targets()
        for inst in alive:
            q = self.queues[inst.instance_id]
            if not q:
                continue
            for other in self.control.routing.order(overflow, self._load):
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
            if inst.handoff_mode:
                # stream every page the chunks just finished writing (and
                # the whole remainder for prompts whose final chunk ran); a
                # decode-role instance serving colocated never streams
                self._stage_handoffs(inst)
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
        if self._handoffs and not self.ecfg.repl_async:
            # synchronous shipping: the handoff pages staged this step ship
            # now — seat now instead of waiting for the next step's flush
            self.flush_replication(block=True)
            self._complete_handoffs()
        if n_active:
            # the fleet's serving-capacity fraction this step: degraded
            # instances cap below max_slots
            cap = sum(i.slot_cap for i in alive)
            cap_frac = cap / max(len(self.instances) * self.ecfg.max_slots, 1)
            self.step_samples.append(
                (n_active, time.perf_counter() - _t0, cap_frac))
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

    def _commit_shared_hostings(self, tgt_id: int, grown):
        """Account one growth's shared-page hostings: refcounts per
        reference; hosting events per NEW (target, key) membership — the
        ship-ratio denominator."""
        for key in grown.shared_keys:
            self.repl_shared_refs_total += 1
            if (tgt_id, key) not in self._shared_hosted_keys:
                self._shared_hosted_keys.add((tgt_id, key))
                self.repl_shared_hostings_total += 1

    def _stage_replication(self):
        full = self.ecfg.replication == "full"
        pc = self.ecfg.prefix_cache
        for inst in self.instances:
            if not inst.alive:
                continue
            tgt_id = self._ring_target(inst.instance_id)
            if tgt_id < 0:
                continue
            tgt = self.instances[tgt_id]
            src_slots: List[int] = []
            dst_slots: List[int] = []
            shared_copies = 0
            for rid, req in inst.requests.items():
                # mid-chunked-prefill requests have no complete page set to
                # resume from: their pages ship once they enter DECODE
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
                # retires keep the hosted table in lockstep with the live
                # window; if it ever drifts (or a shared page went private),
                # drop it and re-host the current window
                reconcile_replica(inst.pool, tgt.pool, inst.instance_id,
                                  rid, table, prefix_cache=pc)
                rtab = tgt.pool.replica_table(inst.instance_id, rid)
                if len(table) > len(rtab):
                    grown = host_table_growth(
                        inst.pool, tgt.pool, inst.instance_id, rid, table,
                        prefix_cache=pc)
                    if grown is None:
                        continue   # no headroom on target; retry next pass
                    self._commit_shared_hostings(tgt_id, grown)
                    for s, d in grown.copies:
                        src_slots.append(s)
                        dst_slots.append(d)
                    shared_copies += len(grown.copies)
                    rtab = tgt.pool.replica_table(inst.instance_id, rid)
                # copy when the primary block is dirty OR the hosted block
                # has never received content (fresh hosting)
                s, d = collect_dirty(tgt.pool, table, rtab, full=full,
                                     prefix_cache=pc)
                src_slots += s
                dst_slots += d
                self.replica_meta[rid] = {
                    "peer": inst.instance_id, "home": tgt_id,
                    "pos": int(inst.slot_pos[inst.slot_of(rid)]),
                    "tokens": list(req.output_tokens),
                }
                req.replicated_through = req.total_len
            if src_slots:
                self.transport.stage("repl", inst.instance_id, tgt_id,
                                     (src_slots, dst_slots),
                                     shared_copies=shared_copies)

    # -- prefill/decode disaggregation (handoff stream) ------------------------
    def _pick_decode_target(self, src_id: int) -> Optional[int]:
        """Least-loaded alive decode-role instance (any other alive peer if
        no decode-role instance survives; None means seat locally — the
        colocated fallback)."""
        cands = [i for i in self.instances
                 if i.alive and i.instance_id != src_id
                 and i.role != "prefill"]
        if not cands:
            cands = [i for i in self.instances
                     if i.alive and i.instance_id != src_id]
        if not cands:
            return None
        return min(cands,
                   key=lambda i: (len(i.requests), i.instance_id)).instance_id

    def _stage_handoffs(self, inst: RealInstance):
        """Stream ``inst``'s prefill output: every fully-covered prompt
        page written since the last pass is hosted on (and staged to) the
        decode target; a prompt whose final chunk just ran streams its
        whole remainder (partial tail page included) and is marked ready
        to seat once those bytes land."""
        for h in inst.drain_ready_handoffs():
            rec = self._handoffs.setdefault(
                h["req"].rid, {"src": inst.instance_id, "dst": None,
                               "req": h["req"], "gen": 0, "inflight": 0})
            rec.update(refs=h["refs"], logits=h["logits"], final=True,
                       slot=h["slot"], ready_to_seat=False)
        for job in inst.prefill_jobs.values():
            rid = job["req"].rid
            if rid not in self._handoffs:
                self._handoffs[rid] = {
                    "src": inst.instance_id, "dst": None, "req": job["req"],
                    "gen": 0, "inflight": 0, "final": False}
        for rec in list(self._handoffs.values()):
            if rec["src"] == inst.instance_id:
                self._stream_handoff(inst, rec)

    def _stream_handoff(self, inst: RealInstance, rec: dict):
        """Advance one handoff record: (re)pick the decode target, host +
        stage the pages that are ready but not yet hosted there, and flag
        the record seatable when the final message lands."""
        req = rec["req"]
        rid = req.rid
        if rec["dst"] is not None and not self.instances[rec["dst"]].alive:
            # decode target died before seating: hosted pages died with its
            # pool — re-target and re-stream from the source (which still
            # holds everything)
            rec.update(dst=None, inflight=0, ready_to_seat=False)
            rec["gen"] += 1
        if rec["dst"] is None:
            rec["dst"] = self._pick_decode_target(inst.instance_id)
        if rec["dst"] is None or rec["dst"] == inst.instance_id:
            # no peer to decode on: colocated fallback — the parked slot
            # seats right here once the final chunk has run
            if rec.get("final"):
                inst._seat(rec["slot"], req, rec["refs"], rec["logits"],
                           self.t)
                self.handoffs_seated += 1
                del self._handoffs[rid]
            return
        dst = self.instances[rec["dst"]]
        if rec.get("final"):
            refs, ready = rec["refs"], len(rec["refs"])
        else:
            job = inst.prefill_jobs.get(inst.slot_of(rid))
            if job is None:
                return
            refs, ready = job["refs"], job["pages_written"]
        pc = self.ecfg.prefix_cache
        reconcile_replica(inst.pool, dst.pool, inst.instance_id, rid,
                          refs[:ready], prefix_cache=pc)
        rtab = dst.pool.replica_table(inst.instance_id, rid)
        src_slots: List[int] = []
        dst_slots: List[int] = []
        shared_copies = 0
        if ready > len(rtab):
            grown = host_table_growth(inst.pool, dst.pool, inst.instance_id,
                                      rid, refs[:ready], prefix_cache=pc)
            if grown is None:
                return      # no headroom on the target yet; retry next step
            self._commit_shared_hostings(rec["dst"], grown)
            for s, d in grown.copies:
                src_slots.append(s)
                dst_slots.append(d)
            shared_copies = len(grown.copies)
            rtab = dst.pool.replica_table(inst.instance_id, rid)
        # fresh private hostings carry rref.replicated == False — the same
        # dirty walk replication uses picks exactly those up
        s, d = collect_dirty(dst.pool, refs[:ready], rtab, full=False,
                             prefix_cache=pc)
        src_slots += s
        dst_slots += d
        if src_slots:
            gen = rec["gen"]

            def landed(rec=rec, gen=gen):
                if rec["gen"] == gen:
                    rec["inflight"] -= 1
            rec["inflight"] += 1
            self.transport.stage(
                "handoff", inst.instance_id, rec["dst"],
                (src_slots, dst_slots), shared_copies=shared_copies,
                on_shipped=landed)
        if rec.get("final") and len(rtab) == len(refs):
            rec["ready_to_seat"] = True

    def _complete_handoffs(self):
        """Seat every handoff whose final pages have landed on a live
        decode target, then release the prefill side's parked slot (its
        pages stay warm in the source's prefix index)."""
        for rid, rec in list(self._handoffs.items()):
            if not (rec.get("ready_to_seat") and rec.get("inflight", 0) == 0):
                continue
            dst = self.instances[rec["dst"]]
            if not dst.alive:
                continue    # re-targeted by the next stream pass
            if not dst.seat_handoff(rec["src"], rec["req"]):
                continue    # no free slot on the target yet; retry
            self.handoffs_seated += 1
            src = self.instances[rec["src"]]
            if src.alive:
                src.finish_handoff(rid)
            del self._handoffs[rid]

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
            # replication landing on degraded targets (placement
            # deprioritizes them, so this stays near zero)
            "bytes_to_degraded":
                self.transport.shipped_degraded["repl"].bytes,
            "blocks_to_degraded":
                self.transport.shipped_degraded["repl"].blocks,
        }

    def disagg_stats(self) -> dict:
        """Disaggregation accounting: handoff stream traffic (same wire
        format as replication — check the bytes against block_nbytes) and
        seat/resume counts for the /health endpoint."""
        shipped = self.transport.shipped["handoff"]
        return {
            "enabled": self.ecfg.disaggregate,
            "roles": {i.instance_id: i.role for i in self.instances},
            "handoffs_in_flight": len(self._handoffs),
            "handoffs_seated": self.handoffs_seated,
            "handoff_streams_resumed": self.handoff_streams_resumed,
            "handoff_blocks_total": shipped.blocks,
            # state blobs ride only with the hybrid family, not ported yet
            "handoff_blobs_total": 0,
            "handoff_bytes_total": shipped.bytes,
            "handoff_shared_zero_copy_pages":
                self.repl_shared_refs_total - shipped.shared_copies
                - self.transport.shipped["repl"].shared_copies,
        }

    def prefix_stats(self) -> dict:
        """Prefix-cache effectiveness: hit rate over admitted prompt
        tokens, prefill compute actually run, CoW/eviction churn, and the
        shared-page replication dedup ratio (copies per distinct (target,
        chain key) hosting — 1.0 means every shared page shipped exactly
        once per target)."""
        insts = self.instances
        total = sum(i.prefill_total_tokens for i in insts)
        compute = sum(i.prefill_compute_tokens for i in insts)
        cached = sum(i.prefix_cached_tokens for i in insts)
        return {
            "enabled": self.ecfg.prefix_cache,
            "prefill_total_tokens": total,
            "prefill_compute_tokens": compute,
            "prefix_cached_tokens": cached,
            "hit_rate": cached / max(total, 1),
            "lookups": sum(i.pool.prefix_lookups for i in insts),
            "interned_pages":
                sum(i.pool.prefix_interned_pages for i in insts),
            "hosted_pages": sum(i.pool.prefix_hosted_pages for i in insts),
            "evicted_pages":
                sum(i.pool.prefix_evicted_pages for i in insts),
            "cow_copies": sum(i.pool.cow_copies for i in insts),
            "shared_replica_refs": self.repl_shared_refs_total,
            "shared_replica_copies": self.repl_shared_copies_total,
            # denominator is the monotone hosting COUNTER, not the live key
            # set: a target that failed and rejoined re-hosts (and
            # re-ships) the same keys, and both sides must see that
            "shared_page_ship_ratio":
                self.repl_shared_copies_total
                / max(self.repl_shared_hostings_total, 1),
        }

    def _handoffs_on_fail(self, instance_id: int, victims, resumed, event,
                          standard: bool):
        """Failover for in-flight prefill→decode handoffs.

        A dead DECODE target costs nothing: the source still holds every
        page, so the record re-targets and re-streams on the next pass. A
        dead PREFILL source resumes on the instance its stream already
        landed on — seated outright if the final chunk had arrived,
        otherwise prefill restarts from the last fully streamed page
        (chunk-aligned) instead of from token zero. Returns the victims
        list with handoff requests (handled here) removed."""
        handled = set()
        for rid, rec in list(self._handoffs.items()):
            if rec["dst"] == instance_id:
                rec.update(dst=None, inflight=0, ready_to_seat=False)
                rec["gen"] += 1
            if rec["src"] != instance_id:
                continue
            req = rec["req"]
            handled.add(rid)
            dst = None if rec["dst"] is None else self.instances[rec["dst"]]
            ok = False
            if not standard and dst is not None and dst.alive:
                if rec.get("ready_to_seat") and rec.get("inflight", 0) == 0:
                    ok = dst.seat_handoff(instance_id, req)
                    if ok:
                        self.handoffs_seated += 1
                else:
                    ok = dst.adopt_prefill_stream(instance_id, req)
                    if ok:
                        self.handoff_streams_resumed += 1
                if not ok:
                    dst.pool.drop_replica(instance_id, rid)
            if ok:
                resumed.append(rid)
                event["resumed"] += 1
            else:
                req.restart()
                req.state = RequestState.QUEUED
                event["restarted"] += 1
                self._route(req, front=True)
            del self._handoffs[rid]
        return [r for r in victims if r.rid not in handled]

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
            return self._apply_shard_fault(spec.instance_id, spec.shard_idx)
        return self._apply_instance_fault(spec.instance_id)

    def recover(self, spec: FaultSpec):
        """THE recovery entry point (``POST /v1/admin/recover``): instance
        granularity rebuilds the warm spare, shard granularity restores a
        degraded instance's lost shards in place. State conflicts —
        rejoining an alive instance, restoring shards of an instance that
        lost none — raise ValueError (HTTP 409)."""
        spec.validate(len(self.instances), self.ecfg.n_shards,
                      for_recover=True)
        if spec.granularity == "shard":
            return self._recover_shards(spec.instance_id)
        return self._recover_instance(spec.instance_id)

    def fail_instance(self, instance_id: int) -> List[int]:
        """Kill a whole instance (thin wrapper over ``apply_fault``)."""
        return self.apply_fault(
            FaultSpec(granularity="instance", instance_id=instance_id))

    def fail_shard(self, instance_id: int, shard_idx: int) -> List[int]:
        """Lose ONE shard of an instance (thin wrapper over
        ``apply_fault``): the instance degrades instead of dying."""
        return self.apply_fault(
            FaultSpec(granularity="shard", instance_id=instance_id,
                      shard_idx=shard_idx))

    def rejoin_instance(self, instance_id: int) -> RealInstance:
        """Warm-spare rejoin (thin wrapper over ``recover``)."""
        return self.recover(
            FaultSpec(granularity="instance", instance_id=instance_id))

    def rejoin_shards(self, instance_id: int) -> RealInstance:
        """Restore a degraded instance's lost shards (thin wrapper over
        ``recover``)."""
        return self.recover(
            FaultSpec(granularity="shard", instance_id=instance_id))

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
        if self._handoffs:
            victims = self._handoffs_on_fail(instance_id, victims, resumed,
                                             event, standard)
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
        # the dead pool's interned pages died with it: forget its hosting
        # keys so a re-host after rejoin counts as a fresh hosting AND a
        # fresh copy — the ship-ratio denominator tracks live state
        self._shared_hosted_keys = {
            (t, k) for (t, k) in self._shared_hosted_keys
            if t != instance_id}
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

    def _apply_shard_fault(self, instance_id: int,
                           shard_idx: int) -> List[int]:
        """Lose ONE tensor-parallel shard: the instance DEGRADES instead of
        dying. Slot capacity drops to the surviving fraction and only the
        EXCESS in-flight requests migrate — released here (the pool
        survives, so the seat frees cleanly), then resumed from their
        promoted replica on the ring home, or restarted where none is
        hosted. The ClusterView marks the instance DEGRADED with its own
        epoch bump, so placement stops preferring it as a replica host and
        routing discounts it. Under ``standard`` recovery — or on the LAST
        surviving shard — the fault escalates to whole-instance failure.
        Returns the rids that resumed seamlessly."""
        inst = self.instances[instance_id]
        if not inst.alive:
            raise ValueError(
                f"instance {instance_id} is dead — recover it at instance "
                "granularity before injecting shard faults")
        if shard_idx in inst.lost_shards:
            return []      # idempotent retry (e.g. an HTTP retry)
        if self.ecfg.recovery == "standard" or \
                len(inst.lost_shards) + 1 >= inst.n_shards:
            return self._apply_instance_fault(instance_id)
        if self.clock is not None:
            self.t = self.clock()       # admin-thread call: stamp it now
        # the last step's staged deltas land on the ring hosts before any
        # excess victim resumes from its promoted replica
        self.flush_replication()
        victims = inst.degrade(shard_idx)
        inst.degraded_layout = self._degradation_layout(inst.lost_shards)
        self.control.view.mark_degraded(instance_id, shard_idx)
        event = {"instance": instance_id, "granularity": "shard",
                 "shard_idx": shard_idx, "mode": self.ecfg.recovery,
                 "t_fail": self.t, "n_victims": len(victims),
                 "requeued": 0, "resumed": 0, "restarted": 0,
                 "t_rejoin": -1.0, "mttr": -1.0}
        self.failure_events.append(event)
        # in-flight handoff streams keep their parked prefill slot — the
        # shards serving the stream survived; only seated work re-seats
        victims = [r for r in victims if r.rid not in self._handoffs]
        resumed: List[int] = []
        restarted: List[Request] = []
        for req in victims:
            meta = self.replica_meta.pop(req.rid, None)
            inst.release(req.rid)
            target = None
            if meta is not None and self.instances[meta["home"]].alive:
                target = self.instances[meta["home"]]
            if target is not None and \
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
        for req in reversed(restarted):
            self._route(req, front=True)
        rejoin_at = self.t + self.ecfg.rejoin_delay \
            if self.ecfg.auto_rejoin else None
        self.control.planner.on_failure(instance_id, self.t,
                                        rejoin_at=rejoin_at, kind="shard")
        return resumed

    def _degradation_layout(self, lost_shards) -> dict:
        """The layout of serving on the surviving slice, through the
        sharding rules in ``distributed/sharding.py``: specs re-derived
        over a model axis shrunk to the surviving shard count, with
        replicate-fallback wherever divisibility broke. The mesh and the
        cache's shapes are made once per engine."""
        if self._shard_mesh is None:
            self._shard_mesh = SH.mesh(self.ecfg.n_shards)
            self._cache_struct = SH.decode_cache_shape(
                self.cfg, self.ecfg.max_slots, self.ecfg.max_seq)
        return SH.degradation_summary(
            self.params, self._shard_mesh, lost_shards,
            cache_shape=self._cache_struct, arch_type=self.cfg.arch_type)

    def _recover_shards(self, instance_id: int) -> RealInstance:
        """Shard rejoin: restore the full layout and slot capacity in place
        — the surviving-shard state is untouched, so every request that
        rode out the degradation resumes byte-identically. The flush
        barrier mirrors the fault side: the epoch bump below re-targets the
        ring, and staged copies land against the topology they were staged
        under."""
        inst = self.instances[instance_id]
        if not inst.alive:
            raise ValueError(
                f"instance {instance_id} is dead — recover it at instance "
                "granularity")
        if not inst.lost_shards:
            raise ValueError(f"instance {instance_id} is not degraded")
        if self.clock is not None:
            self.t = self.clock()
        self.flush_replication()
        inst.restore_shards()
        self.control.view.mark_restored(instance_id)
        self.control.planner.on_rejoined(instance_id, self.t)
        # every open shard event closes: the restore brings back ALL lost
        # shards at once
        for event in self.failure_events:
            if event["instance"] == instance_id and \
                    event["granularity"] == "shard" and \
                    event["t_rejoin"] < 0:
                event["t_rejoin"] = self.t
                event["mttr"] = self.t - event["t_fail"]
        return inst

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
        # fresh pool, no hosted keys (the fault already pruned them)
        self._shared_hosted_keys = {
            (t, k) for (t, k) in self._shared_hosted_keys
            if t != instance_id}
        for event in reversed(self.failure_events):
            if event["instance"] == instance_id and \
                    event["granularity"] == "instance" and \
                    event["t_rejoin"] < 0:
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
