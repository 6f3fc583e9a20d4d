"""Staged block/blob transport between instance pools.

One channel carries BOTH inter-instance byte streams the engine owns —
ring KV replication (``"repl"``) and the prefill→decode handoff stream
(``"handoff"``, ``EngineConfig.disaggregate``) — because they are the same
wire format: paged KV blocks (int8 payload + scales on a quantized pool)
and the hybrid family's RG-LRU state blobs, addressed by pool slot. The
channel is an async double buffer:

  * ``stage`` records a copy job (metadata only — slot id lists) tagged
    with its kind at the end of step N;
  * ``flush`` ships every staged job at the top of step N+1 (or at the
    fail/rejoin barrier).

Copies run on the current CUDA stream, so they are ordered after the work
that wrote the source pages and before anything queued later — a decode
that mutates them, or a handoff seat that reads them; a side stream would
need events against both (later work).

Byte accounting is split by when the bytes become REAL: ``staged[kind]``
tallies at stage time; ``shipped[kind]`` at flush time and only for jobs
whose target is still alive — a job whose target died between stage and
flush lands in ``dropped[kind]`` instead, so shipped totals never count
bytes that never landed.

``host_table_growth`` grows a target's hosted table to cover the source
table, shared prefix pages through ``PagedKVPool.host_shared_block`` (the
target interns them by chain key, so a page ships at most once per target).
It is ALL-OR-NOTHING: if the target runs out of headroom mid-request, every
hosting the call made is rolled back (shared pages deref'd, pages interned
by this very call evicted, private slots freed) and the caller retries next
pass.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import torch

KINDS = ("repl", "handoff")


@dataclasses.dataclass
class Tally:
    """Byte/message accounting for one (kind, outcome) bucket."""
    msgs: int = 0
    blocks: int = 0
    blobs: int = 0
    bytes: int = 0
    shared_copies: int = 0

    def add(self, msg: dict):
        self.msgs += 1
        self.blocks += len(msg["blocks"][0])
        self.blobs += len(msg["blobs"][0])
        self.bytes += msg["nbytes"]
        self.shared_copies += msg["shared_copies"]


@dataclasses.dataclass
class Growth:
    """Result of one all-or-nothing ``host_table_growth`` call. Carries
    enough to undo itself: the caller rolls back when a LATER hosting step
    of the same request fails (no blob headroom on a hybrid), so staging
    stays all-or-nothing per request."""
    copies: List[tuple]            # (src_slot, dst_slot) shared pages to ship
    shared_keys: List[bytes]       # chain key per shared-page hosting
    n_hosted: int = 0              # blocks this call appended to the table
    fresh_keys: List[bytes] = dataclasses.field(default_factory=list)
    flag_saves: List[tuple] = dataclasses.field(default_factory=list)

    def rollback(self, dst_pool, peer: int, rid: int):
        """Undo every hosting this growth made: shared pages deref'd
        (pages interned BY this growth — bytes never shipped — are fully
        evicted), private slots freed, source dirty flags restored."""
        dst_pool.unhost_tail(peer, rid, self.n_hosted,
                             fresh_keys=self.fresh_keys)
        for ref, prior in self.flag_saves:
            ref.replicated = prior
        self.copies.clear()
        self.shared_keys.clear()
        self.n_hosted = 0


class TransportChannel:
    """Double-buffered block/blob transport over a live instance list.

    ``instances`` is the engine's OWN list (not a copy): a rejoin that
    replaces an instance object is visible to the next flush, and a dead
    target is skipped — its hosted slots died with its pool, so shipping
    would scribble on a future pool's blocks. Liveness resolves through the
    control plane's ``ClusterView`` when one is supplied, else through the
    instance objects' own flags."""

    def __init__(self, instances: list, view=None):
        self.instances = instances
        self.view = view
        self.pending: List[dict] = []
        self.staged: Dict[str, Tally] = {k: Tally() for k in KINDS}
        self.shipped: Dict[str, Tally] = {k: Tally() for k in KINDS}
        self.dropped: Dict[str, Tally] = {k: Tally() for k in KINDS}
        # subset of shipped: jobs whose target was serving DEGRADED at
        # flush time (shard loss); placement deprioritizes degraded ring
        # targets, so this stays near zero
        self.shipped_degraded: Dict[str, Tally] = {k: Tally() for k in KINDS}

    def stage(self, kind: str, src_id: int, dst_id: int, blocks,
              blobs=((), ()),
              shared_copies: int = 0, on_shipped=None) -> dict:
        """Queue one copy job: ``blocks`` and ``blobs`` are (src_slots,
        dst_slots) pairs addressing the source / target pools' blocks and
        blobs. ``on_shipped`` (if given)
        fires when the job's bytes land — never when the job is dropped
        for a dead target."""
        src_pool = self.instances[src_id].pool
        msg = {"src": src_id, "dst": dst_id, "blocks": blocks,
               "blobs": blobs, "kind": kind, "shared_copies": shared_copies,
               "nbytes": len(blocks[0]) * src_pool.block_nbytes
               + len(blobs[0]) * src_pool.blob_nbytes,
               "on_shipped": on_shipped}
        self.pending.append(msg)
        self.staged[kind].add(msg)
        return msg

    def flush(self, block: bool = False, exclude: Optional[int] = None):
        """Ship every staged job now — the double-buffer's barrier. A job
        whose target died since staging (or is ``exclude`` — the instance a
        failover is about to kill) is dropped and accounted as such. With
        ``block`` the call returns once the copies are complete on the
        device."""
        pending, self.pending = self.pending, []
        shipped = []
        for msg in pending:
            dst = self.instances[msg["dst"]]
            dst_alive = (self.view.is_alive(msg["dst"])
                         if self.view is not None else dst.alive)
            if not dst_alive or msg["dst"] == exclude:
                self.dropped[msg["kind"]].add(msg)
                continue
            src = self.instances[msg["src"]]
            src.pool.copy_blocks_to(dst.pool, *msg["blocks"])
            src.pool.copy_blobs_to(dst.pool, *msg["blobs"])
            self.shipped[msg["kind"]].add(msg)
            if self.view is not None and self.view.is_degraded(msg["dst"]):
                self.shipped_degraded[msg["kind"]].add(msg)
            if msg["on_shipped"] is not None:
                msg["on_shipped"]()
            shipped.append(dst)
        if block and any(d.pool.real and d.pool.k.is_cuda for d in shipped):
            torch.cuda.synchronize()


def reconcile_replica(src_pool, dst_pool, peer: int, rid: int, table,
                      prefix_cache: bool):
    """Drop a hosted table that drifted out of lockstep with the live one:
    the ring target changed after a failure, or copy-on-write turned a
    shared page private since hosting. The caller re-hosts the current
    window with matching sharedness."""
    rtab = dst_pool.replica_table(peer, rid)
    if any(a.logical_idx != b.logical_idx
           or (prefix_cache and src_pool.prefix_key_of(a.slot)
               != dst_pool.prefix_key_of(b.slot))
           for a, b in zip(table, rtab)):
        dst_pool.drop_replica(peer, rid)


def host_table_growth(src_pool, dst_pool, peer: int, rid: int, table,
                      prefix_cache: bool) -> Optional[Growth]:
    """Grow dst_pool's hosted table for (peer, rid) to cover ``table``.

    Shared prefix pages go through ``host_shared_block`` — the target
    interns them in ITS OWN index keyed by chain hash, so bytes ship only
    if no page with that key is already resident there. Private pages
    reserve a fresh hosted slot each (``replicated`` False, so the caller's
    dirty walk ships their bytes).

    ALL-OR-NOTHING: returns the Growth on success; on target-headroom
    exhaustion every hosting this call made is rolled back and None is
    returned — the caller retries next pass."""
    rtab = dst_pool.replica_table(peer, rid)
    grown = Growth(copies=[], shared_keys=[])
    target = len(table) - len(rtab)
    for ref in table[len(rtab):]:
        key = src_pool.prefix_key_of(ref.slot) if prefix_cache else None
        if key is not None:
            res = dst_pool.host_shared_block(
                peer, rid, src_pool.prefix_index[key], ref.logical_idx)
            if res is None:
                break
            rref, needs_copy = res
            grown.shared_keys.append(key)
            if needs_copy:
                grown.copies.append((ref.slot, rref.slot))
                grown.fresh_keys.append(key)
            grown.flag_saves.append((ref, ref.replicated))
            ref.replicated = True
            rref.replicated = True
        elif not dst_pool.host_replica(peer, rid, 1,
                                       first_logical=ref.logical_idx):
            break
        grown.n_hosted += 1
    if grown.n_hosted == target:
        return grown
    grown.rollback(dst_pool, peer, rid)
    return None


def collect_dirty(dst_pool, table, rtab, full: bool, prefix_cache: bool):
    """Walk a (primary, hosted) table pair and pick the blocks whose bytes
    must ride the wire: primary dirty since the last pass, or hosted slot
    never filled (fresh hosting). Immutable shared pages ship at host time
    only — never per referencing request, even in full mode. Marks both
    sides replicated; returns (src_slots, dst_slots)."""
    src_slots, dst_slots = [], []
    for ref, rref in zip(table, rtab):
        if prefix_cache and dst_pool.prefix_key_of(rref.slot) is not None:
            continue
        if full or not ref.replicated or not rref.replicated:
            src_slots.append(ref.slot)
            dst_slots.append(rref.slot)
            ref.replicated = True
            rref.replicated = True
    return src_slots, dst_slots
