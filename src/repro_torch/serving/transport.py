"""Staged block transport between instance pools: the ring KV replication
stream, as an async double buffer.

  * ``stage`` records a copy job (metadata only — slot id lists) at the end
    of step N;
  * ``flush`` ships every staged job at the top of step N+1 (or at the
    fail/rejoin barrier).

Copies run on the current CUDA stream, so they are ordered after the decode
that wrote the source pages and before the next decode that mutates them;
a side stream would need events against that decode (later work).

Byte accounting is split by when the bytes become REAL: ``staged`` tallies
at stage time; ``shipped`` at flush time and only for jobs whose target is
still alive — a job whose target died between stage and flush lands in
``dropped`` instead, so shipped totals never count bytes that never landed.

``host_table_growth`` grows a target's hosted table to cover the source
table ALL-OR-NOTHING: if the target runs out of headroom mid-request, every
hosting the call made is rolled back and the caller retries next pass.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import torch


@dataclasses.dataclass
class Tally:
    """Byte/message accounting for one outcome bucket."""
    blocks: int = 0
    bytes: int = 0

    def add(self, msg: dict):
        self.blocks += len(msg["blocks"][0])
        self.bytes += msg["nbytes"]


class TransportChannel:
    """Double-buffered block transport over a live instance list.

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
        self.staged = Tally()
        self.shipped = Tally()
        self.dropped = Tally()

    def stage(self, src_id: int, dst_id: int, blocks) -> dict:
        """Queue one copy job: ``blocks`` is a (src_slots, dst_slots) pair
        addressing the source / target pools."""
        src_pool = self.instances[src_id].pool
        msg = {"src": src_id, "dst": dst_id, "blocks": blocks,
               "nbytes": len(blocks[0]) * src_pool.block_nbytes}
        self.pending.append(msg)
        self.staged.add(msg)
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
                self.dropped.add(msg)
                continue
            src = self.instances[msg["src"]]
            src.pool.copy_blocks_to(dst.pool, *msg["blocks"])
            self.shipped.add(msg)
            shipped.append(dst)
        if block and any(d.pool.real and d.pool.k.is_cuda for d in shipped):
            torch.cuda.synchronize()


def reconcile_replica(dst_pool, peer: int, rid: int, table):
    """Drop a hosted table that drifted out of lockstep with the live one
    (the ring target changed after a failure); the caller re-hosts the
    current window."""
    rtab = dst_pool.replica_table(peer, rid)
    if any(a.logical_idx != b.logical_idx for a, b in zip(table, rtab)):
        dst_pool.drop_replica(peer, rid)


def host_table_growth(dst_pool, peer: int, rid: int, table) -> bool:
    """Grow dst_pool's hosted table for (peer, rid) to cover ``table``, one
    fresh slot per missing page (``replicated`` False, so the caller's dirty
    walk ships its bytes). ALL-OR-NOTHING: on target-headroom exhaustion
    every hosting this call made is rolled back and False is returned."""
    missing = table[len(dst_pool.replica_table(peer, rid)):]
    for n, ref in enumerate(missing):
        if not dst_pool.host_replica(peer, rid, 1,
                                     first_logical=ref.logical_idx):
            if n:
                dst_pool.unhost_tail(peer, rid, n)
            return False
    return True


def collect_dirty(table, rtab, full: bool):
    """Walk a (primary, hosted) table pair and pick the blocks whose bytes
    must ride the wire: primary dirty since the last pass, or hosted slot
    never filled (fresh hosting). Marks both sides replicated; returns
    (src_slots, dst_slots)."""
    src_slots, dst_slots = [], []
    for ref, rref in zip(table, rtab):
        if full or not ref.replicated or not rref.replicated:
            src_slots.append(ref.slot)
            dst_slots.append(rref.slot)
            ref.replicated = True
            rref.replicated = True
    return src_slots, dst_slots
