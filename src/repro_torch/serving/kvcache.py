"""Block-paged KV cache pool — the paper's KV representation (Sec 3.2 #3:
"KevlarFlow uses a block representation of KV cache and replicates it
block-by-block in the background").

Blocks are the unit of allocation, replication and memory-pressure
eviction. The pool carries real torch buffers on its device when an engine
runs real compute, or pure metadata otherwise — the allocation/replication
logic is identical.

The pool is unquantized, or int8 with per-(layer, head, token) scales
(``quantized=True``). This port has no prefix cache or state blobs yet;
those arrive with the engine knobs that need them.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.kernels.paged_attention_int8 import (SCALE_DTYPE,
                                                      dequantize_pages,
                                                      quantize_pages)


@dataclasses.dataclass
class BlockRef:
    """A (request, logical block index) -> physical slot mapping entry."""
    rid: int
    logical_idx: int
    slot: int
    n_filled: int = 0          # tokens currently valid in this block
    replicated: bool = False   # safely copied to the replica target?


class PagedKVPool:
    """Fixed-size pool of KV blocks with a free list.

    Layout (real mode): k/v tensors in the paged-attention kernel's native
    layout with a stacked-layer axis,
      (n_layers, n_kv_heads, n_blocks, page_size, head_dim)
    so one block (an n_blocks-axis slot) spans all layers — the replication
    unit — and each layer's (K, P, page, D) view feeds the kernel directly.

    int8 mode (``quantized=True``): k/v are int8 with symmetric scales in
    (n_layers, n_kv_heads, n_blocks, page_size, 1) SCALE_DTYPE side tensors
    ``k_scale``/``v_scale`` (None on an unquantized pool). Block writes
    quantize; replication ships the int8 bytes and scales verbatim, so a
    promoted replica is bit-identical on the quantized representation.
    """

    def __init__(self, n_blocks: int, page_size: int, n_layers: int = 0,
                 n_kv_heads: int = 0, head_dim: int = 0, real: bool = False,
                 dtype=torch.bfloat16, window: int = 0, device="cuda",
                 quantized: bool = False):
        self.n_blocks = n_blocks
        self.page_size = page_size
        self.real = real
        self.quantized = quantized
        # sliding-window ring view: when window > 0 each request keeps only
        # the blocks that can still fall inside the attention window; blocks
        # fully below it are recycled. BlockRef.logical_idx is the ABSOLUTE
        # logical page index, so a table is a contiguous ascending run.
        self.window = window
        # pages recycled INSIDE allocate's windowed pressure fallback: the
        # engine drains these into retire messages for the replica host
        self.pending_recycles: List[BlockRef] = []
        self._free: List[int] = list(range(n_blocks))
        self._tables: Dict[int, List[BlockRef]] = {}      # rid -> blocks
        # replica blocks hosted on behalf of peers: (peer_node, rid) -> slots
        self._replica_tables: Dict[Tuple[int, int], List[BlockRef]] = {}
        self.k_scale = self.v_scale = None
        if real:
            shape = (n_layers, n_kv_heads, n_blocks, page_size, head_dim)
            if quantized:
                dtype = torch.int8
                # scale 1, so zeroed pages dequantize to exact zeros
                self.k_scale = torch.ones(shape[:-1] + (1,),
                                          dtype=SCALE_DTYPE, device=device)
                self.v_scale = torch.ones_like(self.k_scale)
            self.k = torch.zeros(shape, dtype=dtype, device=device)
            self.v = torch.zeros(shape, dtype=dtype, device=device)

    @property
    def block_nbytes(self) -> int:
        """Bytes of one replication message (k+v, all layers; an int8 pool
        ships its scale rows too)."""
        if not self.real:
            return 0
        tensors = [self.k] + ([self.k_scale] if self.quantized else [])
        return sum(2 * t.numel() // self.n_blocks * t.element_size()
                   for t in tensors)

    # -- capacity ----------------------------------------------------------
    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_used(self) -> int:
        return self.n_blocks - self.n_free

    def replica_blocks_used(self) -> int:
        return sum(len(t) for t in self._replica_tables.values())

    # -- primary allocation --------------------------------------------------
    def blocks_for_tokens(self, n_tokens: int) -> int:
        return -(-n_tokens // self.page_size)

    @property
    def window_pages(self) -> int:
        """Max resident pages per request under the ring view: the window
        can straddle a page boundary, hence ceil(window/page) + 1. 0 when
        the pool is unwindowed."""
        if not self.window:
            return 0
        return -(-self.window // self.page_size) + 1

    def resident_blocks_for(self, n_tokens: int) -> int:
        """Blocks a fresh n_tokens-long request occupies: all of them on an
        unwindowed pool, only the window-covering tail pages on a windowed
        one."""
        if n_tokens <= 0:
            return 0
        if not self.window:
            return self.blocks_for_tokens(n_tokens)
        first = max(0, n_tokens - self.window) // self.page_size
        return (n_tokens - 1) // self.page_size - first + 1

    def allocate(self, rid: int, n_tokens: int) -> List[BlockRef]:
        """Allocate blocks; raises MemoryError if full (caller should evict
        replicas first — the paper's pressure rule).

        Fresh rid: blocks for an n_tokens-long prompt (on a windowed pool
        only the pages intersecting the window of the next write position;
        logical indices start at the window's first page). Existing rid:
        appends blocks for n_tokens MORE tokens."""
        table = self._tables.get(rid)
        if table:
            start = table[-1].logical_idx + 1
            need = self.blocks_for_tokens(n_tokens)
            remaining = n_tokens
        else:
            start = (max(0, n_tokens - self.window) // self.page_size
                     if self.window else 0)
            need = self.resident_blocks_for(n_tokens)
            remaining = n_tokens - start * self.page_size
        if need > self.n_free and self.window:
            # windowed pools can be "full" while live requests still hold
            # head pages fully below their window: recycle those first, then
            # drop hosted replicas, and only then give up
            for r in list(self._tables):
                if self.n_free >= need:
                    break
                self.pending_recycles.extend(self.recycle_out_of_window(r))
            if need > self.n_free:
                self.evict_replicas_for_pressure(need)
        if need > self.n_free:
            raise MemoryError(f"pool exhausted: need {need}, free {self.n_free}")
        table = self._tables.setdefault(rid, [])
        refs = []
        for i in range(need):
            slot = self._free.pop()
            ref = BlockRef(rid, start + i, slot,
                           n_filled=min(self.page_size, max(0, remaining)))
            remaining -= ref.n_filled
            table.append(ref)
            refs.append(ref)
        return refs

    def append_token(self, rid: int) -> Optional[BlockRef]:
        """Account one generated token; allocates a new block on overflow.
        Returns the block that received the token."""
        table = self._tables.get(rid)
        if not table or table[-1].n_filled == self.page_size:
            refs = self.allocate(rid, 1)
            refs[0].n_filled = 1
            return refs[0]
        ref = table[-1]
        ref.n_filled += 1
        ref.replicated = False           # block changed; needs re-replication
        return ref

    def table(self, rid: int) -> List[BlockRef]:
        return self._tables.get(rid, [])

    def n_tokens(self, rid: int) -> int:
        """Resident tokens (== total tokens on an unwindowed pool)."""
        return sum(ref.n_filled for ref in self.table(rid))

    def abs_tokens(self, rid: int) -> int:
        """Absolute sequence length, including recycled (non-resident)
        prefix tokens: the last page's absolute span end."""
        table = self._tables.get(rid)
        if not table:
            return 0
        return table[-1].logical_idx * self.page_size + table[-1].n_filled

    def recycle_out_of_window(self, rid: int) -> List[BlockRef]:
        """Free head blocks that fall fully below the attention window of
        the NEXT write position (pos == abs_tokens). Returns the recycled
        refs so the engine can retire their hosted replicas on the ring
        peer. No-op on unwindowed pools."""
        table = self._tables.get(rid)
        if not self.window or not table:
            return []
        min_pos = max(0, self.abs_tokens(rid) + 1 - self.window)
        recycled = []
        while table and (table[0].logical_idx + 1) * self.page_size <= min_pos:
            ref = table.pop(0)
            self._free.append(ref.slot)
            recycled.append(ref)
        return recycled

    def drain_pending_recycles(self) -> List[BlockRef]:
        """Refs recycled inside ``allocate``'s windowed pressure fallback
        since the last drain (the caller still owes their retire messages)."""
        out, self.pending_recycles = self.pending_recycles, []
        return out

    def free(self, rid: int):
        for ref in self._tables.pop(rid, []):
            self._free.append(ref.slot)

    def live_requests(self) -> List[int]:
        return list(self._tables)

    # -- replica hosting -------------------------------------------------------
    def host_replica(self, peer: int, rid: int, n_blocks: int,
                     first_logical: Optional[int] = None) -> bool:
        """Reserve blocks for a peer's replicated request. Never raises:
        returns False if there is no headroom (peer will retry / drop).
        Grows an existing replica table incrementally. ``first_logical``
        pins the absolute logical page index of the first new block
        (default: continue the existing run, 0 for a fresh table)."""
        if n_blocks > self.n_free:
            return False
        table = self._replica_tables.setdefault((peer, rid), [])
        if first_logical is None:
            first_logical = table[-1].logical_idx + 1 if table else 0
        for i in range(n_blocks):
            slot = self._free.pop()
            table.append(BlockRef(rid, first_logical + i, slot,
                                  n_filled=self.page_size))
        return True

    def replica_table(self, peer: int, rid: int) -> List[BlockRef]:
        return self._replica_tables.get((peer, rid), [])

    def retire_replica_block(self, peer: int, rid: int,
                             logical_idx: int) -> bool:
        """The peer recycled primary page ``logical_idx`` out of its window:
        drop the hosted counterpart so the replica mirrors the live window.
        Tolerant no-op (False) when the block is not hosted."""
        table = self._replica_tables.get((peer, rid))
        if not table:
            return False
        for i, ref in enumerate(table):
            if ref.logical_idx == logical_idx:
                table.pop(i)
                self._free.append(ref.slot)
                return True
        return False

    def unhost_tail(self, peer: int, rid: int, n: int):
        """Undo the LAST ``n`` hosted blocks of (peer, rid) — the
        all-or-nothing staging rollback."""
        table = self._replica_tables.get((peer, rid), [])
        assert len(table) >= n, "unhosting more blocks than were hosted"
        for _ in range(n):
            self._free.append(table.pop().slot)
        if not table:
            self._replica_tables.pop((peer, rid), None)

    def drop_replica(self, peer: int, rid: int):
        for ref in self._replica_tables.pop((peer, rid), []):
            self._free.append(ref.slot)

    def evict_replicas_for_pressure(self, blocks_needed: int) -> int:
        """Paper: 'When memory pressure happens, KevlarFlow drops the
        replicated KV cache'. Evict whole replica tables until enough
        blocks are free. Returns blocks freed."""
        freed = 0
        for key in list(self._replica_tables):
            if self.n_free >= blocks_needed:
                break
            n = len(self._replica_tables[key])
            self.drop_replica(*key)
            freed += n
        return freed

    def promote_replica(self, peer: int, rid: int) -> List[BlockRef]:
        """Failure path: the replicated request resumes *here* — the hosted
        replica blocks become this pool's primary blocks for rid, keeping
        their absolute logical page indices."""
        refs = self._replica_tables.pop((peer, rid), [])
        assert rid not in self._tables, "rid already live on this node"
        self._tables[rid] = refs
        return refs

    # -- real-buffer block IO (bit-exact data movement) -----------------------
    def _index(self, slots) -> torch.Tensor:
        return torch.as_tensor(slots, dtype=torch.long, device=self.k.device)

    def write_blocks(self, slots: List[int], k_blocks, v_blocks):
        """Bulk write (admission path): k/v_blocks (L, K, n, page, D) into
        ``slots``, in place — cast to the pool dtype, or quantized per token
        row on an int8 pool (payload and scales land together)."""
        assert self.real
        idx = self._index(slots)
        if self.quantized:
            for pool, scale, blocks in ((self.k, self.k_scale, k_blocks),
                                        (self.v, self.v_scale, v_blocks)):
                q, s = quantize_pages(blocks)
                pool.index_copy_(2, idx, q)
                scale.index_copy_(2, idx, s)
            return
        self.k.index_copy_(2, idx, k_blocks.to(self.k.dtype))
        self.v.index_copy_(2, idx, v_blocks.to(self.v.dtype))

    def read_block(self, slot: int):
        """(L, K, page, D) k/v of one block: views, or f32 dequantized on
        an int8 pool (``read_block_quantized`` gives the raw payload)."""
        assert self.real
        if self.quantized:
            return (dequantize_pages(self.k[:, :, slot],
                                     self.k_scale[:, :, slot]),
                    dequantize_pages(self.v[:, :, slot],
                                     self.v_scale[:, :, slot]))
        return self.k[:, :, slot], self.v[:, :, slot]

    def read_block_quantized(self, slot: int):
        """Raw payload of one int8 block: (k int8, k_scale, v int8,
        v_scale) — exactly the bytes a replication message carries."""
        assert self.real and self.quantized
        return (self.k[:, :, slot], self.k_scale[:, :, slot],
                self.v[:, :, slot], self.v_scale[:, :, slot])

    def copy_blocks_to(self, other: "PagedKVPool",
                       src_slots: List[int], dst_slots: List[int]):
        """Block replication (the paper's yellow arrow), batched: this
        step's dirty blocks as one gather
        + one in-place scatter per buffer, on the current stream (ordered
        after the decode that wrote the source pages). An int8 pool ships
        its payload and scales verbatim, with no requantization."""
        if not (self.real and other.real) or not src_slots:
            return
        assert self.quantized == other.quantized, \
            "replication peers must agree on KV quantization"
        src, dst = self._index(src_slots), other._index(dst_slots)
        names = ("k", "v", "k_scale", "v_scale") if self.quantized \
            else ("k", "v")
        for name in names:
            getattr(other, name).index_copy_(
                2, dst, getattr(self, name).index_select(2, src))
