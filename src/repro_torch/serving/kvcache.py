"""Block-paged KV cache pool — the paper's KV representation (Sec 3.2 #3:
"KevlarFlow uses a block representation of KV cache and replicates it
block-by-block in the background").

Blocks are the unit of allocation, replication and memory-pressure
eviction. The pool carries real torch buffers on its device when an engine
runs real compute, or pure metadata otherwise — the allocation/replication
logic is identical.

The pool is unquantized, or int8 with per-(layer, head, token) scales
(``quantized=True``). With ``prefix_cache=True`` fully-covered prompt pages
are interned by chain hash and shared by reference (copy-on-write on
divergence). A blob store beside the blocks holds fixed-size opaque state
blobs, one per request (``blob_words`` f32 words; int8 with one scale per
blob on an int8 pool): the hybrid family's RG-LRU state, replicated,
hosted, promoted and evicted like a KV block.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

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
    kind: str = "kv"           # "kv" (paged KV block) | "blob" (opaque state)


PREFIX_ROOT = b"root"


@dataclasses.dataclass
class PrefixPage:
    """One interned, content-addressed, immutable prefix page.

    ``key`` is a chain hash H(arch_key, parent_key, page token ids), so a
    page is only reusable under the exact same preceding context AND the
    exact same model/dtype identity. ``refcount`` counts every live
    BlockRef (primary *and* hosted-replica tables) pointing at ``slot``;
    a page at refcount 0 stays cached (warm) until LRU pressure eviction.
    """
    key: bytes
    parent: bytes                    # chain key of the previous page
    tokens: Tuple[int, ...]          # this page's token ids (partial match)
    slot: int
    logical_idx: int                 # absolute page index in the chain
    refcount: int = 0
    lru: int = 0                     # last-touch tick (eviction order)


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

    Blob store (``n_blobs`` > 0): (n_blobs, blob_words) f32, or int8 with
    (n_blobs, 1) SCALE_DTYPE scales ``blob_scales`` on an int8 pool.

    Prefix cache (``prefix_cache=True``): ``prefix_index`` maps chain key ->
    PrefixPage; ``_slot_prefix`` is the reverse slot -> key map (a slot is
    interned iff present); ``_prefix_children`` maps parent key -> child
    keys so the last (diverging) page of a lookup can still be partially
    matched. Interned pages are never written in place; warm pages at
    refcount 0 count as used until evicted, so a pool's used blocks are its
    live, hosted and interned pages.
    """

    def __init__(self, n_blocks: int, page_size: int, n_layers: int = 0,
                 n_kv_heads: int = 0, head_dim: int = 0, real: bool = False,
                 dtype=torch.bfloat16, blob_words: int = 0, n_blobs: int = 0,
                 window: int = 0, device="cuda", quantized: bool = False,
                 prefix_cache: bool = False, arch_key: str = ""):
        # the constructor's arguments, so ``empty_like`` builds a pool of
        # the same kind (geometry, dtype, device, quantization, blobs)
        self._spec = dict(n_blocks=n_blocks, page_size=page_size,
                          n_layers=n_layers, n_kv_heads=n_kv_heads,
                          head_dim=head_dim, real=real, dtype=dtype,
                          blob_words=blob_words, n_blobs=n_blobs,
                          window=window, device=device, quantized=quantized,
                          prefix_cache=prefix_cache, arch_key=arch_key)
        self.n_blocks = n_blocks
        self.page_size = page_size
        self.real = real
        # called as (peer, rid, logical page indices) when pressure evicts a
        # real pool's hosted replica, so the peer's flags can follow
        self.on_replica_evicted: Optional[
            Callable[[int, int, List[int]], None]] = None
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
        # blob store: one fixed-size opaque state blob per request, with the
        # same dirty flag and host/promote/evict lifecycle as a KV block
        self.blob_words = blob_words
        self.n_blobs = n_blobs
        self._blob_free: List[int] = list(range(n_blobs))
        self._blob_refs: Dict[int, BlockRef] = {}          # rid -> blob
        self._blob_replicas: Dict[Tuple[int, int], BlockRef] = {}
        self.prefix_cache = prefix_cache
        self.arch_key = arch_key
        self.prefix_index: Dict[bytes, PrefixPage] = {}
        self._slot_prefix: Dict[int, bytes] = {}
        self._prefix_children: Dict[bytes, List[bytes]] = {}
        self._lru_tick = 0
        self.prefix_lookups = 0
        self.prefix_hit_tokens = 0
        self.prefix_hits_by_rid: Dict[int, int] = {}   # per-admission hits
        self.prefix_interned_pages = 0
        self.prefix_hosted_pages = 0     # interned via shared replication
        self.prefix_evicted_pages = 0
        self.cow_copies = 0
        self.k_scale = self.v_scale = self.blob_scales = None
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
            if n_blobs:
                # the f32 carrier round-trips the bf16 conv state losslessly
                self.blobs = torch.zeros(
                    (n_blobs, blob_words), device=device,
                    dtype=torch.int8 if quantized else torch.float32)
                if quantized:
                    self.blob_scales = torch.ones(
                        (n_blobs, 1), dtype=SCALE_DTYPE, device=device)

    def empty_like(self) -> "PagedKVPool":
        """A new, empty pool built as this one was: real buffers of the
        same geometry, dtype, device and quantization (and blob store), or
        metadata only."""
        return PagedKVPool(**self._spec)

    @property
    def block_nbytes(self) -> int:
        """Bytes of one replication message (k+v, all layers; an int8 pool
        ships its scale rows too)."""
        if not self.real:
            return 0
        tensors = [self.k] + ([self.k_scale] if self.quantized else [])
        return sum(2 * t.numel() // self.n_blocks * t.element_size()
                   for t in tensors)

    @property
    def blob_nbytes(self) -> int:
        """Bytes of one blob replication message: f32 words, or int8 words
        plus one scale on an int8 pool."""
        if not self.blob_words:
            return 0
        if self.quantized:
            return self.blob_words + SCALE_DTYPE.itemsize
        return 4 * self.blob_words

    # -- capacity ----------------------------------------------------------
    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_used(self) -> int:
        return self.n_blocks - self.n_free

    def utilization(self) -> float:
        return self.n_used / self.n_blocks

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

    def can_allocate(self, n_tokens: int) -> bool:
        return self.n_free >= self.resident_blocks_for(n_tokens)

    def allocate(self, rid: int, n_tokens: int,
                 token_ids: Optional[Sequence[int]] = None) -> List[BlockRef]:
        """Allocate blocks; raises MemoryError if full (caller should evict
        replicas first — the paper's pressure rule).

        Fresh rid: blocks for an n_tokens-long prompt (on a windowed pool
        only the pages intersecting the window of the next write position;
        logical indices start at the window's first page). Existing rid:
        appends blocks for n_tokens MORE tokens.

        With ``prefix_cache`` on and ``token_ids`` given for a fresh rid
        whose whole prompt is resident, the longest interned prefix chain
        is attached by reference (refcount++) instead of popping fresh
        slots — only uncovered pages consume the free list."""
        table = self._tables.get(rid)
        shared: List[Tuple[PrefixPage, int]] = []   # (entry, tokens covered)
        protect: Iterable[bytes] = ()
        if table:
            start = table[-1].logical_idx + 1
            need = self.blocks_for_tokens(n_tokens)
            remaining = n_tokens
        else:
            start = (max(0, n_tokens - self.window) // self.page_size
                     if self.window else 0)
            need = self.resident_blocks_for(n_tokens)
            remaining = n_tokens - start * self.page_size
            if (self.prefix_cache and token_ids is not None and start == 0
                    and n_tokens > 0):
                matched, partial = self.match_prefix(token_ids[:n_tokens])
                shared = [(e, self.page_size) for e in matched]
                if partial is not None:
                    shared.append(partial)
                protect = {e.key for e, _ in shared}
                start = len(shared)
                need -= len(shared)
                remaining -= len(shared) * self.page_size
                hits = sum(c for _, c in shared)
                self.prefix_hit_tokens += hits
                self.prefix_hits_by_rid[rid] = hits
        if need > self.n_free and self.prefix_cache:
            # warm refcount-0 prefix pages are cache, not commitments:
            # reclaim them (LRU) before touching live state — but never the
            # chain this very allocation is about to attach
            self.evict_cached_prefixes(need, protect=protect)
        if need > self.n_free and self.window:
            # windowed pools can be "full" while live requests still hold
            # head pages fully below their window: recycle those first, then
            # drop hosted replicas, and only then give up
            for r in list(self._tables):
                if self.n_free >= need:
                    break
                self.pending_recycles.extend(self.recycle_out_of_window(r))
            if need > self.n_free and self.prefix_cache:
                # recycling may have dropped shared pages to refcount 0
                self.evict_cached_prefixes(need, protect=protect)
            if need > self.n_free:
                self.evict_replicas_for_pressure(need)
        if need > self.n_free:
            raise MemoryError(f"pool exhausted: need {need}, free {self.n_free}")
        table = self._tables.setdefault(rid, [])
        refs = []
        for i, (entry, _covered) in enumerate(shared):
            entry.refcount += 1
            entry.lru = self._tick()
            # n_filled is the page's FINAL token count for this prompt — on
            # a mid-page divergence the page is CoW'd and rewritten during
            # prefill, but its logical fill is fixed here
            ref = BlockRef(rid, i, entry.slot,
                           n_filled=min(self.page_size,
                                        n_tokens - i * self.page_size))
            table.append(ref)
            refs.append(ref)
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
        if ref.slot in self._slot_prefix:
            # appending into a partially-filled shared page: copy-on-write
            # BEFORE mutating any accounting (``_cow`` may raise
            # MemoryError, and the caller's evict-and-retry must find the
            # table untouched)
            ref = self._cow(ref)
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
            self._release_slot(ref.slot)
            recycled.append(ref)
        return recycled

    def drain_pending_recycles(self) -> List[BlockRef]:
        """Refs recycled inside ``allocate``'s windowed pressure fallback
        since the last drain (the caller still owes their retire messages)."""
        out, self.pending_recycles = self.pending_recycles, []
        return out

    def free(self, rid: int):
        for ref in self._tables.pop(rid, []):
            self._release_slot(ref.slot)
        self.prefix_hits_by_rid.pop(rid, None)
        blob = self._blob_refs.pop(rid, None)
        if blob is not None:
            self._blob_free.append(blob.slot)

    def live_requests(self) -> List[int]:
        return list(self._tables)

    # -- blobs (opaque per-request state, e.g. the RG-LRU recurrence) --------
    def allocate_blob(self, rid: int) -> BlockRef:
        """One fixed-size blob per request; raises MemoryError when the
        blob store is full (the caller evicts replicas first)."""
        assert rid not in self._blob_refs, "rid already owns a blob"
        if not self._blob_free:
            raise MemoryError("blob store exhausted")
        ref = BlockRef(rid, 0, self._blob_free.pop(), kind="blob")
        self._blob_refs[rid] = ref
        return ref

    def blob_ref(self, rid: int) -> Optional[BlockRef]:
        return self._blob_refs.get(rid)

    def mark_blob_dirty(self, rid: int):
        """Decode mutated this request's recurrent state in place."""
        ref = self._blob_refs.get(rid)
        if ref is not None:
            ref.replicated = False

    def host_blob_replica(self, peer: int, rid: int) -> bool:
        """Reserve one blob slot for a peer's replicated state. Never
        raises: False when the blob store is full."""
        if (peer, rid) in self._blob_replicas:
            return True
        if not self._blob_free:
            return False
        self._blob_replicas[(peer, rid)] = BlockRef(
            rid, 0, self._blob_free.pop(), kind="blob")
        return True

    def blob_replica_ref(self, peer: int, rid: int) -> Optional[BlockRef]:
        return self._blob_replicas.get((peer, rid))

    def replica_blobs_used(self) -> int:
        return len(self._blob_replicas)

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
                self._release_slot(ref.slot)
                return True
        return False

    def unhost_tail(self, peer: int, rid: int, n: int,
                    fresh_keys: Iterable[bytes] = ()):
        """Undo the LAST ``n`` hosted blocks of (peer, rid) — the
        all-or-nothing staging rollback. Private slots return to the free
        list; shared pages are deref'd through ``_release_slot``. A shared
        page interned BY the rolled-back hosting (its key in
        ``fresh_keys``: its bytes never shipped) is fully evicted once its
        refcount returns to 0, so no lookup can attach a page whose copy
        never landed."""
        table = self._replica_tables.get((peer, rid), [])
        assert len(table) >= n, "unhosting more blocks than were hosted"
        fresh = set(fresh_keys)
        for _ in range(n):
            ref = table.pop()
            key = self._slot_prefix.get(ref.slot)
            self._release_slot(ref.slot)
            if key is not None and key in fresh:
                entry = self.prefix_index.get(key)
                if entry is not None and entry.refcount == 0:
                    self._evict_prefix_entry(entry)
                    self.prefix_hosted_pages -= 1
                    self.prefix_evicted_pages -= 1   # never a real page
        if not table:
            self._replica_tables.pop((peer, rid), None)

    def drop_replica(self, peer: int, rid: int):
        for ref in self._replica_tables.pop((peer, rid), []):
            self._release_slot(ref.slot)
        blob = self._blob_replicas.pop((peer, rid), None)
        if blob is not None:
            self._blob_free.append(blob.slot)

    def drop_all_replicas_from(self, peer: int):
        for key in [k for k in self._replica_tables if k[0] == peer]:
            self.drop_replica(*key)

    def evict_replicas_for_pressure(self, blocks_needed: int) -> int:
        """Paper: 'When memory pressure happens, KevlarFlow drops the
        replicated KV cache'. Evict whole replica tables until enough
        blocks are free. Returns blocks freed. On a real pool each evicted
        table is reported to ``on_replica_evicted``, so its source stops
        counting those blocks as replicated (a metadata pool keeps the
        reference's behaviour: the source's flags stay set)."""
        freed = 0
        for key in list(self._replica_tables):
            if self.n_free >= blocks_needed:
                break
            logical = [ref.logical_idx for ref in self._replica_tables[key]]
            self.drop_replica(*key)
            freed += len(logical)
            if self.real and self.on_replica_evicted is not None:
                self.on_replica_evicted(*key, logical)
        return freed

    def evict_blob_replicas_for_pressure(self) -> int:
        """Blob-store pressure: drop hosted replica tables (KV and blob
        together — a partial replica cannot be resumed from) until a blob
        slot frees up. Returns the replica tables dropped."""
        dropped = 0
        for key in list(self._blob_replicas):
            if self._blob_free:
                break
            self.drop_replica(*key)
            dropped += 1
        return dropped

    def promote_replica(self, peer: int, rid: int) -> List[BlockRef]:
        """Failure path: the replicated request resumes *here* — the hosted
        replica blocks become this pool's primary blocks for rid, keeping
        their absolute logical page indices. A hosted state blob (hybrid
        family) is promoted alongside the KV blocks."""
        refs = self._replica_tables.pop((peer, rid), [])
        assert rid not in self._tables, "rid already live on this node"
        self._tables[rid] = refs
        blob = self._blob_replicas.pop((peer, rid), None)
        if blob is not None:
            self._blob_refs[rid] = blob
        return refs

    # -- prefix cache (content-addressed immutable prompt pages) -------------
    def _tick(self) -> int:
        self._lru_tick += 1
        return self._lru_tick

    def _release_slot(self, slot: int):
        """Drop one reference to ``slot``. An interned slot is decref'd and
        STAYS cached (warm for future lookups, reclaimable at refcount 0);
        a private slot goes back on the free list. This is the single
        choke point through which every path that gives back a slot —
        free, recycle, retire, unhost, drop — passes, so none of them ever
        frees a page the prefix index still owns (the aliasing hazard)."""
        key = self._slot_prefix.get(slot)
        if key is None:
            self._free.append(slot)
            return
        entry = self.prefix_index[key]
        entry.refcount -= 1
        assert entry.refcount >= 0, "prefix page refcount went negative"
        entry.lru = self._tick()

    def _page_key(self, parent: bytes, tokens: Tuple[int, ...]) -> bytes:
        h = hashlib.blake2b(digest_size=16)
        h.update(self.arch_key.encode())
        h.update(parent)
        h.update(",".join(str(t) for t in tokens).encode())
        return h.digest()

    def match_prefix(self, token_ids: Sequence[int], peek: bool = False):
        """Longest interned page-aligned prefix of ``token_ids``.

        Returns (full, partial): ``full`` is the list of PrefixPage entries
        covering whole leading pages; ``partial`` is an optional
        (PrefixPage, n_common) pair when a child of the last matched page
        shares a sub-page run of tokens with the remainder (the prompt
        either ends inside that page or diverges mid-page — the CoW case).
        ``peek`` skips counters/LRU touches (capacity estimation)."""
        if not peek:
            self.prefix_lookups += 1
        matched: List[PrefixPage] = []
        parent = PREFIX_ROOT
        n = len(token_ids)
        for p in range(n // self.page_size):
            toks = tuple(int(t) for t in
                         token_ids[p * self.page_size:(p + 1) * self.page_size])
            entry = self.prefix_index.get(self._page_key(parent, toks))
            if entry is None:
                break
            matched.append(entry)
            parent = entry.key
        rest = [int(t) for t in token_ids[len(matched) * self.page_size:n]]
        partial = None
        if rest:
            best, best_n = None, 0
            for child_key in self._prefix_children.get(parent, ()):
                child = self.prefix_index.get(child_key)
                if child is None:
                    continue
                m = 0
                for a, b in zip(child.tokens, rest):
                    if a != b:
                        break
                    m += 1
                if m > best_n:
                    best, best_n = child, m
            if best is not None and best_n > 0:
                partial = (best, best_n)
        if not peek:
            tick = self._tick()
            for entry in matched:
                entry.lru = tick
        return matched, partial

    def prefix_key_of(self, slot: int) -> Optional[bytes]:
        """Chain key if ``slot`` is interned, else None (private page)."""
        return self._slot_prefix.get(slot)

    def intern_prefix(self, rid: int, token_ids: Sequence[int]) -> int:
        """Publish rid's fully-covered prompt pages into the prefix index
        (called once prefill has written their bytes). Only whole pages
        starting at logical page 0 are interned — sub-page prefixes are
        never interned, and a windowed request whose head pages were never
        materialized publishes nothing. Returns pages newly interned."""
        if not self.prefix_cache:
            return 0
        table = self._tables.get(rid) or []
        parent = PREFIX_ROOT
        interned = 0
        for p in range(min(len(token_ids) // self.page_size, len(table))):
            ref = table[p]
            if ref.logical_idx != p or ref.n_filled < self.page_size:
                break
            toks = tuple(int(t) for t in
                         token_ids[p * self.page_size:(p + 1) * self.page_size])
            key = self._page_key(parent, toks)
            if ref.slot in self._slot_prefix or key in self.prefix_index:
                # already shared (attached at admission), or identical
                # content already published from another slot: keep rid's
                # private copy, don't double-intern
                parent = key
                continue
            self.prefix_index[key] = PrefixPage(
                key, parent, toks, ref.slot, p,
                refcount=1, lru=self._tick())
            self._slot_prefix[ref.slot] = key
            self._prefix_children.setdefault(parent, []).append(key)
            self.prefix_interned_pages += 1
            interned += 1
            parent = key
        return interned

    def ensure_private(self, rid: int, logical_idx: int) -> BlockRef:
        """Guarantee rid's page ``logical_idx`` is private (copy-on-write
        if it is currently a shared prefix page). Returns the (possibly
        re-slotted) BlockRef; prefill calls this before rewriting a
        diverging page."""
        for ref in self._tables.get(rid, []):
            if ref.logical_idx == logical_idx:
                if ref.slot in self._slot_prefix:
                    return self._cow(ref)
                return ref
        raise KeyError(f"rid {rid} has no page {logical_idx}")

    def _cow(self, ref: BlockRef) -> BlockRef:
        """Copy-on-write: move ``ref`` onto a fresh private slot carrying a
        byte copy of the shared page, then drop the shared reference. The
        interned page itself is never mutated."""
        old_key = self._slot_prefix[ref.slot]
        if not self._free:
            self.evict_cached_prefixes(1, protect={old_key})
        if not self._free:
            self.evict_replicas_for_pressure(1)
        if not self._free:
            raise MemoryError("pool exhausted during copy-on-write")
        new_slot = self._free.pop()
        if self.real:
            self._clone_slot(ref.slot, new_slot)
        self._release_slot(ref.slot)     # decref the shared page
        ref.slot = new_slot
        ref.replicated = False
        self.cow_copies += 1
        return ref

    def _clone_slot(self, src: int, dst: int):
        """Same-pool page byte copy (CoW) through the replication copy: K
        and V, and an int8 pool's payload and both scale tensors,
        verbatim."""
        self.copy_blocks_to(self, [src], [dst])

    def evict_cached_prefixes(self, blocks_needed: int,
                              protect: Iterable[bytes] = ()) -> int:
        """LRU-evict interned pages at refcount == 0 until ``blocks_needed``
        slots are free. Pages still referenced (refcount > 0) are never
        touched; ``protect`` shields keys about to be attached."""
        if not self.prefix_cache:
            return 0
        protect = set(protect)
        victims = sorted((e for e in self.prefix_index.values()
                          if e.refcount == 0 and e.key not in protect),
                         key=lambda e: e.lru)
        freed = 0
        for entry in victims:
            if self.n_free >= blocks_needed:
                break
            self._evict_prefix_entry(entry)
            freed += 1
        return freed

    def _evict_prefix_entry(self, entry: PrefixPage):
        assert entry.refcount == 0, "evicting a referenced prefix page"
        del self.prefix_index[entry.key]
        del self._slot_prefix[entry.slot]
        kids = self._prefix_children.get(entry.parent)
        if kids is not None:
            kids.remove(entry.key)
            if not kids:
                del self._prefix_children[entry.parent]
        self._free.append(entry.slot)
        self.prefix_evicted_pages += 1

    def host_shared_block(self, peer: int, rid: int, src_entry: PrefixPage,
                          logical_idx: int):
        """Host one SHARED page of a peer's request: if a page with the
        same chain key is already interned here (shipped earlier for
        another request, or produced by this pool's own traffic), reference
        it — zero bytes on the wire. Otherwise intern a fresh slot the
        caller must copy into. Returns (replica BlockRef, needs_copy) or
        None when there is no headroom."""
        entry = self.prefix_index.get(src_entry.key)
        needs_copy = False
        if entry is None:
            if not self._free:
                self.evict_cached_prefixes(1)
            if not self._free:
                return None
            slot = self._free.pop()
            entry = PrefixPage(src_entry.key, src_entry.parent,
                               src_entry.tokens, slot, src_entry.logical_idx,
                               refcount=0, lru=self._tick())
            self.prefix_index[entry.key] = entry
            self._slot_prefix[slot] = entry.key
            self._prefix_children.setdefault(entry.parent, []).append(entry.key)
            self.prefix_hosted_pages += 1
            needs_copy = True
        entry.refcount += 1
        entry.lru = self._tick()
        ref = BlockRef(rid, logical_idx, entry.slot, n_filled=self.page_size)
        self._replica_tables.setdefault((peer, rid), []).append(ref)
        return ref, needs_copy

    # -- real-buffer block IO (bit-exact data movement) -----------------------
    def _index(self, slots) -> torch.Tensor:
        return torch.as_tensor(slots, dtype=torch.long, device=self.k.device)

    def write_block(self, slot: int, k_block, v_block):
        """k_block / v_block: (L, K, page, D) — quantized on write on an
        int8 pool."""
        self.write_blocks([slot], k_block[:, :, None], v_block[:, :, None])

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

    def copy_block_to(self, other: "PagedKVPool", src_slot: int,
                      dst_slot: int):
        """One block-replication message (the paper's yellow arrow)."""
        self.copy_blocks_to(other, [src_slot], [dst_slot])

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

    # -- real-buffer blob IO -------------------------------------------------
    def write_blob(self, slot: int, vec):
        """vec: (blob_words,) f32 — quantized to int8 + one per-blob scale
        on an int8 pool."""
        assert self.real and self.n_blobs
        if self.quantized:
            q, s = quantize_pages(vec[None])
            self.blobs[slot] = q[0]
            self.blob_scales[slot] = s[0]
            return
        self.blobs[slot] = vec.float()

    def read_blob(self, slot: int):
        """(blob_words,) f32 state — dequantized on an int8 pool
        (``read_blob_quantized`` gives the raw payload)."""
        assert self.real and self.n_blobs
        if self.quantized:
            return dequantize_pages(self.blobs[slot], self.blob_scales[slot])
        return self.blobs[slot]

    def read_blob_quantized(self, slot: int):
        """Raw quantized blob payload: (int8 (blob_words,), scale (1,))."""
        assert self.real and self.n_blobs and self.quantized
        return self.blobs[slot], self.blob_scales[slot]

    def copy_blobs_to(self, other: "PagedKVPool", src_slots: List[int],
                      dst_slots: List[int]):
        """Blob replication, batched: one gather + one in-place scatter per
        buffer on the current stream; an int8 pool ships its payload and
        scales verbatim."""
        if not (self.real and other.real) or not src_slots:
            return
        assert self.quantized == other.quantized, \
            "replication peers must agree on KV quantization"
        src = torch.as_tensor(src_slots, dtype=torch.long,
                              device=self.blobs.device)
        dst = torch.as_tensor(dst_slots, dtype=torch.long,
                              device=other.blobs.device)
        names = ("blobs", "blob_scales") if self.quantized else ("blobs",)
        for name in names:
            getattr(other, name).index_copy_(
                0, dst, getattr(self, name).index_select(0, src))
