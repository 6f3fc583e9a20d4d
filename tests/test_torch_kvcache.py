"""The port's paged KV pool: the reference pool's bookkeeping cases
(allocation, replicas, pressure eviction, sliding-window recycling), its
message size against the reference's, a leak/double-free sweep, and
bit-exact block IO."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs in parallel workers on few
# cores, and idle OpenMP threads spin and starve the other workers
torch.set_num_threads(1)

from repro.serving.kvcache import PagedKVPool as JPool  # noqa: E402
from repro_torch.serving.kvcache import PagedKVPool  # noqa: E402


def test_alloc_free_roundtrip():
    pool = PagedKVPool(n_blocks=32, page_size=16)
    pool.allocate(1, 100)                     # 7 blocks
    assert pool.n_used == 7
    assert pool.n_tokens(1) == 100
    pool.free(1)
    assert pool.n_free == 32


def test_append_token_block_boundary():
    pool = PagedKVPool(n_blocks=8, page_size=4)
    pool.allocate(1, 4)
    assert pool.n_used == 1
    pool.append_token(1)                       # overflows into a new block
    assert pool.n_used == 2
    assert pool.n_tokens(1) == 5


def test_replica_promotion():
    pool = PagedKVPool(n_blocks=16, page_size=16)
    assert pool.host_replica(peer=7, rid=42, n_blocks=3)
    assert pool.replica_blocks_used() == 3
    refs = pool.promote_replica(7, 42)
    assert len(refs) == 3
    assert pool.table(42) == refs              # now primary
    assert pool.replica_blocks_used() == 0


def test_pressure_eviction_frees_replicas_first():
    pool = PagedKVPool(n_blocks=8, page_size=16)
    pool.host_replica(1, 10, 4)
    pool.allocate(2, 50)                       # 4 blocks, pool now full
    assert pool.n_free == 0
    with pytest.raises(MemoryError):
        pool.allocate(3, 40)
    pool.evict_replicas_for_pressure(3)
    pool.allocate(3, 40)                       # fits after eviction
    assert pool.n_tokens(3) == 40


def test_host_replica_rejects_without_headroom():
    pool = PagedKVPool(n_blocks=4, page_size=16)
    pool.allocate(1, 60)
    assert not pool.host_replica(2, 9, 2)     # replicas never raise


def test_failed_allocate_leaves_no_zombie_table():
    pool = PagedKVPool(n_blocks=2, page_size=8)
    with pytest.raises(MemoryError):
        pool.allocate(5, 100)
    assert 5 not in pool.live_requests()
    assert pool.n_free == 2


def test_windowed_allocate_starts_at_window_page():
    pool = PagedKVPool(n_blocks=32, page_size=8, window=16)
    refs = pool.allocate(1, 40)                # window covers [24, 40)
    assert [r.logical_idx for r in refs] == [3, 4]
    assert pool.abs_tokens(1) == 40
    assert pool.n_tokens(1) == 16
    assert pool.window_pages == 3
    pool.free(1)
    assert pool.n_free == 32


def test_windowed_short_prompt_allocates_from_zero():
    pool = PagedKVPool(n_blocks=32, page_size=8, window=16)
    refs = pool.allocate(1, 10)
    assert [r.logical_idx for r in refs] == [0, 1]
    assert pool.abs_tokens(1) == 10


def test_recycle_out_of_window_bounds_residency():
    pool = PagedKVPool(n_blocks=16, page_size=8, window=16)
    pool.allocate(1, 10)
    retired = []
    for _ in range(100):
        retired += [r.logical_idx for r in pool.recycle_out_of_window(1)]
        pool.append_token(1)
        assert len(pool.table(1)) <= pool.window_pages
    assert pool.abs_tokens(1) == 110
    table_pages = [r.logical_idx for r in pool.table(1)]
    assert retired == list(range(table_pages[0]))
    assert (table_pages[0] + 1) * 8 > 110 + 1 - 16
    pool.free(1)
    assert pool.n_free == 16


def test_recycle_noop_inside_window():
    pool = PagedKVPool(n_blocks=16, page_size=8, window=64)
    pool.allocate(1, 30)
    assert pool.recycle_out_of_window(1) == []
    assert pool.n_tokens(1) == 30


def test_retire_replica_block():
    pool = PagedKVPool(n_blocks=16, page_size=8, window=16)
    assert pool.host_replica(0, 5, 3, first_logical=4)
    assert [r.logical_idx for r in pool.replica_table(0, 5)] == [4, 5, 6]
    free_before = pool.n_free
    assert pool.retire_replica_block(0, 5, 4)
    assert pool.n_free == free_before + 1
    assert [r.logical_idx for r in pool.replica_table(0, 5)] == [5, 6]
    assert not pool.retire_replica_block(0, 5, 4)      # already gone
    assert not pool.retire_replica_block(0, 99, 0)     # never hosted


def test_windowed_promote_keeps_absolute_pages():
    pool = PagedKVPool(n_blocks=16, page_size=8, window=16)
    pool.host_replica(0, 5, 3, first_logical=7)
    refs = pool.promote_replica(0, 5)
    assert [r.logical_idx for r in refs] == [7, 8, 9]
    assert pool.table(5) == refs


def test_windowed_allocate_recycles_before_raising():
    pool = PagedKVPool(n_blocks=8, page_size=8, window=16)
    pool.allocate(1, 50)            # window tail: pages 4-6 (3 blocks)
    for _ in range(24):
        pool.append_token(1)        # 74 abs tokens -> pages 4-9 resident
    assert pool.n_free == 2
    refs = pool.allocate(2, 20)
    assert [r.logical_idx for r in refs] == [0, 1, 2]
    recycled = pool.drain_pending_recycles()
    assert recycled and all(r.rid == 1 for r in recycled)
    pages = [r.logical_idx for r in pool.table(1)]
    assert pages == list(range(pages[0], pages[0] + len(pages)))
    assert (pages[0] + 1) * 8 > 74 + 1 - 16


def test_windowed_allocate_evicts_replicas_after_recycling():
    pool = PagedKVPool(n_blocks=8, page_size=8, window=16)
    pool.host_replica(0, 99, 5)
    pool.allocate(1, 20)            # 3 blocks; pool now full
    assert pool.n_free == 0
    refs = pool.allocate(2, 20)     # no recyclable pages -> evicts replica
    assert len(refs) == 3
    assert pool.replica_table(0, 99) == []
    flat = PagedKVPool(n_blocks=8, page_size=8)
    flat.host_replica(0, 99, 5)
    flat.allocate(1, 24)
    with pytest.raises(MemoryError):
        flat.allocate(2, 24)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_block_nbytes_matches_reference(dtype):
    shape = dict(n_layers=2, n_kv_heads=2, head_dim=64)
    ours = PagedKVPool(9, 8, real=True, dtype=getattr(torch, dtype),
                       device="cpu", **shape)
    ref = JPool(9, 8, real=True, dtype=dtype, **shape)
    assert ours.block_nbytes == ref.block_nbytes == 2 * 2 * 2 * 8 * 64 * (
        2 if dtype == "bfloat16" else 4)


def test_random_action_sweep_no_leak_no_double_free():
    """Random allocate / append / recycle / free / host / retire / evict /
    promote sequences on a windowed pool: every slot is exactly one of
    primary, hosted replica or free, at every step."""
    rng = np.random.default_rng(0)
    for trial in range(20):
        pool = PagedKVPool(n_blocks=24, page_size=4, window=10)
        rids = []
        for _ in range(120):
            act = rng.integers(0, 7)
            try:
                if act == 0:
                    rid = int(rng.integers(0, 1000))
                    if rid not in pool.live_requests():
                        pool.allocate(rid, int(rng.integers(1, 20)))
                        rids.append(rid)
                elif act == 1 and rids:
                    rid = rids[rng.integers(len(rids))]
                    pool.recycle_out_of_window(rid)
                    pool.append_token(rid)
                elif act == 2 and rids:
                    pool.free(rids.pop(rng.integers(len(rids))))
                elif act == 3:
                    pool.host_replica(int(rng.integers(0, 3)),
                                      int(rng.integers(1000, 1010)),
                                      int(rng.integers(1, 4)))
                elif act == 4:
                    pool.retire_replica_block(int(rng.integers(0, 3)),
                                              int(rng.integers(1000, 1010)),
                                              int(rng.integers(0, 4)))
                elif act == 5:
                    pool.evict_replicas_for_pressure(int(rng.integers(1, 8)))
                elif act == 6:
                    key = (int(rng.integers(0, 3)),
                           int(rng.integers(1000, 1010)))
                    if pool.replica_table(*key) and \
                            key[1] not in pool.live_requests():
                        pool.promote_replica(*key)
                        rids.append(key[1])
            except MemoryError:
                pass
            pool.drain_pending_recycles()
            primary = [r.slot for rid in pool.live_requests()
                       for r in pool.table(rid)]
            hosted = [r.slot for t in pool._replica_tables.values()
                      for r in t]
            used = primary + hosted
            assert len(set(pool._free)) == len(pool._free), "double free"
            assert len(set(used)) == len(used), "slot owned twice"
            assert not set(used) & set(pool._free), "used slot is free"
            assert len(used) + pool.n_free == pool.n_blocks, "leak"


def test_block_io_bit_exact():
    """write_blocks / read_block / copy_blocks_to move bytes verbatim."""
    rng = np.random.default_rng(1)
    shape = dict(n_layers=2, n_kv_heads=2, head_dim=64, real=True,
                 dtype=torch.bfloat16, device="cpu")
    a, b = PagedKVPool(9, 8, **shape), PagedKVPool(9, 8, **shape)
    k = torch.from_numpy(rng.standard_normal((2, 2, 3, 8, 64)).astype(
        np.float32)).bfloat16()
    v = torch.from_numpy(rng.standard_normal((2, 2, 3, 8, 64)).astype(
        np.float32)).bfloat16()
    a.write_blocks([4, 1, 7], k, v)
    for j, slot in enumerate([4, 1, 7]):
        rk, rv = a.read_block(slot)
        assert torch.equal(rk, k[:, :, j]) and torch.equal(rv, v[:, :, j])
    a.copy_blocks_to(b, [1, 7], [0, 5])
    assert torch.equal(b.k[:, :, 0], a.k[:, :, 1])
    assert torch.equal(b.v[:, :, 5], a.v[:, :, 7])
    untouched = [s for s in range(9) if s not in (0, 5)]
    assert not b.k[:, :, untouched].any()
