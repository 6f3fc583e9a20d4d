"""The port's prefix cache (``EngineConfig.prefix_cache``): the pool's
prefix index against the reference's on the same operation sequences (key
bytes, refcounts, slots, lookups, copy-on-write), the engine against the
reference engine on converted weights (streams and every ``prefix_stats``
key), and — torch against torch — a pure ALLOCATION change: every sampled
token and every prompt-page byte equal a cold start, on the bf16 and the
int8 pool, through copy-on-write, replication and an instance kill."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs in parallel workers on few cores
torch.set_num_threads(1)
import jax  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.serving.engine import EngineConfig as JEngineConfig  # noqa: E402
from repro.serving.engine import RealEngine as JRealEngine  # noqa: E402
from repro.serving.engine import RealInstance as JRealInstance  # noqa: E402
from repro.serving.kvcache import PagedKVPool as JPagedKVPool  # noqa: E402
from repro.serving.request import Request as JRequest  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import from_jax_numpy  # noqa: E402
from repro_torch.serving.engine import (EngineConfig, RealEngine,  # noqa: E402
                                        RealInstance)
from repro_torch.serving.kvcache import PagedKVPool  # noqa: E402
from repro_torch.serving.request import Request, RequestState  # noqa: E402

F32 = dict(dtype="float32", kv_dtype="float32")


# -- pool level: the same operation sequence on both packages' pools --------

def _snapshot(pool):
    """Everything the prefix index decides, as plain values."""
    index = {k.hex(): (e.parent.hex(), e.tokens, e.slot, e.logical_idx,
                       e.refcount, e.lru)
             for k, e in pool.prefix_index.items()}
    tables = {rid: [(r.logical_idx, r.slot, r.n_filled, r.replicated)
                    for r in t] for rid, t in pool._tables.items()}
    replicas = {key: [(r.logical_idx, r.slot, r.n_filled) for r in t]
                for key, t in pool._replica_tables.items()}
    counters = (pool.prefix_lookups, pool.prefix_hit_tokens,
                pool.prefix_interned_pages, pool.prefix_hosted_pages,
                pool.prefix_evicted_pages, pool.cow_copies, pool._lru_tick)
    children = {k.hex(): [c.hex() for c in v]
                for k, v in pool._prefix_children.items()}
    return index, tables, replicas, counters, children, list(pool._free)


def _lookup(pool, ids):
    full, partial = pool.match_prefix(ids, peek=True)
    return ([e.key.hex() for e in full],
            None if partial is None else (partial[0].key.hex(), partial[1]))


IDS = list(range(1, 13))


def _sub_page(pool, log):
    pool.allocate(1, 3, token_ids=[1, 2, 3])
    log.append(pool.intern_prefix(1, [1, 2, 3]))
    pool.allocate(2, 6, token_ids=IDS[:6])
    log.append(pool.intern_prefix(2, IDS[:6]))


def _boundaries(pool, log):
    pool.allocate(1, 8, token_ids=IDS[:8])
    log.append(pool.intern_prefix(1, IDS[:8]))
    for ids in (IDS[:8], IDS[:6], IDS[:6] + [99, 100], [1, 2, 3, 99],
                [50] * 8):
        log.append(_lookup(pool, ids))


def _append_cow(pool, log):
    pool.allocate(1, 8, token_ids=IDS[:8])
    pool.intern_prefix(1, IDS[:8])
    pool.allocate(2, 6, token_ids=IDS[:6])
    log.append(pool.prefix_hits_by_rid[2])
    ref = pool.append_token(2)              # token 7 lands inside page 1
    log.append((ref.slot, ref.n_filled))
    log.append(pool.append_token(2).slot)   # now private: no second copy


def _divergence_and_free(pool, log):
    pool.allocate(1, 12, token_ids=IDS)
    pool.intern_prefix(1, IDS)
    fork = IDS[:6] + [70, 71, 72, 73, 74]
    pool.allocate(2, len(fork), token_ids=fork)
    log.append(pool.ensure_private(2, 1).slot)   # the CoW page
    pool.free(1)                           # interned pages stay warm
    pool.free(2)
    log.append(_lookup(pool, IDS))


def _eviction_lru(pool, log):
    for rid, base in ((1, 0), (2, 40), (3, 80)):
        ids = [base + t for t in IDS[:8]]
        pool.allocate(rid, 8, token_ids=ids)
        pool.intern_prefix(rid, ids)
        pool.free(rid)
    pool.match_prefix(IDS[:8])             # touch chain 1: evicted last
    log.append(pool.evict_cached_prefixes(pool.n_free + 3))
    # pressure inside allocate: the warm chain it attaches is protected,
    # the other warm page is evicted
    pool.allocate(4, 64, token_ids=IDS[:8] + list(range(200, 256)))
    log.append(pool.prefix_hits_by_rid[4])


def _hosting_and_rollback(pool, log):
    pool.allocate(1, 8, token_ids=IDS[:8])
    pool.intern_prefix(1, IDS[:8])
    entries = sorted(pool.prefix_index.values(), key=lambda e: e.logical_idx)
    # a peer ships its entries for another chain: fresh interns here
    src = JPagedKVPool if isinstance(pool, JPagedKVPool) else PagedKVPool
    other = src(16, 4, prefix_cache=True, arch_key="t")
    other.allocate(9, 8, token_ids=[40 + t for t in IDS[:8]])
    other.intern_prefix(9, [40 + t for t in IDS[:8]])
    peer_entries = sorted(other.prefix_index.values(),
                          key=lambda e: e.logical_idx)
    for i, e in enumerate(entries):        # already interned: zero copy
        ref, copy = pool.host_shared_block(5, 7, e, i)
        log.append((ref.slot, copy))
    for i, e in enumerate(peer_entries):
        ref, copy = pool.host_shared_block(6, 9, e, i)
        log.append((ref.slot, copy))
    pool.host_replica(6, 9, 1, first_logical=2)
    # all-or-nothing rollback: fresh keys evicted, the private slot freed
    pool.unhost_tail(6, 9, 3, fresh_keys=[e.key for e in peer_entries])
    pool.drop_replica(5, 7)


def _windowed_release(pool, log):
    pool.allocate(1, 8, token_ids=IDS[:8])
    pool.intern_prefix(1, IDS[:8])
    for _ in range(6):
        pool.append_token(1)
    # pages below the window go back through _release_slot: interned
    # pages stay cached, private ones return to the free list
    log.append([r.logical_idx for r in pool.recycle_out_of_window(1)])


SCENARIOS = {"sub_page_never_interned": (_sub_page, {}),
             "longest_prefix_boundaries": (_boundaries, {}),
             "append_to_shared_page_cows": (_append_cow, {}),
             "divergence_then_free": (_divergence_and_free, {}),
             "lru_eviction_and_protect": (_eviction_lru, {}),
             "shared_hosting_and_rollback": (_hosting_and_rollback, {}),
             "windowed_release": (_windowed_release, {"window": 8})}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_pool_prefix_index_matches_reference(name):
    """Same operations, same pool geometry: equal chain-key bytes, index
    entries (refcounts, slots, LRU ticks), tables, free lists, counters
    and lookups in both packages."""
    fn, kw = SCENARIOS[name]
    results = []
    for cls in (JPagedKVPool, PagedKVPool):
        pool = cls(16, 4, prefix_cache=True, arch_key="t", **kw)
        log = []
        fn(pool, log)
        results.append((_snapshot(pool), log))
    assert results[1] == results[0]
    assert results[0][0][0] or name == "sub_page_never_interned"


def test_chain_keys_equal_reference_engine_identity():
    """An instance's arch_key is the reference's string (the dtype's numpy
    name, not torch's), so the same prompt gives the same key bytes."""
    cfg = get_config("llama3-8b").reduced()
    jcfg = jax_config("llama3-8b").reduced()
    for kv_quant in (False, True):
        ecfg = dict(max_slots=2, max_seq=32, prefix_cache=True,
                    kv_quant=kv_quant)
        tpool = RealInstance(cfg, None, EngineConfig(**ecfg),
                             device="cpu").pool
        jpool = JRealInstance(jcfg, None, JEngineConfig(**ecfg)).pool
        assert tpool.arch_key == jpool.arch_key == \
            f"llama3-8b-reduced|dense|bfloat16|q{int(kv_quant)}"
        assert tpool._page_key(b"root", (1, 2, 3)) == \
            jpool._page_key(b"root", (1, 2, 3))


# -- engine level: the port against the reference engine ---------------------

def _mk_req(cls, rid, ids, out=6):
    return cls(rid=rid, prompt_len=len(ids), max_new_tokens=out,
               arrival_time=0.0, prompt_tokens=list(ids))


def _parity_prompts(vocab):
    rng = np.random.default_rng(0)
    shared = rng.integers(1, vocab, 16).tolist()
    primer = shared + rng.integers(1, vocab, 5).tolist()
    return [primer,
            shared + [100, 101],                 # full-page hit
            shared + [102],
            shared[:12] + [5, 6, 7, 8, 9],      # diverges inside page 1
            shared[:10],                         # ends inside page 1
            list(primer)]                        # the primer again


def _serve_parity(eng, cls, prompts):
    eng.submit(_mk_req(cls, 0, prompts[0]))
    eng.run(300)
    for i, p in enumerate(prompts[1:]):
        eng.submit(_mk_req(cls, i + 1, p))
    eng.run(500)
    assert not eng.has_pending()
    return {r.rid: r.output_tokens for r in eng.done}


PARITY = {"chunked": dict(prefill_chunk=8),
          "chunked_int8": dict(prefill_chunk=8, kv_quant=True),
          "monolithic": dict(),
          # a hybrid hit shares pages but recomputes the prompt (its RG-LRU
          # state spans the prefix): no prompt compute is saved
          "hybrid_chunked": dict(prefill_chunk=8, arch="recurrentgemma-9b")}


@pytest.fixture(scope="module", params=sorted(PARITY))
def reference_run(request):
    """One reference run per case (float32 reduced llama3-8b unless the
    case names its arch, 2 instances, replication on): its streams, stats,
    chain keys and weights."""
    kw = dict(PARITY[request.param])
    arch = kw.pop("arch", "llama3-8b")
    jcfg = dataclasses.replace(jax_config(arch).reduced(), **F32)
    ecfg = dict(max_slots=4, max_seq=64, prefix_cache=True, **kw)
    jeng = JRealEngine(jcfg, JEngineConfig(**ecfg), n_instances=2, seed=0)
    prompts = _parity_prompts(jcfg.vocab_size)
    streams = _serve_parity(jeng, JRequest, prompts)
    params = jax.tree_util.tree_map(np.asarray, jeng.params)
    return dict(arch=arch, ecfg=ecfg, prompts=prompts, streams=streams,
                prefix=jeng.prefix_stats(), disagg=jeng.disagg_stats(),
                keys=[sorted(i.pool.prefix_index) for i in jeng.instances],
                params=params)


def test_prefix_cache_matches_reference_engine(reference_run):
    """Streams, every prefix_stats / disagg_stats key and the interned
    chain keys of each instance equal the reference engine's (float32 so
    the decisions and the arithmetic are the same)."""
    ref = reference_run
    cfg = dataclasses.replace(get_config(ref["arch"]).reduced(), **F32)
    teng = RealEngine(cfg, EngineConfig(**ref["ecfg"]), n_instances=2,
                      device="cpu",
                      params=from_jax_numpy(ref["params"], device="cpu"))
    streams = _serve_parity(teng, Request, ref["prompts"])
    assert streams == ref["streams"]
    assert all(len(s) == 6 for s in streams.values())
    assert teng.prefix_stats() == ref["prefix"]
    assert teng.disagg_stats() == ref["disagg"]
    assert [sorted(i.pool.prefix_index) for i in teng.instances] == \
        ref["keys"]
    stats = teng.prefix_stats()
    assert stats["prefix_cached_tokens"] > 0 and stats["cow_copies"] >= 1
    if cfg.arch_type == "hybrid":
        assert stats["prefill_compute_tokens"] == \
            stats["prefill_total_tokens"]


# -- torch against torch -------------------------------------------------------

def _capture_pages(inst, req, kv_quant):
    """Raw prompt-row bytes of ``req``'s pages (int8 payload + scales on
    an int8 pool)."""
    page = inst.pool.page_size
    pages = {}
    for ref in inst.pool.table(req.rid):
        valid = min(page, req.prompt_len - ref.logical_idx * page)
        if valid <= 0:
            continue
        raw = (inst.pool.read_block_quantized(ref.slot)
               if kv_quant else inst.pool.read_block(ref.slot))
        pages[ref.logical_idx] = [a[:, :, :valid].clone() for a in raw]
    return pages


def _warm_run(kv_quant, prefix_cache, prime_ids, follower_ids, out=6,
              capture_rid=1, prefill_chunk=8, arch="llama3-8b"):
    """Prime the cache with one request run to completion, then submit the
    followers together; snapshot the captured follower's prompt pages the
    moment it enters DECODE."""
    cfg = get_config(arch).reduced()
    eng = RealEngine(cfg, EngineConfig(max_slots=4, max_seq=64,
                                       replicate=False,
                                       prefill_chunk=prefill_chunk,
                                       kv_quant=kv_quant,
                                       prefix_cache=prefix_cache),
                     n_instances=1, seed=0, device="cpu")
    eng.submit(_mk_req(Request, 0, prime_ids, out))
    eng.run(300)
    assert not eng.has_pending()
    followers = [_mk_req(Request, i + 1, ids, out)
                 for i, ids in enumerate(follower_ids)]
    for r in followers:
        eng.submit(r)
    inst = eng.instances[0]
    pages = None
    for _ in range(500):
        if not eng.has_pending():
            break
        eng.step()
        req = followers[capture_rid - 1]
        if pages is None and req.state in (RequestState.DECODE,
                                           RequestState.DONE) \
                and req.rid in inst.pool.live_requests():
            pages = _capture_pages(inst, req, kv_quant)
    assert not eng.has_pending()
    return eng, [r.output_tokens for r in followers], pages


@pytest.mark.parametrize("arch", ["llama3-8b", "mixtral-8x7b",
                                  "recurrentgemma-9b"])
@pytest.mark.parametrize("prefill_chunk", [8, 0])
@pytest.mark.parametrize("kv_quant", [False, True])
def test_shared_prefix_equivalent_to_cold_start(kv_quant, prefill_chunk,
                                                arch):
    """bf16 and int8 pools, chunked and monolithic prefill, dense, MoE and
    hybrid: two followers repeating a primed 20-token prompt produce the
    exact cold-start token streams AND byte-identical prompt pages, while
    genuinely hitting the cache; the chunked bf16 pool also skips prompt
    compute, except on the hybrid, whose RG-LRU state spans the prefix (a
    hit shares pages but recomputes: compute saved is 0)."""
    rng = np.random.default_rng(0)
    ids = rng.integers(1, 1024, 20).tolist()
    warm_eng, warm_toks, warm_pages = _warm_run(
        kv_quant, True, ids, [ids, ids], prefill_chunk=prefill_chunk,
        arch=arch)
    cold_eng, cold_toks, cold_pages = _warm_run(
        kv_quant, False, ids, [ids, ids], prefill_chunk=prefill_chunk,
        arch=arch)
    assert warm_toks == cold_toks
    assert warm_pages is not None and set(warm_pages) == set(cold_pages)
    for logical in cold_pages:
        for a, b in zip(cold_pages[logical], warm_pages[logical]):
            assert torch.equal(a, b)
    stats = warm_eng.prefix_stats()
    assert stats["enabled"] and stats["prefix_cached_tokens"] >= 16
    assert cold_eng.prefix_stats()["prefix_cached_tokens"] == 0
    skips = prefill_chunk and not kv_quant and arch != "recurrentgemma-9b"
    assert (stats["prefill_compute_tokens"] < stats["prefill_total_tokens"]) \
        == bool(skips)


def test_int8_pool_recomputes_without_writing_shared_pages():
    """The int8 pool cannot seed chunk buffers losslessly: it recomputes
    every prompt token, and its page writes never touch an interned slot
    (the bf16 pool resumes past the cached chunks instead)."""
    rng = np.random.default_rng(4)
    ids = rng.integers(1, 1024, 20).tolist()
    cfg = get_config("llama3-8b").reduced()
    for kv_quant in (True, False):
        eng = RealEngine(cfg, EngineConfig(max_slots=4, max_seq=64,
                                           replicate=False, prefill_chunk=8,
                                           kv_quant=kv_quant,
                                           prefix_cache=True),
                         n_instances=1, seed=0, device="cpu")
        eng.submit(_mk_req(Request, 0, ids))
        eng.run(300)
        pool = eng.instances[0].pool
        interned = {e.slot for e in pool.prefix_index.values()}
        assert len(interned) == 2
        written = []
        orig = pool.write_blocks

        def spy(slots, k, v, orig=orig):
            written.extend(slots)
            return orig(slots, k, v)
        pool.write_blocks = spy
        before = eng.prefix_stats()["prefill_compute_tokens"]
        eng.submit(_mk_req(Request, 1, ids))
        eng.run(300)
        computed = eng.prefix_stats()["prefill_compute_tokens"] - before
        assert written and not set(written) & interned
        assert computed == (20 if kv_quant else 4)


def test_mid_page_divergence_cow_keeps_shared_bytes():
    """A follower sharing 12 of 20 tokens (divergence inside page 1)
    triggers exactly one CoW; the interned pages' bytes are bit-unchanged
    afterwards and the follower's stream matches a cold start."""
    rng = np.random.default_rng(1)
    ids = rng.integers(1, 1024, 20).tolist()
    fork = ids[:12] + rng.integers(1, 1024, 8).tolist()
    cfg = get_config("llama3-8b").reduced()
    eng = RealEngine(cfg, EngineConfig(max_slots=4, max_seq=64,
                                       replicate=False, prefill_chunk=8,
                                       prefix_cache=True),
                     n_instances=1, seed=0, device="cpu")
    eng.submit(_mk_req(Request, 0, ids))
    eng.run(300)
    pool = eng.instances[0].pool
    full, _ = pool.match_prefix(ids, peek=True)
    assert len(full) == 2
    before = [(pool.k[:, :, e.slot].clone(), pool.v[:, :, e.slot].clone())
              for e in full]
    follower = _mk_req(Request, 1, fork)
    eng.submit(follower)
    eng.run(300)
    assert pool.cow_copies == 1
    after, _ = pool.match_prefix(ids, peek=True)
    assert [e.slot for e in after] == [e.slot for e in full]
    for e, (k, v) in zip(after, before):
        assert torch.equal(pool.k[:, :, e.slot], k)
        assert torch.equal(pool.v[:, :, e.slot], v)
    _, cold_toks, _ = _warm_run(False, False, ids, [fork])
    assert [follower.output_tokens] == cold_toks


def test_ship_ratio_exact_across_kill_and_rejoin():
    """The shared-page ship ratio's denominator counts hosting EVENTS: a
    target that fails and rejoins with a fresh pool re-hosts AND re-ships
    the same chain keys, and both sides of the ratio move together."""
    cfg = get_config("llama3-8b").reduced()
    eng = RealEngine(cfg, EngineConfig(max_slots=4, max_seq=64,
                                       prefix_cache=True),
                     n_instances=2, seed=0, device="cpu")
    rng = np.random.default_rng(3)
    shared = rng.integers(1, 1024, 16).tolist()     # two full prefix pages

    def serve(rid):
        req = _mk_req(Request, rid, shared + [100 + rid])
        eng.submit(req)
        eng.run(400)
        assert not eng.has_pending()
        return req

    serve(0)            # on instance 0; replication interns pages on 1
    assert eng.repl_shared_hostings_total == 2
    assert eng.repl_shared_copies_total == 2        # fresh target: 2 ships
    assert eng.prefix_stats()["shared_page_ship_ratio"] == 1.0
    eng.fail_instance(1)
    eng.rejoin_instance(1)
    serve(10)           # same prefix; the rejoined pool must re-receive it
    assert eng.repl_shared_copies_total == 4
    assert eng.repl_shared_hostings_total == 4
    assert eng.prefix_stats()["shared_page_ship_ratio"] == 1.0
    eng.fail_instance(1)
    eng.rejoin_instance(1)
    serve(20)
    assert eng.prefix_stats()["shared_page_ship_ratio"] == 1.0


def _shared_failover_run(kv_quant, fail_at, out=10):
    cfg = get_config("llama3-8b").reduced()
    eng = RealEngine(cfg, EngineConfig(max_slots=4, max_seq=64,
                                       prefill_chunk=8, kv_quant=kv_quant,
                                       prefix_cache=True, auto_rejoin=True,
                                       rejoin_delay=2.0),
                     n_instances=2, seed=0, device="cpu")
    rng = np.random.default_rng(7)
    shared = rng.integers(1, 1024, 16).tolist()
    # prime BOTH instances (least-loaded routing puts one prime on each)
    primes = [_mk_req(Request, i, shared + rng.integers(1, 1024, 4).tolist(),
                      2) for i in range(2)]
    for r in primes:
        eng.submit(r)
    eng.run(300)
    assert not eng.has_pending()
    followers = [_mk_req(Request, 10 + i, shared + [100 + i], out)
                 for i in range(4)]
    for r in followers:
        eng.submit(r)
    steps = 0
    while eng.has_pending() and steps < 600:
        eng.step()
        steps += 1
        if fail_at is not None and steps == fail_at:
            assert eng.instances[0].requests, \
                "kill must land while the victim serves shared-prefix work"
            eng.fail_instance(0)
    assert not eng.has_pending()
    # warm spare epilogue: the rejoined instance serves the same prefix
    late = _mk_req(Request, 50, shared + [999], out)
    eng.submit(late)
    eng.run(300)
    assert not eng.has_pending()
    return eng, [r.output_tokens for r in followers + [late]]


@pytest.mark.parametrize("kv_quant", [False, True])
def test_shared_prefix_chaos_drill(kv_quant):
    """Kill instance 0 while 4 requests share interned prefix pages:
    survivors (and their migrated victims) plus a late request on the
    rejoined warm spare emit exactly the failure-free streams, and sharing
    survives the failover (shared pages replicated as refs, the survivor
    still resolves the interned chain)."""
    normal_eng, normal_toks = _shared_failover_run(kv_quant, fail_at=None)
    failed_eng, failed_toks = _shared_failover_run(kv_quant, fail_at=3)
    assert failed_toks == normal_toks
    assert all(len(t) == 10 for t in failed_toks)
    assert any(e["resumed"] for e in failed_eng.failure_events)
    assert failed_eng.repl_shared_refs_total > 0
    stats = failed_eng.prefix_stats()
    assert stats["shared_replica_refs"] >= stats["shared_replica_copies"]
    assert any(inst.alive and len(inst.pool.prefix_index) >= 2
               for inst in failed_eng.instances)


def test_pool_accounting_drains_to_live_hosted_and_interned():
    """With the cache on, warm pages at refcount 0 stay used: once traffic
    drains, each alive pool's used blocks are exactly its scratch block
    plus its interned pages, and every interned page is unreferenced."""
    cfg = get_config("llama3-8b").reduced()
    eng = RealEngine(cfg, EngineConfig(max_slots=4, max_seq=64,
                                       prefill_chunk=8, prefix_cache=True),
                     n_instances=2, seed=0, device="cpu")
    rng = np.random.default_rng(5)
    shared = rng.integers(1, 1024, 24).tolist()
    for i in range(5):
        eng.submit(_mk_req(Request, i, shared + [200 + i] * (i + 1)))
    eng.run(500)
    assert not eng.has_pending()
    for inst in eng.instances:
        pool = inst.pool
        assert pool.replica_blocks_used() == 0
        assert pool.live_requests() == [-7]          # the scratch block
        assert all(e.refcount == 0 for e in pool.prefix_index.values())
        assert pool.n_used == 1 + len(pool.prefix_index)
        assert len(pool.prefix_index) >= 3
