"""Shard-degraded serving in the port: a single-shard fault degrades the
instance — the surviving shards keep serving at reduced capacity — instead
of killing it. The drills hold the port to the reference's bar (no dropped
request, every stream equal to the failure-free run, the scheduled shard
rejoin restores HEALTHY at full capacity) and, on converted float32
weights, to the reference engine itself: the same streams, the same
``failure_events`` and the same ``control.describe()``. Then the engine's
shard semantics and the control plane's weighing of a degraded instance,
case for case as in tests/test_shard_degraded.py."""
import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs in parallel workers on few cores
torch.set_num_threads(1)
import jax  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.serving.engine import EngineConfig as JEngineConfig  # noqa: E402
from repro.serving.engine import RealEngine as JRealEngine  # noqa: E402
from repro.serving.request import Request as JRequest  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import from_jax_numpy  # noqa: E402
from repro_torch.serving.api_types import FaultSpec  # noqa: E402
from repro_torch.serving.controlplane import (  # noqa: E402
    ClusterView, LeastLoadedRouting, RecoveryPlanner, RendezvousPlacement,
    SuccessorPlacement)
from repro_torch.serving.engine import EngineConfig, RealEngine  # noqa: E402
from repro_torch.serving.request import Request  # noqa: E402

F32 = dict(dtype="float32", kv_dtype="float32")
ECFG_KWARGS = dict(max_slots=4, max_seq=64, placement="rendezvous",
                   n_shards=4)
DRILL = dict(auto_rejoin=True, rejoin_delay=4.0)


def _workload(cfg, n, seed=0, cls=Request, prefix=()):
    """The reference drill's workload; ``prefix`` is prepended to every
    prompt (shared pages for the prefix cache)."""
    rng = np.random.default_rng(seed)
    reqs = []
    for rid in range(n):
        plen = int(rng.integers(4, 14))
        toks = list(prefix) + rng.integers(1, cfg.vocab_size, plen).tolist()
        reqs.append(cls(
            rid=rid, prompt_len=len(toks),
            max_new_tokens=int(rng.integers(2, 7)), arrival_time=0.0,
            prompt_tokens=toks))
    return reqs


def _streams(eng):
    return {r.rid: r.output_tokens for r in eng.done}


def _read_views(eng):
    """What a consumer polls off either engine mid-run: the routed but
    unadmitted rids, the scheduled rejoins, the staged copy jobs and the
    replication tallies."""
    return (sorted(r.rid for r in eng.queued_requests()),
            list(eng._pending_rejoins),
            [(m["src"], m["dst"], m["kind"], m["nbytes"])
             for m in eng._pending_ship],
            eng.repl_blocks_staged, eng.repl_bytes_staged,
            eng.repl_bytes_dropped, eng.repl_blobs_total,
            eng.repl_blobs_staged)


def _port(cfg, n_instances, params=None, **kw):
    return RealEngine(cfg, EngineConfig(**{**ECFG_KWARGS, **kw}),
                      n_instances=n_instances, seed=0, device="cpu",
                      params=params)


def _failure_free(cfg, n_instances, reqs, params=None, **kw):
    eng = _port(cfg, n_instances, params=params, **kw)
    for r in reqs:
        eng.submit(r)
    eng.run(max_iters=2000)
    assert len(eng.done) == len(reqs)
    return _streams(eng)


def _degraded_drill(eng, reqs, on_fault=None, views=None):
    """Single-shard fault on the busiest instance of a loaded fleet at
    t=2; the scheduled shard rejoin (auto_rejoin) restores full capacity.
    Runs on the port's engine or the reference's (same API); ``views``,
    when given, gets the engine's read views after every step. Returns the
    victim instance id."""
    for r in reqs:
        eng.submit(r)
    victim = None
    steps = 0
    while (eng.has_pending() or eng.recovery_pending()) and steps < 3000:
        if victim is None and eng.t >= 2.0:
            inst = max((i for i in eng.instances if i.alive),
                       key=lambda i: (len(i.requests), -i.instance_id))
            victim = inst.instance_id
            eng.fail_shard(victim, 1)
            assert eng.control.view.state_of(victim) == "DEGRADED"
            assert inst.slot_cap == 3          # 3/4 shards survive
            assert inst.degraded_layout["surviving"] == 3
            if on_fault is not None:
                on_fault(eng, inst)
        if victim is not None:
            # the reduced-capacity executor is a hard cap
            inst = eng.instances[victim]
            if inst.lost_shards:
                assert len(inst.requests) <= inst.slot_cap
        eng.step()
        steps += 1
        if views is not None:
            views.append(_read_views(eng))
    assert victim is not None, "drill never fired"
    assert len(eng.done) == len(reqs), \
        f"dropped {len(reqs) - len(eng.done)} request(s) while degraded"
    view = eng.control.view
    assert view.state_of(victim) == "HEALTHY"
    assert eng.instances[victim].slot_cap == eng.ecfg.max_slots
    assert eng.instances[victim].degraded_layout is None
    assert view.epoch == 2
    assert not eng.control.planner.has_pending()
    events = eng.mttr_events()
    assert len(events) == 1 and events[0]["granularity"] == "shard"
    assert events[0]["shard_idx"] == 1 and events[0]["mttr"] > 0
    assert any(s[2] < 1.0 for s in eng.step_samples)
    return victim


@pytest.fixture(scope="module")
def cfg():
    return get_config("llama3-8b").reduced()


def test_shard_degraded_dense_8(cfg):
    """The tier-1 drill on the port: 8 instances, 16 requests, every
    stream equal to the port's failure-free run."""
    eng = _port(cfg, 8, **DRILL)
    _degraded_drill(eng, _workload(cfg, 16))
    assert _streams(eng) == _failure_free(cfg, 8, _workload(cfg, 16))


@pytest.mark.parametrize("arch", ["llama3-8b", "mixtral-8x7b",
                                  "recurrentgemma-9b"])
def test_shard_degraded_drill_matches_reference_engine(arch):
    """Converted float32 weights, dense, MoE and hybrid: the port's 8-instance
    drill gives the reference engine's streams, failure_events (every
    key), control.describe() and replication tallies (those landing on the
    degraded instance included) and, step for step, the same read views
    (queued requests, scheduled rejoins, staged jobs, staged and dropped
    tallies)."""
    jcfg = dataclasses.replace(jax_config(arch).reduced(), **F32)
    tcfg = dataclasses.replace(get_config(arch).reduced(), **F32)
    jeng = JRealEngine(jcfg, JEngineConfig(**ECFG_KWARGS, **DRILL),
                       n_instances=8, seed=0)
    params = from_jax_numpy(jax.tree_util.tree_map(np.asarray, jeng.params),
                            device="cpu")
    jviews, tviews = [], []
    jvictim = _degraded_drill(jeng, _workload(jcfg, 16, cls=JRequest),
                              views=jviews)
    teng = _port(tcfg, 8, params=params, **DRILL)
    tvictim = _degraded_drill(teng, _workload(tcfg, 16), views=tviews)
    assert tvictim == jvictim
    assert tviews == jviews
    # the rejoin was scheduled and copy jobs were staged along the way
    assert any(v[1] for v in tviews) and any(v[2] for v in tviews)
    assert _streams(teng) == _streams(jeng)
    assert teng.failure_events == jeng.failure_events
    assert teng.control.describe() == jeng.control.describe()
    trepl, jrepl = teng.replication_stats(), jeng.replication_stats()
    for key in ("blocks_total", "blobs_total", "bytes_to_degraded",
                "blocks_to_degraded", "retire_msgs_total"):
        assert trepl[key] == jrepl[key], key


def test_shard_degraded_drill_prefix_cache(cfg):
    """The drill under prefix_cache=True on prompts sharing two pages: the
    released excess gives its pages back through the pool's slot release,
    so interned pages are decref'd and stay cached, never freed; streams
    equal failure-free serving, and every alive pool drains to its scratch
    block plus its interned pages."""
    prefix = np.random.default_rng(9).integers(1, cfg.vocab_size,
                                               16).tolist()
    seen = {}

    def on_fault(eng, inst):
        pool = inst.pool
        seen["interned"] = len(pool.prefix_index)
        free = set(pool._free)
        assert all(e.slot not in free for e in pool.prefix_index.values())
        assert len(pool.live_requests()) == len(inst.requests) + 1

    eng = _port(cfg, 8, prefix_cache=True, **DRILL)
    _degraded_drill(eng, _workload(cfg, 16, prefix=prefix), on_fault)
    assert seen["interned"] >= 2
    assert _streams(eng) == _failure_free(
        cfg, 8, _workload(cfg, 16, prefix=prefix), prefix_cache=True)
    assert eng.prefix_stats()["prefix_cached_tokens"] > 0
    for inst in eng.instances:
        pool = inst.pool
        assert pool.replica_blocks_used() == 0
        assert pool.live_requests() == [-7]          # the scratch block
        assert all(e.refcount == 0 for e in pool.prefix_index.values())
        assert pool.n_used == 1 + len(pool.prefix_index)


def test_shard_degraded_drill_int8_pool(cfg):
    """The drill on the int8 pool: streams equal failure-free serving."""
    eng = _port(cfg, 8, kv_quant=True, **DRILL)
    _degraded_drill(eng, _workload(cfg, 16))
    assert _streams(eng) == _failure_free(cfg, 8, _workload(cfg, 16),
                                          kv_quant=True)


def test_shard_fault_on_prefill_role_keeps_handoffs_parked(cfg):
    """Disaggregated: a shard fault on a prefill-role instance with every
    slot streaming leaves the in-flight handoffs parked (the shards serving
    the stream survived) — nothing migrates or restarts — and the streams
    equal failure-free disaggregated serving."""
    kw = dict(prefill_chunk=8, disaggregate=True)
    reqs = _workload(cfg, 8, prefix=list(range(1, 17)))
    eng = _port(cfg, 4, **kw)
    for r in reqs:
        eng.submit(r)
    for _ in range(20):
        eng.step()
        if len(eng.instances[0].requests) == eng.ecfg.max_slots and all(
                rid in eng._handoffs for rid in eng.instances[0].requests):
            break
    assert len(eng.instances[0].requests) == eng.ecfg.max_slots
    eng.fail_shard(0, 2)
    ev = eng.failure_events[-1]
    assert ev["n_victims"] == 1
    assert ev["resumed"] == ev["restarted"] == 0
    assert len(eng.instances[0].requests) == eng.ecfg.max_slots
    eng.run(max_iters=2000)
    assert _streams(eng) == _failure_free(cfg, 4, _workload(
        cfg, 8, prefix=list(range(1, 17))), **kw)


# -- engine semantics -------------------------------------------------------


def _small_engine(cfg, **overrides):
    return _port(cfg, 3, **overrides)


def test_shard_fault_is_idempotent_and_epoch_bumps_once(cfg):
    eng = _small_engine(cfg)
    eng.fail_shard(0, 2)
    assert eng.control.view.lost_shards(0) == [2]
    assert eng.control.view.epoch == 1
    assert eng.fail_shard(0, 2) == []          # HTTP retry: no-op
    assert eng.control.view.epoch == 1
    assert len(eng.failure_events) == 1


def test_losing_last_shard_escalates_to_instance_death(cfg):
    eng = _small_engine(cfg, n_shards=2)
    eng.fail_shard(0, 0)
    assert eng.control.view.state_of(0) == "DEGRADED"
    eng.fail_shard(0, 1)                       # no surviving slice left
    assert eng.control.view.state_of(0) == "DEAD"
    assert not eng.instances[0].alive
    assert eng.failure_events[-1]["granularity"] == "instance"


def test_standard_recovery_escalates_shard_faults(cfg):
    """Standard mode has no degraded serving: a shard fault IS an instance
    failure."""
    eng = _small_engine(cfg, recovery="standard", replicate=False)
    eng.fail_shard(1, 0)
    assert eng.control.view.state_of(1) == "DEAD"
    assert eng.failure_events[-1]["granularity"] == "instance"


def test_apply_fault_if_busy_noops_on_idle_instance(cfg):
    eng = _small_engine(cfg)
    spec = FaultSpec(granularity="shard", instance_id=0, shard_idx=0,
                     if_busy=True)
    assert eng.apply_fault(spec) is None
    assert eng.control.view.state_of(0) == "HEALTHY"


def test_recover_conflicts_raise(cfg):
    eng = _small_engine(cfg)
    with pytest.raises(ValueError):
        eng.rejoin_shards(0)                   # not degraded
    eng.fail_instance(0)
    with pytest.raises(ValueError):
        eng.rejoin_shards(0)                   # dead: wrong granularity
    with pytest.raises(ValueError):
        eng.fail_shard(0, 0)                   # shard fault needs a server
    eng.rejoin_instance(0)
    with pytest.raises(ValueError):
        eng.rejoin_instance(0)                 # already alive


def test_degrade_migrates_only_excess_requests(cfg):
    """A full degraded instance sheds exactly the over-cap tail; the
    requests that stay keep their slots (and their bytes)."""
    eng = _port(cfg, 3, auto_rejoin=False)
    for r in _workload(cfg, 24):
        eng.submit(r)
    for _ in range(50):
        eng.step()
        inst = max(eng.instances, key=lambda i: len(i.requests))
        if len(inst.requests) == eng.ecfg.max_slots:
            break
    n_before = len(inst.requests)
    assert n_before == eng.ecfg.max_slots
    kept = {rid: (list(inst.pool.table(rid)), inst.slot_of(rid))
            for rid in list(inst.requests)[:inst.slot_cap]}
    eng.fail_shard(inst.instance_id, 0)
    ev = eng.failure_events[-1]
    assert ev["n_victims"] == n_before - inst.slot_cap == 1
    assert ev["resumed"] + ev["restarted"] == ev["n_victims"]
    assert set(inst.requests) <= set(kept)
    assert len(inst.requests) == inst.slot_cap
    for rid in inst.requests:
        table, slot = kept[rid]
        assert inst.pool.table(rid) == table and inst.slot_of(rid) == slot
    eng.run(max_iters=2000)
    assert len(eng.done) == 24                 # nothing dropped


# -- control plane weighs degradation ---------------------------------------


def test_routing_discounts_degraded_candidates():
    view = ClusterView(2)
    view.mark_degraded(1, 0)
    routing = LeastLoadedRouting(view=view, degraded_penalty=2.0)
    a = SimpleNamespace(instance_id=0)
    b = SimpleNamespace(instance_id=1)

    def load_of(table):
        return lambda c: table[c.instance_id]

    # healthy load 3 vs degraded load 2 * 2.0 = 4: the healthier peer wins
    assert routing.pick([a, b], load_of({0: 3, 1: 2})) is a
    # exact effective ties break toward the healthy instance
    assert routing.pick([a, b], load_of({0: 4, 1: 2})) is a
    # without a view the ordering is untouched
    assert LeastLoadedRouting().pick([a, b], load_of({0: 4, 1: 2})) is b


def test_placement_deprioritizes_degraded_ring_targets():
    for placement in (SuccessorPlacement(), RendezvousPlacement()):
        view = ClusterView(4)
        baseline = placement.target(0, view)
        view.mark_degraded(baseline, 0)
        rerouted = placement.target(0, view)
        assert rerouted != baseline            # degraded host avoided
        assert view.is_alive(rerouted)
        # ...but a degraded host beats no host at all
        for iid in range(1, 4):
            view.mark_degraded(iid, 0)
        assert placement.target(0, view) != -1


def test_planner_orders_mixed_granularities_earliest_first():
    view = ClusterView(4)
    planner = RecoveryPlanner(view)
    view.mark_degraded(2, 1)
    planner.on_failure(2, t_fail=1.0, rejoin_at=5.0, kind="shard")
    view.mark_failed(0)
    planner.on_failure(0, t_fail=2.0, rejoin_at=5.0, kind="instance")
    assert planner.pending_kind(2) == "shard"
    assert planner.pending_kind(0) == "instance"
    # one recovery per step, earliest failure first, kinds interleaved
    assert planner.next_due(5.0) == 2
    view.mark_restored(2)
    planner.on_rejoined(2, 5.0)
    assert planner.next_due(5.0) == 0
    grans = [p["granularity"] for p in planner.plan(SuccessorPlacement())]
    assert grans == ["instance"]


def test_planner_escalates_shard_record_on_death():
    """A death while a shard rejoin is pending upgrades the record: the
    whole pool is gone, so restoring one shard is meaningless."""
    view = ClusterView(4)
    planner = RecoveryPlanner(view)
    view.mark_degraded(1, 0)
    planner.on_failure(1, t_fail=1.0, rejoin_at=5.0, kind="shard")
    view.mark_failed(1)
    planner.on_failure(1, t_fail=2.0, rejoin_at=6.0, kind="instance")
    assert planner.pending_kind(1) == "instance"
    assert planner._pending[1]["fail_time"] == 1.0   # gone since t=1


def test_shard_death_then_instance_rejoin_closes_only_instance_event(cfg):
    """An instance that degrades and then dies: its warm-spare rejoin
    closes the instance event, and the shard event stays open (the restore
    it waited for never came)."""
    eng = _small_engine(cfg)
    eng.fail_shard(1, 3)
    eng.fail_instance(1)
    assert eng.control.planner.pending_kind(1) == "instance"
    eng.rejoin_instance(1)
    shard_ev, inst_ev = eng.failure_events
    assert shard_ev["granularity"] == "shard" and shard_ev["mttr"] < 0
    assert inst_ev["granularity"] == "instance" and inst_ev["mttr"] >= 0
    assert eng.instances[1].lost_shards == set()
    assert eng.control.view.state_of(1) == "HEALTHY"
