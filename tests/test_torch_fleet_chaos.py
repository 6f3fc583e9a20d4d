"""Fleet-scale chaos drills on the port: a correlated 3-instance kill, then
a storm that kills the first spare again the moment it rejoins, on an
8-instance engine (12 under ``slow``). Every request completes, every
stream equals the port's own failure-free run, and the fleet heals
(epoch 8, four closed MTTR events, at least one victim resumed from its
replica) — under both replication placements. On converted float32
weights the drill also gives the reference engine's streams,
``failure_events`` and ``control.describe()``, key for key."""
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
from repro.serving.request import Request as JRequest  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import from_jax_numpy  # noqa: E402
from repro_torch.serving.engine import EngineConfig, RealEngine  # noqa: E402
from repro_torch.serving.request import Request  # noqa: E402

F32 = dict(dtype="float32", kv_dtype="float32")
DRILL = dict(auto_rejoin=True, rejoin_delay=4.0)


def _workload(cfg, n, seed=0, cls=Request):
    rng = np.random.default_rng(seed)
    reqs = []
    for rid in range(n):
        plen = int(rng.integers(4, 14))
        reqs.append(cls(
            rid=rid, prompt_len=plen,
            max_new_tokens=int(rng.integers(2, 7)), arrival_time=0.0,
            prompt_tokens=rng.integers(1, cfg.vocab_size, plen).tolist()))
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


def _ecfg(placement, **kw):
    return EngineConfig(max_slots=4, max_seq=64, placement=placement, **kw)


def _chaos_drill(eng, reqs, views=None):
    """Correlated 3-instance kill at t=2, then the storm: the first spare
    back is killed again the moment it rejoins. Auto-rejoin brings the
    whole fleet home. Runs on the port's engine or the reference's;
    ``views``, when given, gets the engine's read views after every
    step."""
    n_instances = len(eng.instances)
    for r in reqs:
        eng.submit(r)
    correlated_done = False
    rekill_pending = True
    steps = 0
    while (eng.has_pending() or eng.recovery_pending()) and steps < 3000:
        if not correlated_done and eng.t >= 2.0:
            for iid in (0, 1, 2):
                eng.fail_instance(iid)
            correlated_done = True
        if rekill_pending and correlated_done and \
                eng.instances[0].alive and any(
                    e["instance"] == 0 and e["t_rejoin"] >= 0
                    for e in eng.failure_events):
            eng.fail_instance(0)       # the spare dies mid-recovery
            rekill_pending = False
        eng.step()
        steps += 1
        if views is not None:
            views.append(_read_views(eng))
    assert correlated_done and not rekill_pending, "drill never fired"
    assert len(eng.done) == len(reqs), \
        f"dropped {len(reqs) - len(eng.done)} request(s) in the storm"
    # the fleet healed completely: 4 kills + 4 rejoins, epoch == 8
    assert eng.control.view.n_alive() == n_instances
    assert eng.control.view.epoch == 8
    assert not eng.control.planner.has_pending()
    assert len(eng.mttr_events()) == 4
    assert sum(e["resumed"] for e in eng.failure_events) >= 1


def _drill_against_failure_free(placement, n_instances, n_requests):
    cfg = get_config("llama3-8b").reduced()
    eng = RealEngine(cfg, _ecfg(placement, **DRILL),
                     n_instances=n_instances, seed=0, device="cpu")
    _chaos_drill(eng, _workload(cfg, n_requests))
    ref = RealEngine(cfg, _ecfg(placement), n_instances=n_instances, seed=0,
                     device="cpu")
    for r in _workload(cfg, n_requests):
        ref.submit(r)
    ref.run(max_iters=2000)
    assert len(ref.done) == n_requests
    assert _streams(eng) == _streams(ref), \
        "a stream diverged from the failure-free run"
    return eng


@pytest.mark.parametrize("placement", ["successor", "rendezvous"])
def test_fleet_chaos_dense_8(placement):
    """Tier-1 drill: 8 instances, 16 requests."""
    eng = _drill_against_failure_free(placement, 8, 16)
    # the storm's second kill of instance 0 found it serving again
    kills0 = [e for e in eng.failure_events if e["instance"] == 0]
    assert len(kills0) == 2 and kills0[0]["t_rejoin"] <= kills0[1]["t_fail"]


@pytest.mark.parametrize("arch", ["llama3-8b", "mixtral-8x7b",
                                  "recurrentgemma-9b"])
def test_fleet_chaos_matches_reference_engine(arch):
    """Converted float32 weights, dense, MoE and hybrid (whose staged jobs
    carry state blobs: the views hold the blob tallies): the port's 8-instance
    storm gives the reference engine's streams, failure_events (every
    key), control.describe() and, step for step, the same read views
    (queued requests, scheduled rejoins, staged jobs, staged and dropped
    tallies)."""
    jcfg = dataclasses.replace(jax_config(arch).reduced(), **F32)
    tcfg = dataclasses.replace(get_config(arch).reduced(), **F32)
    kw = dict(max_slots=4, max_seq=64, placement="rendezvous", **DRILL)
    jeng = JRealEngine(jcfg, JEngineConfig(**kw), n_instances=8, seed=0)
    params = from_jax_numpy(jax.tree_util.tree_map(np.asarray, jeng.params),
                            device="cpu")
    jviews, tviews = [], []
    _chaos_drill(jeng, _workload(jcfg, 16, cls=JRequest), views=jviews)
    teng = RealEngine(tcfg, EngineConfig(**kw), n_instances=8,
                      device="cpu", params=params)
    _chaos_drill(teng, _workload(tcfg, 16), views=tviews)
    assert _streams(teng) == _streams(jeng)
    assert tviews == jviews
    # rejoins were scheduled and jobs bound for the dead were dropped
    assert any(v[1] for v in tviews) and any(v[5] for v in tviews)
    assert teng.failure_events == jeng.failure_events
    assert teng.control.describe() == jeng.control.describe()


@pytest.mark.slow
def test_fleet_chaos_dense_12():
    """The full acceptance drill: 12 instances, 24 requests."""
    _drill_against_failure_free("rendezvous", 12, 24)
