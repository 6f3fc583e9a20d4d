"""Dynamic traffic rerouting and mode-switched recovery on the port's
engine — the cases of tests/test_rerouting.py that tests/test_torch_engine.py
does not already hold: least-loaded spread, overflow to a peer with
headroom, the rejoined spare re-entering the replication ring, kevlarflow
MTTR against standard, rejoining an alive instance, draining after an
unrecovered failure, and an all-dead fleet keeping FIFO order."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs in parallel workers on few cores
torch.set_num_threads(1)

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.serving.engine import EngineConfig, RealEngine  # noqa: E402
from repro_torch.serving.request import Request  # noqa: E402


@pytest.fixture(scope="module")
def cfg():
    return get_config("llama3-8b").reduced()


def _reqs(cfg, n, seed=0, prompt=8, out=16, rid_base=0):
    rng = np.random.default_rng(seed)
    return [Request(rid=rid_base + i, prompt_len=prompt, max_new_tokens=out,
                    arrival_time=0.0,
                    prompt_tokens=rng.integers(1, cfg.vocab_size,
                                               prompt).tolist())
            for i in range(n)]


def _engine(cfg, n_instances=2, **kw):
    return RealEngine(cfg, EngineConfig(**kw), n_instances=n_instances,
                      seed=0, device="cpu")


def test_least_loaded_routing_spreads_arrivals(cfg):
    """Arrivals split evenly across idle instances (queue-depth-aware, not
    first-fit): with 2 instances and 6 requests, each gets 3."""
    eng = _engine(cfg, max_slots=4, max_seq=64, replicate=False)
    for r in _reqs(cfg, 6):
        eng.submit(r)
    eng.step()
    assert [len(i.requests) for i in eng.instances] == [3, 3]
    assert all(req.instance_id == inst.instance_id
               for inst in eng.instances for req in inst.requests.values())
    eng.run(200)
    assert len(eng.done) == 6


def test_queued_work_flows_to_peer_with_headroom(cfg):
    """A request queued on an instance that cannot admit it (busy slots)
    reroutes to a peer with free slots instead of waiting."""
    eng = _engine(cfg, max_slots=2, max_seq=64, replicate=False)
    # 5 requests > 2 x 2 slots: one stays queued after the first step
    for r in _reqs(cfg, 5, out=30):
        eng.submit(r)
    eng.step()
    assert sum(len(i.requests) for i in eng.instances) == 4
    assert len(eng.queued_requests()) == 1
    eng.run(400)
    assert len(eng.done) == 5


def test_rejoined_spare_reenters_replication_ring(cfg):
    """After a kill and a rejoin, the ring re-forms over the spare: killing
    the SURVIVOR next fails over byte-identically onto the rejoined
    spare."""
    def run(double_fail: bool):
        eng = _engine(cfg, max_slots=8, max_seq=96, auto_rejoin=True,
                      rejoin_delay=2.0)
        reqs = _reqs(cfg, 6, prompt=10, out=40)
        for r in reqs:
            eng.submit(r)
        for _ in range(4):
            eng.step()
        if double_fail:
            eng.fail_instance(0)
            for _ in range(6):            # rejoin at +2, then re-replicate
                eng.step()
            assert eng.instances[0].alive
            victims = list(eng.instances[1].requests)
            assert victims
            resumed = eng.fail_instance(1)
            assert set(resumed) == set(victims), \
                "survivor's requests must resume on the rejoined spare"
        eng.run(2000)
        return reqs

    normal = run(False)
    failed = run(True)
    assert any(r.n_migrations for r in failed)
    for rf, rn in zip(failed, normal):
        assert rf.output_tokens == rn.output_tokens
    assert all(r.n_retries == 0 for r in failed)


def test_kevlarflow_mttr_beats_standard(cfg):
    """On identical tick workloads, kevlarflow MTTR (a warm spare) is a
    fraction of the standard reload penalty."""
    def mttr(mode):
        eng = _engine(cfg, max_slots=8, max_seq=64, recovery=mode,
                      replicate=(mode == "kevlarflow"), auto_rejoin=True,
                      rejoin_delay=2.0, reload_penalty=40.0)
        for r in _reqs(cfg, 6, out=24):
            eng.submit(r)
        for _ in range(3):
            eng.step()
        eng.fail_instance(0)
        eng.run(600)
        while not eng.mttr_events():      # idle ticks until the rejoin lands
            eng.step()
        return eng.mttr_events()[0]["mttr"]

    kf, std = mttr("kevlarflow"), mttr("standard")
    assert kf < std / 10, (kf, std)


def test_rejoin_alive_instance_rejected(cfg):
    eng = _engine(cfg, max_slots=2, max_seq=64, replicate=False)
    with pytest.raises(ValueError, match="alive"):
        eng.rejoin_instance(0)


def test_engine_drains_after_unrecovered_failure(cfg):
    """Without auto_rejoin the dead instance stays down, but once the
    survivors finish everything has_pending() goes False (a dead instance
    holds no requests), so a drain or a clean shutdown returns."""
    eng = _engine(cfg, max_slots=8, max_seq=64)
    for r in _reqs(cfg, 6, out=16):
        eng.submit(r)
    for _ in range(3):
        eng.step()
    eng.fail_instance(0)
    assert not eng.instances[0].requests      # lost memory, not pending work
    eng.run(400)
    assert len(eng.done) == 6
    assert not eng.has_pending()
    assert not eng.recovery_pending()
    assert eng.control.planner.pending_kind(0) == "instance"


def test_all_instances_dead_keeps_requests_queued(cfg):
    """Killing the LAST alive instance loses and crashes nothing: victims
    park in the arrival buffer (in-flight work first, in its admission
    order, then the drained queues), new arrivals park behind them, and
    the first spare to rejoin admits the lot — byte-identical to a
    failure-free run."""
    eng = _engine(cfg, max_slots=8, max_seq=64)
    for r in _reqs(cfg, 6, out=12):
        eng.submit(r)
    for _ in range(2):
        eng.step()
    assert not eng.done                      # all six still in flight
    eng.fail_instance(0)
    eng.fail_instance(1)
    assert eng.control.view.n_alive() == 0
    assert [r.rid for r in eng.waiting] == [1, 3, 5, 0, 2, 4]
    eng.step()                               # a dead fleet steps safely
    late = _reqs(cfg, 1, rid_base=6, out=12)[0]
    eng.submit(late)
    eng.step()
    assert len(eng.waiting) == 7 and eng.waiting[-1].rid == 6
    assert not eng.done
    eng.rejoin_instance(0)
    assert not eng.waiting
    eng.run(600)
    assert len(eng.done) == 7
    ref = _engine(cfg, max_slots=8, max_seq=64)
    for r in _reqs(cfg, 6, out=12) + _reqs(cfg, 1, rid_base=6, out=12):
        ref.submit(r)
    ref.run(400)
    want = {r.rid: r.output_tokens for r in ref.done}
    assert {r.rid: r.output_tokens for r in eng.done} == want
