"""The port's serving engine: token-stream parity with the reference engine
on converted weights, and — torch against torch — byte-identical failover
from promoted replica blocks, delta replication, queue rerouting and
warm-spare rejoin."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs in parallel workers on few
# cores, and idle OpenMP threads spin and starve the other workers
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


@pytest.fixture(scope="module")
def cfg():
    return dataclasses.replace(get_config("llama3-8b").reduced(), **F32)


def _prompts(vocab, n, seed=0, lo=5, hi=20):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, rng.integers(lo, hi)).tolist()
            for _ in range(n)]


def _reqs(cfg, n, seed=0, prompt=10, out=24, rid_base=0, cls=Request):
    rng = np.random.default_rng(seed)
    return [cls(rid=rid_base + i, prompt_len=prompt, max_new_tokens=out,
                arrival_time=0.0,
                prompt_tokens=rng.integers(1, cfg.vocab_size,
                                           prompt).tolist())
            for i in range(n)]


def _engine(cfg, n_instances=2, **kw):
    kw.setdefault("max_slots", 8)
    kw.setdefault("max_seq", 96)
    return RealEngine(cfg, EngineConfig(**kw), n_instances=n_instances,
                      seed=0, device="cpu")


def test_token_streams_match_reference_engine(cfg):
    """Slice-level parity: the same 4 prompts x 16 greedy tokens through
    the reference RealEngine and the port's, on the same weights, give
    identical token streams (float32 isolates the algorithm)."""
    jcfg = dataclasses.replace(jax_config("llama3-8b").reduced(), **F32)
    max_seq, n_new = 64, 16
    jeng = JRealEngine(jcfg, JEngineConfig(max_slots=4, max_seq=max_seq,
                                           replicate=False),
                       n_instances=1, seed=0)
    params = from_jax_numpy(jax.tree_util.tree_map(np.asarray, jeng.params),
                            device="cpu")
    teng = RealEngine(cfg, EngineConfig(max_slots=4, max_seq=max_seq,
                                        replicate=False),
                      n_instances=1, device="cpu", params=params)
    prompts = _prompts(cfg.vocab_size, 4)
    for eng, cls in ((jeng, JRequest), (teng, Request)):
        for i, p in enumerate(prompts):
            eng.submit(cls(rid=i, prompt_len=len(p), max_new_tokens=n_new,
                           arrival_time=0.0, prompt_tokens=p))
        assert len(eng.run(200)) == 4
    for i in range(4):
        want = next(r for r in jeng.done if r.rid == i).output_tokens
        got = next(r for r in teng.done if r.rid == i).output_tokens
        assert len(got) == n_new
        assert got == want, f"request {i}: port != reference"


@pytest.mark.parametrize("repl_async", [True, False])
def test_failover_byte_identical_from_promoted_blocks(cfg, repl_async):
    """Kill the busy instance mid-decode: every victim resumes on the ring
    target from PROMOTED replica blocks whose bytes equal the dead
    primary's last replicated state, and every token stream equals the
    failure-free run's — with copies shipped a step later (async) or in
    the step that staged them."""
    def run(fail: bool):
        eng = _engine(cfg, repl_async=repl_async)
        reqs = _reqs(cfg, 6)
        for r in reqs:
            eng.submit(r)
        for _ in range(6):
            eng.step()
        if fail:
            src, tgt = eng.instances
            victims = list(src.requests)
            assert victims
            # the last step's delta is staged, not yet shipped: the
            # promoted bytes must be what the primary holds NOW
            frozen = {rid: (src.pool.k[:, :, [r.slot for r in
                                              src.pool.table(rid)]].clone(),
                            src.pool.v[:, :, [r.slot for r in
                                              src.pool.table(rid)]].clone())
                      for rid in victims}
            resumed = eng.fail_instance(0)
            assert set(resumed) == set(victims)
            for rid in victims:
                assert tgt.pool.replica_table(0, rid) == []   # promoted
                slots = [r.slot for r in tgt.pool.table(rid)]
                assert torch.equal(tgt.pool.k[:, :, slots], frozen[rid][0])
                assert torch.equal(tgt.pool.v[:, :, slots], frozen[rid][1])
                assert tgt.requests[rid].n_migrations == 1
        eng.run(2000)
        return reqs

    normal = run(fail=False)
    failed = run(fail=True)
    assert any(r.n_migrations for r in failed)
    for rf, rn in zip(failed, normal):
        assert len(rf.output_tokens) == rf.max_new_tokens
        assert rf.output_tokens == rn.output_tokens
    assert all(r.n_retries == 0 for r in failed)


def test_delta_replication_ships_at_most_one_block_per_request_step(cfg):
    eng = _engine(cfg, max_slots=4)
    for r in _reqs(cfg, 6, prompt=20, out=30):
        eng.submit(r)
    for _ in range(4):                       # admit + initial prompt copy
        eng.step()
    for _ in range(5):                       # steady-state decode
        n_active = sum(len(i.requests) for i in eng.instances)
        before = eng.repl_blocks_total
        eng.step()
        delta = eng.repl_blocks_total - before
        assert 0 < delta <= n_active
    stats = eng.replication_stats()
    assert stats["blocks_per_request_step"] <= 1.5
    assert stats["bytes_total"] == \
        stats["blocks_total"] * eng.instances[0].pool.block_nbytes


def test_full_replication_mode_scales_with_cache(cfg):
    """Full mode re-copies every live block every step: strictly more
    traffic than delta mode on the same run."""
    def traffic(mode):
        eng = _engine(cfg, max_slots=4, replication=mode)
        for r in _reqs(cfg, 4, prompt=30, out=10):
            eng.submit(r)
        eng.run(200)
        return eng.replication_stats()

    full, delta = traffic("full"), traffic("delta")
    assert full["blocks_per_request_step"] > \
        2 * delta["blocks_per_request_step"]
    assert full["bytes_total"] > 2 * delta["bytes_total"]


def test_fail_instance_drains_queue_to_survivors(cfg):
    eng = _engine(cfg, max_slots=2, max_seq=64)
    for r in _reqs(cfg, 8, prompt=8, out=20):       # 8 > 4 slots
        eng.submit(r)
    for _ in range(3):
        eng.step()
    dead_q = list(eng.queues[0])
    assert dead_q, "test needs queued work on the victim instance"
    eng.fail_instance(0)
    assert eng.queues[0] == []
    assert eng.failure_events[0]["requeued"] == len(dead_q)
    eng.run(600)
    assert len(eng.done) == 8
    assert all(r.n_retries == 0 for r in dead_q)


def test_warm_spare_rejoin_serves_new_traffic(cfg):
    """The failed instance rejoins after rejoin_delay with the SAME weight
    tensors and programs (decoupled init) and picks up new arrivals."""
    eng = _engine(cfg, max_slots=4, max_seq=64, auto_rejoin=True,
                  rejoin_delay=3.0)
    for r in _reqs(cfg, 4, prompt=8, out=30):
        eng.submit(r)
    for _ in range(3):
        eng.step()
    eng.fail_instance(0)
    assert not eng.instances[0].alive
    for _ in range(5):                    # crosses rejoin_delay=3 ticks
        eng.step()
    spare = eng.instances[0]
    assert spare.alive
    assert spare.params is eng.params
    assert spare._decode is eng.instances[1]._decode
    events = eng.mttr_events()
    assert len(events) == 1
    assert events[0]["mttr"] == pytest.approx(3.0, abs=1.01)
    for r in _reqs(cfg, 2, prompt=8, out=10, rid_base=100):
        eng.submit(r)
    eng.step()
    assert len(spare.requests) == 2       # least-loaded: both go to the spare
    eng.run(400)
    assert len(eng.done) == 6


def test_standard_recovery_stalls_group_and_restarts(cfg):
    """standard mode: victims restart (nothing to promote), the whole group
    freezes for reload_penalty clock units, MTTR is the reload penalty."""
    eng = _engine(cfg, max_slots=4, max_seq=64, replicate=False,
                  recovery="standard", auto_rejoin=True, reload_penalty=10.0)
    reqs = _reqs(cfg, 6, prompt=8, out=24)
    for r in reqs:
        eng.submit(r)
    for _ in range(3):
        eng.step()
    victims = list(eng.instances[0].requests)
    survivor_prog = {rid: req.generated
                     for rid, req in eng.instances[1].requests.items()}
    assert victims
    assert eng.fail_instance(0) == []
    assert eng.recovery_pending()
    for _ in range(5):
        assert eng.step() == 0            # survivors stall too
    for rid, gen in survivor_prog.items():
        assert eng.instances[1].requests[rid].generated == gen
    eng.run(600)
    assert len(eng.done) == 6
    assert all(reqs[v].n_retries == 1 for v in victims)
    events = eng.mttr_events()
    assert events and events[0]["mttr"] == pytest.approx(10.0, abs=1.01)
    assert eng.instances[0].alive


def test_fail_instance_idempotent(cfg):
    eng = _engine(cfg, auto_rejoin=True, rejoin_delay=3.0)
    reqs = _reqs(cfg, 6)
    for r in reqs:
        eng.submit(r)
    for _ in range(4):
        eng.step()
    assert eng.fail_instance(0)
    assert eng.fail_instance(0) == []
    assert len(eng.failure_events) == 1
    assert len(eng.control.planner.pending_rejoins()) == 1
    eng.run(600)
    assert len(eng.done) == 6
    assert all(r.n_retries == 0 for r in reqs)


def test_unported_knobs_raise(cfg):
    for kw in (dict(prefix_cache=True), dict(disaggregate=True)):
        with pytest.raises(NotImplementedError):
            _engine(cfg, **kw)


def test_windowed_serving_matches_reference_and_fails_over(cfg):
    """Sliding-window serving past the window (page recycling, window-
    relative tables, the kernel's ``starts`` mask): greedy streams equal
    the reference engine's, residency stays within the window ring, and a
    kill mid-slide resumes byte-identically from the promoted window."""
    window, n_new = 24, 40
    wcfg = dataclasses.replace(cfg, sliding_window=window)
    jcfg = dataclasses.replace(jax_config("llama3-8b").reduced(), **F32,
                               sliding_window=window)
    jeng = JRealEngine(jcfg, JEngineConfig(max_slots=4, max_seq=96,
                                           replicate=False),
                       n_instances=1, seed=0)
    params = from_jax_numpy(jax.tree_util.tree_map(np.asarray, jeng.params),
                            device="cpu")
    prompts = _prompts(cfg.vocab_size, 2, seed=3, lo=10, hi=30)

    def submit(eng, cls):
        reqs = [cls(rid=i, prompt_len=len(p), max_new_tokens=n_new,
                    arrival_time=0.0, prompt_tokens=p)
                for i, p in enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
        return reqs

    want = submit(jeng, JRequest)
    jeng.run(400)

    def run(fail: bool):
        eng = RealEngine(wcfg, EngineConfig(max_slots=4, max_seq=96),
                         n_instances=2, device="cpu", params=params)
        reqs = submit(eng, Request)
        peak = 0
        for step in range(400):
            if not eng.has_pending():
                break
            eng.step()
            if fail and step == 20:
                assert set(eng.fail_instance(0)) == {0}
            for inst in eng.instances:
                for rid in inst.requests:
                    peak = max(peak, len(inst.pool.table(rid)))
        return reqs, peak, eng

    normal, peak, _ = run(fail=False)
    failed, _, eng = run(fail=True)
    ring = -(-window // cfg.page_size) + 1
    assert 0 < peak <= ring
    assert eng.retire_msgs_total > 0           # recycled pages were retired
    for w, n, f in zip(want, normal, failed):
        assert len(n.output_tokens) == n_new
        assert n.output_tokens == w.output_tokens
        assert f.output_tokens == n.output_tokens
    assert failed[0].n_migrations == 1 and failed[0].n_retries == 0
