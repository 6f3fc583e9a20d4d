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
    return _cfg("llama3-8b")


def _cfg(arch):
    return dataclasses.replace(get_config(arch).reduced(), **F32)


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


ARCHS = ["llama3-8b", "mixtral-8x7b", "recurrentgemma-9b"]


@pytest.mark.parametrize("arch", ARCHS)
def test_token_streams_match_reference_engine(arch):
    """Slice-level parity: the same 4 prompts x 16 greedy tokens through
    the reference RealEngine and the port's, on the same weights, give
    identical token streams (float32 isolates the algorithm), dense, MoE
    and hybrid."""
    cfg = _cfg(arch)
    jcfg = dataclasses.replace(jax_config(arch).reduced(), **F32)
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


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("repl_async", [True, False])
def test_failover_byte_identical_from_promoted_blocks(arch, repl_async):
    """Kill the busy instance mid-decode: every victim resumes on the ring
    target from PROMOTED replica blocks (and, on the hybrid, the promoted
    state blob) whose bytes equal the dead primary's last replicated
    state, and every token stream equals the failure-free run's — with
    copies shipped a step later (async) or in the step that staged them;
    dense, MoE and hybrid."""
    cfg = _cfg(arch)

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
            blobs = {rid: src.pool.blobs[src.pool.blob_ref(rid).slot].clone()
                     for rid in victims} if cfg.arch_type == "hybrid" else {}
            resumed = eng.fail_instance(0)
            assert set(resumed) == set(victims)
            for rid in victims:
                assert tgt.pool.replica_table(0, rid) == []   # promoted
                slots = [r.slot for r in tgt.pool.table(rid)]
                assert torch.equal(tgt.pool.k[:, :, slots], frozen[rid][0])
                assert torch.equal(tgt.pool.v[:, :, slots], frozen[rid][1])
                if blobs:       # the blob is the dead primary's, bit for bit
                    assert tgt.pool.blob_replica_ref(0, rid) is None
                    got = tgt.pool.blobs[tgt.pool.blob_ref(rid).slot]
                    assert got.view(torch.int32).tolist() == \
                        blobs[rid].view(torch.int32).tolist()
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


def test_hybrid_replication_ships_one_block_and_one_blob_per_request_step():
    """Hybrid: each steady decode step dirties one KV page row and the
    whole recurrent state, so delta replication ships at most one block
    and exactly one blob per active request (the reference's
    tests/test_engine.py hybrid accounting), and the bytes are blocks and
    blobs times their sizes."""
    cfg = _cfg("recurrentgemma-9b")
    eng = _engine(cfg, max_slots=4)
    for r in _reqs(cfg, 6, prompt=20, out=30):
        eng.submit(r)
    for _ in range(4):                       # admit + initial prompt copy
        eng.step()
    for _ in range(5):                       # steady-state decode
        n_active = sum(len(i.requests) for i in eng.instances)
        blocks, blobs = eng.repl_blocks_total, eng.repl_blobs_total
        eng.step()
        assert 0 <= eng.repl_blocks_total - blocks <= n_active
        assert eng.repl_blobs_total - blobs == n_active
    stats = eng.replication_stats()
    pool = eng.instances[0].pool
    # blocks: the prompt pages' first copy adds to the steady one a step
    assert stats["blocks_per_request_step"] <= 1.5
    assert 0.5 < stats["blobs_per_request_step"] <= 1.0
    assert stats["bytes_total"] == stats["blocks_total"] * pool.block_nbytes \
        + stats["blobs_total"] * pool.blob_nbytes
    # one KV block: the attention layer's K and V rows of a page; one blob:
    # both RG-LRU layers' h and conv state in f32
    assert pool.block_nbytes == 2 * 1 * 1 * 8 * 64 * 4
    assert pool.blob_nbytes == 4 * 2 * (256 + 3 * 256)


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
    """Every EngineConfig knob is ported; what the engine still refuses is
    a family other than the dense one (the SSM family is served through
    the model API, as in the reference)."""
    ssm_cfg = get_config("mamba2-130m").reduced()
    for kw in ({}, dict(prefix_cache=True, disaggregate=True,
                        prefill_chunk=8)):
        with pytest.raises(NotImplementedError, match="ssm"):
            _engine(ssm_cfg, **kw)
    for kw in (dict(prefix_cache=True), dict(disaggregate=True,
                                             prefill_chunk=8)):
        assert _engine(cfg, **kw).ecfg == EngineConfig(max_slots=8,
                                                       max_seq=96, **kw)


@pytest.mark.parametrize("arch,window,n_new,kill_at", [
    ("llama3-8b", 24, 40, 20),
    ("mixtral-8x7b", 24, 40, 20),
    ("mixtral-8x7b", 64, 80, 62),        # mixtral's own reduced window
    ("recurrentgemma-9b", 64, 80, 62)])  # the hybrid's local attention
def test_windowed_serving_matches_reference_and_fails_over(arch, window,
                                                           n_new, kill_at):
    """Sliding-window serving past the window (page recycling, window-
    relative tables, the kernel's ``starts`` mask): greedy streams equal
    the reference engine's, residency stays within the window ring, and a
    kill mid-slide resumes byte-identically from the promoted window."""
    cfg = _cfg(arch)
    max_seq = n_new + 56
    wcfg = dataclasses.replace(cfg, sliding_window=window)
    jcfg = dataclasses.replace(jax_config(arch).reduced(), **F32,
                               sliding_window=window)
    jeng = JRealEngine(jcfg, JEngineConfig(max_slots=4, max_seq=max_seq,
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
        eng = RealEngine(wcfg, EngineConfig(max_slots=4, max_seq=max_seq),
                         n_instances=2, device="cpu", params=params)
        reqs = submit(eng, Request)
        peak = 0
        for step in range(400):
            if not eng.has_pending():
                break
            eng.step()
            if fail and step == kill_at:
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
