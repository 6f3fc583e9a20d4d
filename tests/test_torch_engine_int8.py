"""The port's serving engine with the int8 KV pool and chunked prefill:
greedy token streams against the reference engine on converted weights,
each knob alone and both together, and — torch against torch — int8
failover that resumes byte-identically from the promoted payload and
scales, with replication messages the size of an int8 block."""
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
KNOBS = [dict(kv_quant=True), dict(prefill_chunk=8),
         dict(kv_quant=True, prefill_chunk=8)]


def _ids(kw):
    return "+".join(f"{k}={v}" for k, v in kw.items())


# every knob on the dense config, both on the MoE and the hybrid ones
CASES = [pytest.param("llama3-8b", kw, id=_ids(kw)) for kw in KNOBS] + [
    pytest.param(arch, KNOBS[2], id=f"{arch}+" + _ids(KNOBS[2]))
    for arch in ("mixtral-8x7b", "recurrentgemma-9b")]


def _reqs(cfg, lens, out, seed=0, cls=Request):
    rng = np.random.default_rng(seed)
    return [cls(rid=i, prompt_len=n, max_new_tokens=out, arrival_time=0.0,
                prompt_tokens=rng.integers(1, cfg.vocab_size, n).tolist())
            for i, n in enumerate(lens)]


@pytest.mark.parametrize("arch,knobs", CASES)
def test_token_streams_match_reference_engine(arch, knobs):
    """Slice-level parity: the same 4 prompts (5 to 27 tokens: one to four
    chunks of 8) x 12 greedy tokens through the reference RealEngine and
    the port's, on the same weights and the same knobs, give identical
    token streams (float32 isolates the algorithm)."""
    cfg = dataclasses.replace(get_config(arch).reduced(), **F32)
    jcfg = dataclasses.replace(jax_config(arch).reduced(), **F32)
    ecfg = dict(max_slots=4, max_seq=64, replicate=False, **knobs)
    jeng = JRealEngine(jcfg, JEngineConfig(**ecfg), n_instances=1, seed=0)
    params = from_jax_numpy(jax.tree_util.tree_map(np.asarray, jeng.params),
                            device="cpu")
    teng = RealEngine(cfg, EngineConfig(**ecfg), n_instances=1,
                      device="cpu", params=params)
    lens, n_new = (5, 13, 20, 27), 12
    for eng, cls in ((jeng, JRequest), (teng, Request)):
        for r in _reqs(cfg, lens, n_new, cls=cls):
            eng.submit(r)
        assert len(eng.run(300)) == len(lens)
    assert teng.instances[0].pool.quantized == knobs.get("kv_quant", False)
    for i in range(len(lens)):
        want = next(r for r in jeng.done if r.rid == i).output_tokens
        got = next(r for r in teng.done if r.rid == i).output_tokens
        assert len(got) == n_new
        assert got == want, f"request {i}: port != reference"


@pytest.mark.parametrize("knobs", KNOBS, ids=_ids)
def test_knobs_serve_on_cpu(knobs):
    """Each knob alone and both together serve the reduced bf16 config on
    the CPU with replication on; every replication message is one block
    of the pool (int8 payload and scales on an int8 pool)."""
    cfg = get_config("llama3-8b").reduced()
    eng = RealEngine(cfg, EngineConfig(max_slots=4, max_seq=64, **knobs),
                     n_instances=2, seed=0, device="cpu")
    reqs = _reqs(cfg, (8, 19, 27, 11, 30), 10)
    for r in reqs:
        eng.submit(r)
    assert len(eng.run(500)) == len(reqs)
    assert all(len(r.output_tokens) == 10 for r in reqs)
    pool = eng.instances[0].pool
    rows = cfg.n_layers * cfg.n_kv_heads * cfg.page_size
    if knobs.get("kv_quant"):
        assert pool.block_nbytes == 2 * rows * cfg.head_dim + 2 * rows * 2
    stats = eng.replication_stats()
    assert stats["blocks_total"] > 0
    assert stats["bytes_total"] == stats["blocks_total"] * pool.block_nbytes
    for inst in eng.instances:               # leak-free: only scratch left
        assert inst.pool.n_used == 1 and inst.prefill_depth() == 0


@pytest.mark.parametrize("arch,chunk", [
    pytest.param("llama3-8b", 0, id="0"), pytest.param("llama3-8b", 8, id="8"),
    pytest.param("mixtral-8x7b", 8, id="mixtral-8x7b-8"),
    pytest.param("recurrentgemma-9b", 8, id="recurrentgemma-9b-8")])
def test_int8_failover_byte_identical_from_promoted_blocks(arch, chunk):
    """Kill the busy instance mid-decode on an int8 pool: every victim
    resumes on the ring target from PROMOTED replica blocks whose int8
    payload AND scales equal the dead primary's (and, on the hybrid, a
    promoted int8 state blob and its scale equal to the dead primary's),
    and every token stream equals the failure-free run's (dense, and MoE
    and hybrid with chunks)."""
    cfg = dataclasses.replace(get_config(arch).reduced(), **F32)

    def run(fail: bool):
        eng = RealEngine(cfg, EngineConfig(max_slots=8, max_seq=96,
                                           kv_quant=True,
                                           prefill_chunk=chunk),
                         n_instances=2, seed=0, device="cpu")
        reqs = _reqs(cfg, (10,) * 6, 24)
        for r in reqs:
            eng.submit(r)
        for _ in range(6):
            eng.step()
        if fail:
            src, tgt = eng.instances
            victims = list(src.requests)
            assert victims and src.prefill_depth() == 0
            names = ("k", "v", "k_scale", "v_scale")
            frozen = {rid: [getattr(src.pool, n)[
                :, :, [r.slot for r in src.pool.table(rid)]].clone()
                for n in names] for rid in victims}
            hybrid = cfg.arch_type == "hybrid"
            blobs = {rid: [t[src.pool.blob_ref(rid).slot].clone() for t in
                           (src.pool.blobs, src.pool.blob_scales)]
                     for rid in victims} if hybrid else {}
            resumed = eng.fail_instance(0)
            assert set(resumed) == set(victims)
            for rid in victims:
                assert tgt.pool.replica_table(0, rid) == []   # promoted
                slots = [r.slot for r in tgt.pool.table(rid)]
                for n, want in zip(names, frozen[rid]):
                    assert torch.equal(getattr(tgt.pool, n)[:, :, slots],
                                       want), n
                if hybrid:
                    slot = tgt.pool.blob_ref(rid).slot
                    assert tgt.pool.blobs.dtype == torch.int8
                    assert torch.equal(tgt.pool.blobs[slot], blobs[rid][0])
                    assert torch.equal(tgt.pool.blob_scales[slot],
                                       blobs[rid][1])
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
