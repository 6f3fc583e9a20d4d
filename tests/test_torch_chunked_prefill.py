"""Chunked prefill in the PyTorch port.

Against the reference: ``init_chunk_buffers`` and ``prefill_chunk`` on
converted float32 weights. Torch against torch, the reference's own
invariants (tests/test_chunked_prefill.py): chunked prefill is a pure
scheduling change — the carry buffers, the logits, the pool's prompt pages
(raw int8 payload and scales on an int8 pool) and every sampled token equal
monolithic prefill's bit for bit — and a mid-chunk instance kill restarts
the mid-prefill victim while the decoding victim migrates."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs in parallel workers on few
# cores, and idle OpenMP threads spin and starve the other workers
torch.set_num_threads(1)
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.models import api  # noqa: E402
from repro.models import paged_decode as JPD  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import from_jax_numpy  # noqa: E402
from repro_torch.models import paged_decode as PD  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.serving.engine import EngineConfig, RealEngine  # noqa: E402
from repro_torch.serving.request import Request, RequestState  # noqa: E402

F32 = dict(dtype="float32", kv_dtype="float32")


def _mk_reqs(cfg, lens, out, seed=0):
    rng = np.random.default_rng(seed)
    return [Request(rid=i, prompt_len=n, max_new_tokens=out,
                    arrival_time=0.0,
                    prompt_tokens=rng.integers(1, cfg.vocab_size, n).tolist())
            for i, n in enumerate(lens)]


def _chunks(n, C, toks):
    """(start, take, (1, C) token rows) for each chunk of an n-token prompt
    in a bucket-padded row ``toks`` (a ragged final chunk included)."""
    for c0 in range(0, n, C):
        yield c0, min(C, n - c0), toks[:, c0:c0 + C]


def test_prefill_chunk_matches_reference():
    """Chunks of 8 over a 27-token prompt (3 full + a ragged 3), float32 on
    converted weights: the carry buffers and each chunk's logits agree with
    the reference's within 1e-4 (f32 on both sides, different summation
    orders), and the buffers have the reference's shape and dtype."""
    jcfg = dataclasses.replace(jax_config("llama3-8b").reduced(), **F32)
    cfg = dataclasses.replace(get_config("llama3-8b").reduced(), **F32)
    jp = api.init_params(jcfg, jax.random.PRNGKey(0))
    tp = from_jax_numpy(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    n, C = 27, 8
    bucket = PD.next_bucket(n, lo=cfg.page_size)
    toks = np.zeros((1, bucket), np.int32)
    toks[0, :n] = np.random.default_rng(0).integers(1, cfg.vocab_size, n)
    kb, vb = PD.init_chunk_buffers(cfg, bucket, device="cpu")
    jkb, jvb = JPD.init_chunk_buffers(jcfg, bucket)
    assert tuple(kb.shape) == jkb.shape and kb.dtype == torch.float32
    assert not kb.any() and not vb.any()
    for c0, take, tc in _chunks(n, C, toks):
        logits, kb, vb = PD.prefill_chunk(cfg, tp, torch.from_numpy(tc), c0,
                                          take, kb, vb)
        jl, jkb, jvb = JPD.prefill_chunk(jcfg, jp, jnp.asarray(tc),
                                         jnp.int32(c0), jnp.int32(take),
                                         jkb, jvb)
        assert logits.shape == (1, cfg.vocab_size)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jl),
                                   rtol=1e-4, atol=1e-4)
    for got, want in ((kb, jkb), (vb, jvb)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_chunk_prefill_matches_monolithic(dtype):
    """Model level, torch against torch: chunks of 8 (a ragged final chunk
    included) reproduce the monolithic prefill's KV rows in the pool's
    storage dtype and its last-position logits, bit for bit."""
    cfg = dataclasses.replace(get_config("llama3-8b").reduced(), dtype=dtype,
                              kv_dtype=dtype)
    params = transformer.init_params(cfg, torch.Generator().manual_seed(0),
                                     device="cpu")
    n, C = 27, 8
    bucket = PD.next_bucket(n, lo=cfg.page_size)
    toks = np.zeros((1, bucket), np.int32)
    toks[0, :n] = np.random.default_rng(0).integers(1, cfg.vocab_size, n)
    lm, km, vm = PD.prefill_bucketed(cfg, params, torch.from_numpy(toks), n)
    kb, vb = PD.init_chunk_buffers(cfg, bucket, device="cpu")
    for c0, take, tc in _chunks(n, C, toks):
        logits, kb, vb = PD.prefill_chunk(cfg, params, torch.from_numpy(tc),
                                          c0, take, kb, vb)
    kv_dt = PD.kv_dtype(cfg)
    for mono, chunked in ((km, kb), (vm, vb)):
        assert torch.equal(mono[:, :n], chunked[:, :n].to(kv_dt))
    assert torch.equal(logits, lm)


def _engine_run(cfg, chunk, kv_quant, lens=(27, 27), out=6):
    """Run to completion on one instance; snapshot request 0's prompt-row
    page bytes the moment it enters DECODE (before any decode row lands in
    its tail page)."""
    eng = RealEngine(cfg, EngineConfig(max_slots=4, max_seq=64,
                                       replicate=False, prefill_chunk=chunk,
                                       kv_quant=kv_quant),
                     n_instances=1, seed=0, device="cpu")
    reqs = _mk_reqs(cfg, lens, out)
    for r in reqs:
        eng.submit(r)
    inst = eng.instances[0]
    pages = None
    saw_prefilling = False
    for _ in range(500):
        if not eng.has_pending():
            break
        eng.step()
        saw_prefilling = saw_prefilling or inst.prefill_depth() > 0
        req = reqs[0]
        if pages is None and req.state in (RequestState.DECODE,
                                           RequestState.DONE) \
                and req.rid in inst.pool.live_requests():
            page = inst.pool.page_size
            pages = {}
            for ref in inst.pool.table(req.rid):
                valid = min(page, req.prompt_len - ref.logical_idx * page)
                if valid <= 0:
                    continue
                raw = (inst.pool.read_block_quantized(ref.slot)
                       if kv_quant else inst.pool.read_block(ref.slot))
                pages[ref.logical_idx] = [a[:, :, :valid].clone()
                                          for a in raw]
    assert not eng.has_pending()
    assert saw_prefilling == (chunk > 0)
    return [r.output_tokens for r in reqs], pages


@pytest.mark.parametrize("kv_quant", [False, True])
def test_engine_chunked_prefill_equivalent(kv_quant):
    """Engine level: prefill_chunk=8 vs monolithic — identical token streams
    AND byte-identical prompt pages in the pool (raw int8 payload and scales
    when quantized): the incremental page writes land exactly the bytes the
    single bulk write lands."""
    cfg = get_config("llama3-8b").reduced()
    mono_toks, mono_pages = _engine_run(cfg, 0, kv_quant)
    chunk_toks, chunk_pages = _engine_run(cfg, 8, kv_quant)
    assert chunk_toks == mono_toks
    assert mono_pages is not None and chunk_pages is not None
    assert set(chunk_pages) == set(mono_pages)
    for logical in mono_pages:
        for a, b in zip(mono_pages[logical], chunk_pages[logical]):
            assert a.dtype == b.dtype and torch.equal(a, b)


def _failover_run(cfg, kv_quant, fail_at, chunk=8, out=10):
    eng = RealEngine(cfg, EngineConfig(max_slots=4, max_seq=64,
                                       prefill_chunk=chunk,
                                       kv_quant=kv_quant),
                     n_instances=2, seed=0, device="cpu")
    # two short prompts (single chunk, decoding by the kill step) and two
    # long ones (still mid-chunk at the kill step); least-loaded routing
    # puts one of each on every instance
    reqs = _mk_reqs(cfg, (8, 8, 27, 27), out)
    for r in reqs:
        eng.submit(r)
    steps = 0
    while eng.has_pending() and steps < 500:
        eng.step()
        steps += 1
        if fail_at is not None and steps == fail_at:
            victim = eng.instances[0]
            assert victim.prefill_depth() > 0, \
                "kill must land mid-chunked-prefill"
            eng.fail_instance(0)
            assert victim.prefill_jobs == {}
    assert not eng.has_pending()
    return reqs


@pytest.mark.parametrize("kv_quant", [False, True])
def test_mid_chunk_kill_drill(kv_quant):
    """Kill an instance while one of its slots is mid-chunk. The decoding
    victim resumes from its replica (no retry), the mid-prefill victim
    restarts from scratch (replication skips requests still in PREFILL), and
    every request emits exactly the failure-free token stream."""
    cfg = get_config("llama3-8b").reduced()
    normal = _failover_run(cfg, kv_quant, fail_at=None)
    failed = _failover_run(cfg, kv_quant, fail_at=2)
    for rf, rn in zip(failed, normal):
        assert rf.output_tokens == rn.output_tokens
    # rid 0 (short, on instance 0) was decoding: seamless migration
    assert failed[0].n_migrations == 1 and failed[0].n_retries == 0
    # rid 2 (long, on instance 0) was mid-chunk: restarted, not migrated
    assert failed[2].n_retries == 1 and failed[2].n_migrations == 0
    assert all(len(r.output_tokens) == r.max_new_tokens for r in failed)
