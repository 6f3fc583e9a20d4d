"""The hybrid family (RecurrentGemma: RG-LRU + local MQA attention) in the
port against the reference, on the reduced config (3 layers: rglru, rglru,
attn; d 256, H 4 / K 1, D 64, lru_width 256, window 64, page 8) with the
reference's weights carried across by ``convert.from_jax_numpy``; inputs
from numpy with a seed. float32 isolates the algorithm; bf16 is held at the
reference tests' bf16 tolerance. Then the port's own invariants, torch
against torch: the paged stream equals the model API's, chunked prefill
equals monolithic prefill, and the int8 blob stays int8 within the
quantization bound.

Tolerances (float32). The port runs the RG-LRU recurrence sequentially
where the reference runs an associative scan: the two sum in another
order, so the scan is held at rtol 1e-5 / atol 1e-6 (the largest
difference seen is 1.2e-7 on values near 2.7), and whole-model logits at
1e-4 (seen: under 1e-5)."""
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
from repro.kernels.paged_attention_int8 import \
    quantize_pages as jquantize  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.models import hybrid as JH  # noqa: E402
from repro.models import paged_decode as JPD  # noqa: E402
from repro.serving.engine import EngineConfig as JEngineConfig  # noqa: E402
from repro.serving.engine import RealEngine as JRealEngine  # noqa: E402
from repro.serving.request import Request as JRequest  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import from_jax_numpy  # noqa: E402
from repro_torch.kernels.paged_attention_int8 import \
    quantize_pages  # noqa: E402
from repro_torch.models import api, hybrid as H  # noqa: E402
from repro_torch.models import paged_decode as PD  # noqa: E402

ARCH = "recurrentgemma-9b"
F32 = dict(dtype="float32", kv_dtype="float32")
TOL = 1e-4                 # float32 logits / activations vs the reference
SCAN_TOL = dict(rtol=1e-5, atol=1e-6)
BF16_TOL = 3e-2            # bf16, relative to the largest |value|


def _pair(dtype="float32"):
    kw = dict(dtype=dtype, kv_dtype=dtype)
    jcfg = dataclasses.replace(jax_config(ARCH).reduced(), **kw)
    cfg = dataclasses.replace(get_config(ARCH).reduced(), **kw)
    jp = japi.init_params(jcfg, jax.random.PRNGKey(0))
    tp = from_jax_numpy(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    return cfg, jcfg, tp, jp


@pytest.fixture(scope="module")
def f32():
    return _pair("float32")


@pytest.fixture(scope="module")
def bf16():
    return _pair("bfloat16")


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      np.asarray(x, np.float32))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


def _bits(x):
    """A tensor's bytes, for bit-for-bit comparisons."""
    return x.contiguous().view(torch.uint8).numpy().tobytes()


def _randn(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _tokens(cfg, seed, *shape):
    return np.random.default_rng(seed).integers(
        1, cfg.vocab_size, shape).astype(np.int32)


# --------------------------------------------------------------------------
# the config and the model API's dispatch
# --------------------------------------------------------------------------

def test_config_and_dispatch():
    cfg = get_config(ARCH)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jax_config(ARCH))
    assert api.family(cfg) is H
    assert PD.PAGED_FAMILIES == ("dense", "moe", "hybrid")
    red = cfg.reduced()
    assert red.layer_kinds() == ("rglru", "rglru", "attn")
    assert PD.kv_layer_indices(red) == (2,)
    assert H.recurrent_layer_indices(red) == (0, 1)
    assert H.state_blob_words(cfg) == 26 * 4 * 4096


# --------------------------------------------------------------------------
# RG-LRU pieces
# --------------------------------------------------------------------------

def test_softplus_is_jax_softplus():
    x = np.linspace(-40, 40, 801).astype(np.float32)
    np.testing.assert_allclose(H.softplus(torch.from_numpy(x)).numpy(),
                               np.asarray(jax.nn.softplus(x)), rtol=1e-6,
                               atol=1e-7)


def test_gates(f32):
    _, _, tp, jp = f32
    x = _randn(1, 2, 9, 256)
    for layer in (0, 1):
        jl, jg = JH._rglru_gates(jp["layers"][layer], jnp.asarray(x))
        tl, tg = H._rglru_gates(tp["layers"][layer], torch.from_numpy(x))
        assert tl.dtype == tg.dtype == torch.float32
        _close(tl, jl, 1e-6)
        _close(tg, jg, 1e-6)
        # the kept f32 copies give the per-call upcast's bits
        kl, kg = H._rglru_gates(tp["layers"][layer], torch.from_numpy(x),
                                H.f32_gates(tp["layers"][layer]))
        assert torch.equal(kl, tl) and torch.equal(kg, tg)


@pytest.mark.parametrize("with_state", [False, True])
def test_conv1d_and_its_state(f32, with_state):
    _, _, tp, jp = f32
    x = _randn(2, 2, 7, 256)
    st = _randn(3, 2, 3, 256) if with_state else None
    p, q = jp["layers"][0], tp["layers"][0]
    jy, js = JH._conv1d(jnp.asarray(x), p["conv_w"], p["conv_b"],
                        None if st is None else jnp.asarray(st))
    ty, ts = H._conv1d(torch.from_numpy(x), q["conv_w"], q["conv_b"],
                       None if st is None else torch.from_numpy(st))
    _close(ty, jy, 1e-6)
    assert np.array_equal(ts.numpy(), np.asarray(js))   # copied rows


@pytest.mark.parametrize("h0", [False, True])
def test_rglru_scan_sequential_vs_associative(f32, h0):
    _, _, tp, jp = f32
    x = _randn(4, 2, 50, 256)
    h = _randn(5, 2, 256) if h0 else None
    jh, jlast = JH.rglru_scan(jp["layers"][0], jnp.asarray(x),
                              None if h is None else jnp.asarray(h))
    th, tlast = H.rglru_scan(tp["layers"][0], torch.from_numpy(x),
                             None if h is None else torch.from_numpy(h))
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **SCAN_TOL)
    np.testing.assert_allclose(tlast.numpy(), np.asarray(jlast), **SCAN_TOL)


def test_rglru_scan_resumes_bit_for_bit(f32):
    """Two halves, the second resumed from the first's last h, give the
    bits of one pass (the sequential order is the point)."""
    _, _, tp, _ = f32
    x = torch.from_numpy(_randn(6, 2, 40, 256))
    whole, _ = H.rglru_scan(tp["layers"][1], x)
    a, last = H.rglru_scan(tp["layers"][1], x[:, :17])
    b, _ = H.rglru_scan(tp["layers"][1], x[:, 17:], last)
    assert torch.equal(torch.cat([a, b], 1), whole)


def test_rglru_step(f32):
    _, _, tp, jp = f32
    x, h = _randn(7, 3, 256), _randn(8, 3, 256)
    jn, _ = JH.rglru_step(jp["layers"][0], jnp.asarray(x), jnp.asarray(h))
    tn, _ = H.rglru_step(tp["layers"][0], torch.from_numpy(x),
                         torch.from_numpy(h))
    _close(tn, jn, 1e-6)


@pytest.mark.parametrize("true_len", [1, 2, 13, 32])
def test_recurrent_prefill_state_at_true_len(f32, true_len):
    cfg, jcfg, tp, jp = f32
    x = _randn(9, 1, 32, 256)
    jx, jh, jc = JH.recurrent_prefill(jcfg, jp["layers"][1], jnp.asarray(x),
                                      jnp.int32(true_len))
    tx, th, tc = H.recurrent_prefill(cfg, tp["layers"][1],
                                     torch.from_numpy(x), true_len)
    _close(tx, jx)
    _close(th, jh)
    assert tc.dtype == torch.bfloat16
    _close(tc, jc, 1e-2)                         # bf16-rounded rows


@pytest.mark.parametrize("take", [1, 5, 16])
def test_recurrent_prefill_resume(f32, take):
    cfg, jcfg, tp, jp = f32
    x = _randn(10, 1, 16, 256)
    h = _randn(11, 1, 256)
    conv = _randn(12, 1, 3, 256)
    jst = {"h": jnp.asarray(h), "conv": jnp.asarray(conv).astype(jnp.bfloat16)}
    tst = {"h": torch.from_numpy(h),
           "conv": torch.from_numpy(conv).to(torch.bfloat16)}
    jx, jh, jc = JH.recurrent_prefill_resume(jcfg, jp["layers"][0],
                                             jnp.asarray(x), jnp.int32(take),
                                             jst)
    tx, th, tc = H.recurrent_prefill_resume(cfg, tp["layers"][0],
                                            torch.from_numpy(x), take, tst)
    _close(tx, jx)
    _close(th, jh)
    _close(tc, jc, 1e-2)


def test_blob_codec_round_trip_bit_for_bit(f32):
    cfg, jcfg, _, _ = f32
    rng = np.random.default_rng(13)
    states = [{"h": torch.from_numpy(rng.standard_normal((3, 256)).astype(
                   np.float32)),
               "conv": torch.from_numpy(rng.standard_normal(
                   (3, 3, 256)).astype(np.float32)).to(torch.bfloat16)}
              for _ in H.recurrent_layer_indices(cfg)]
    blob = H.pack_state_blob(cfg, states)
    assert blob.shape == (3, H.state_blob_words(cfg))
    assert blob.dtype == torch.float32
    back = H.unpack_state_blob(cfg, blob)
    for a, b in zip(states, back):
        assert _bits(a["h"]) == _bits(b["h"])
        assert b["conv"].dtype == torch.bfloat16
        assert _bits(a["conv"]) == _bits(b["conv"])
    # the reference's packing of the same states, word for word
    jblob = JH.pack_state_blob(jcfg, [
        {"h": jnp.asarray(s["h"].numpy()),
         "conv": jnp.asarray(s["conv"].float().numpy()).astype(jnp.bfloat16)}
        for s in states])
    assert np.array_equal(np.asarray(jblob), blob.numpy())


# --------------------------------------------------------------------------
# model API
# --------------------------------------------------------------------------

def test_forward(f32):
    cfg, jcfg, tp, jp = f32
    toks = _tokens(cfg, 14, 2, 40)
    _close(H.forward(cfg, tp, torch.from_numpy(toks)),
           JH.forward(jcfg, jp, jnp.asarray(toks)))


def test_forward_bf16(bf16):
    cfg, jcfg, tp, jp = bf16
    toks = _tokens(cfg, 15, 2, 40)
    got = _np(H.forward(cfg, tp, torch.from_numpy(toks)))
    want = _np(JH.forward(jcfg, jp, jnp.asarray(toks)))
    assert np.abs(got - want).max() <= BF16_TOL * np.abs(want).max()


def test_prefill_and_ring_decode(f32):
    """prefill then 20 decode steps over a 24-row ring-buffer cache (the
    window wraps at step 4): logits at every step and the cache."""
    cfg, jcfg, tp, jp = f32
    toks = _tokens(cfg, 16, 2, 20)
    cap = 24
    jl, jc, jpos = JH.prefill(jcfg, jp, jnp.asarray(toks), capacity=cap)
    tl, tc, tpos = H.prefill(cfg, tp, torch.from_numpy(toks), capacity=cap)
    assert tpos == jpos == 20
    _close(tl, jl)
    tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
    for step in range(20):
        jl, jc = JH.decode_step(jcfg, jp, jnp.asarray(tok), jc, 20 + step)
        tl, tc = H.decode_step(cfg, tp, torch.from_numpy(tok), tc,
                               20 + step)
        _close(tl, jl)
        tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
    for key in jc:
        for name in jc[key]:
            tol = 1e-2 if name == "conv" else TOL
            _close(tc[key][name], jc[key][name], tol)


def test_init_params_and_cache_match_reference_tree(f32):
    cfg, jcfg, tp, _ = f32
    own = api.init_params(cfg, torch.Generator().manual_seed(0),
                          device="cpu")
    assert isinstance(own["layers"], list)
    for a, b in zip(own["layers"], tp["layers"]):
        assert a.keys() == b.keys()
        for k in a:
            if isinstance(a[k], dict):
                assert {n: (t.shape, t.dtype) for n, t in a[k].items()} == \
                    {n: (t.shape, t.dtype) for n, t in b[k].items()}
            else:
                assert (a[k].shape, a[k].dtype) == (b[k].shape, b[k].dtype)
    jc = JH.init_cache(jcfg, 2, 0)
    tc = H.init_cache(cfg, 2, 0, device="cpu")
    assert jc.keys() == tc.keys()
    for key in jc:
        for name in jc[key]:
            assert tuple(tc[key][name].shape) == jc[key][name].shape
            assert str(tc[key][name].dtype).removeprefix("torch.") == \
                jc[key][name].dtype.name


# --------------------------------------------------------------------------
# the paged path
# --------------------------------------------------------------------------

def _bucketed(cfg, n, seed):
    bucket = PD.next_bucket(n, lo=cfg.page_size)
    toks = np.zeros((1, bucket), np.int32)
    toks[0, :n] = _tokens(cfg, seed, n)
    return toks


@pytest.mark.parametrize("n", [5, 21, 40])
def test_prefill_hybrid_bucketed(f32, n):
    cfg, jcfg, tp, jp = f32
    toks = _bucketed(cfg, n, n)
    jl, jk, jv, jb = JPD.prefill_hybrid_bucketed(jcfg, jp, jnp.asarray(toks),
                                                 jnp.int32(n))
    tl, tk, tv, tb = PD.prefill_hybrid_bucketed(cfg, tp,
                                                torch.from_numpy(toks), n)
    assert tl.dtype == torch.float32 and tb.shape == (1, cfg.lru_width * 8)
    _close(tl, jl)
    for got, want in ((tk, jk), (tv, jv)):
        assert tuple(got.shape) == want.shape
        _close(got[:, :n], np.asarray(want)[:, :n])
    _close(tb, jb, 1e-2)                 # the conv words are bf16-rounded


def _pool_after_prefill(cfg, tp, n, seed):
    """A pool holding one prompt's pages (block table 1..), its blob at
    slot 1; returns what one decode step needs."""
    toks = _bucketed(cfg, n, seed)
    logits, k, v, blob = PD.prefill_hybrid_bucketed(
        cfg, tp, torch.from_numpy(toks), n)
    page = cfg.page_size
    n_pages = -(-(n + 1) // page)
    kp, vp = PD.init_pages(cfg, n_pages + 2, page, device="cpu")
    pk, pv = PD.pack_pages(k, v, -(-n // page), page)
    kp[:, :, 1:1 + pk.shape[2]] = pk
    vp[:, :, 1:1 + pv.shape[2]] = pv
    blobs = torch.zeros((3, H.state_blob_words(cfg)))
    blobs[1] = blob[0]
    bt = torch.arange(1, 1 + n_pages, dtype=torch.int32)[None]
    tok = logits.argmax(-1).to(torch.int32)
    return tok, kp, vp, blobs, bt, torch.tensor([n], dtype=torch.int32)


@pytest.mark.parametrize("kv_quant", [False, True])
def test_decode_step_paged_hybrid(f32, kv_quant):
    """One step on both pools: next token and logits against the
    reference's step on the same pool, and the pool's page and blob bytes
    after the in-place writes (int8: the same payload and scales)."""
    cfg, jcfg, tp, jp = f32
    tok, kp, vp, blobs, bt, pos = _pool_after_prefill(cfg, tp, 19, 3)
    slots = torch.tensor([1], dtype=torch.int32)
    if kv_quant:
        (kp, ks), (vp, vs) = quantize_pages(kp), quantize_pages(vp)
        blobs, bs = quantize_pages(blobs)
        jargs = dict(k_scales=jnp.asarray(ks.float().numpy()).astype(
            jnp.bfloat16), v_scales=jnp.asarray(vs.float().numpy()).astype(
            jnp.bfloat16), blob_scales=jnp.asarray(bs.float().numpy()).astype(
            jnp.bfloat16))
        targs = dict(k_scales=ks, v_scales=vs, blob_scales=bs)
    else:
        jargs, targs = {}, {}
    jout = JPD.decode_step_paged_hybrid(
        jcfg, jp, jnp.asarray(tok.numpy()), jnp.asarray(kp.numpy()),
        jnp.asarray(vp.numpy()), jnp.asarray(blobs.numpy()),
        jnp.asarray(bt.numpy()), jnp.asarray(slots.numpy()),
        jnp.asarray(pos.numpy()), **jargs)
    nxt, logits = PD.decode_step_paged_hybrid(cfg, tp, tok, kp, vp, blobs,
                                              bt, slots, pos, **targs)
    assert nxt.tolist() == np.asarray(jout[0]).tolist()
    _close(logits, jout[1])
    _close(kp, jout[2])
    _close(vp, jout[3])
    if kv_quant:
        assert blobs.dtype == torch.int8
        # int8 words may round the other way where the two sums differ by
        # an ulp at a .5 boundary: at most one step, on few words
        diff = np.abs(blobs.numpy().astype(int)
                      - np.asarray(jout[4]).astype(int))
        assert diff.max() <= 1 and (diff > 0).mean() < 1e-3
        _close(targs["blob_scales"], jout[7], 1e-2)
    else:
        _close(blobs, jout[4], 1e-2)


def test_int8_blob_stays_int8_within_quantization_bound(f32):
    """The reference's bound (tests/test_paged_decode.py): one step over an
    int8 pool and int8 blob stays within 8% of the float step's largest
    logit."""
    cfg, _, tp, _ = f32
    tok, kp, vp, blobs, bt, pos = _pool_after_prefill(cfg, tp, 12, 0)
    slots = torch.tensor([1], dtype=torch.int32)
    (kq, ks), (vq, vs), (bq, bs) = (quantize_pages(kp), quantize_pages(vp),
                                    quantize_pages(blobs))
    _, lf = PD.decode_step_paged_hybrid(cfg, tp, tok, kp, vp, blobs, bt,
                                        slots, pos)
    _, lq = PD.decode_step_paged_hybrid(cfg, tp, tok, kq, vq, bq, bt, slots,
                                        pos, k_scales=ks, v_scales=vs,
                                        blob_scales=bs)
    assert kq.dtype == bq.dtype == torch.int8
    assert float((lq - lf).abs().max()) < 0.08 * float(lf.abs().max())
    # the quantizer is the reference's, word for word
    jq, js = jquantize(jnp.asarray(blobs.numpy()))
    assert np.array_equal(np.asarray(jq), quantize_pages(blobs)[0].numpy())


# --------------------------------------------------------------------------
# greedy streams: port against the reference, and torch against torch
# --------------------------------------------------------------------------

def _paged_greedy(cfg, tp, prompt, n_new, chunk=0):
    """One request through the port's paged path by hand: bucketed (or
    chunked) prefill into a pool, then decode steps with the window's page
    recycling done as the engine does (every resident page kept; the
    kernel's starts mask the rows below the window)."""
    n = len(prompt)
    page = cfg.page_size
    bucket = PD.next_bucket(n, lo=page)
    toks = np.zeros((1, bucket), np.int32)
    toks[0, :n] = prompt
    t = torch.from_numpy(toks)
    if chunk:
        kb, vb = PD.init_chunk_buffers(cfg, bucket, device="cpu")
        st = PD.init_hybrid_chunk_state(cfg, device="cpu")
        c = min(chunk, bucket)
        for c0 in range(0, n, c):
            logits, kb, vb, st, blob = PD.prefill_hybrid_chunk(
                cfg, tp, t[:, c0:c0 + c], c0, min(c, n - c0), kb, vb, st)
        k, v = kb.to(PD.kv_dtype(cfg)), vb.to(PD.kv_dtype(cfg))
    else:
        logits, k, v, blob = PD.prefill_hybrid_bucketed(cfg, tp, t, n)
    total_pages = -(-(n + n_new) // page)
    kp, vp = PD.init_pages(cfg, total_pages + 1, page, device="cpu")
    pk, pv = PD.pack_pages(k, v, -(-n // page), page)
    kp[:, :, 1:1 + pk.shape[2]] = pk
    vp[:, :, 1:1 + pv.shape[2]] = pv
    blobs = torch.zeros((2, H.state_blob_words(cfg)))
    blobs[1] = blob[0]
    bt = torch.arange(1, 1 + total_pages, dtype=torch.int32)[None]
    out = [int(logits.argmax(-1))]
    for i in range(n_new - 1):
        nxt, _ = PD.decode_step_paged_hybrid(
            cfg, tp, torch.tensor([out[-1]], dtype=torch.int32), kp, vp,
            blobs, bt, torch.tensor([1], dtype=torch.int32),
            torch.tensor([n + i], dtype=torch.int32))
        out.append(int(nxt[0]))
    return out, blob


def _api_greedy(mod, cfg, params, prompt, n_new, tensor):
    logits, cache, pos = mod.prefill(cfg, params, tensor([prompt]))
    out = [int(np.asarray(logits[0]).argmax())]
    for i in range(n_new - 1):
        logits, cache = mod.decode_step(cfg, params, tensor([out[-1]])[0]
                                        [None], cache, pos + i)
        out.append(int(np.asarray(logits[0]).argmax()))
    return out


def test_paged_stream_equals_reference_past_the_window(f32):
    """24 greedy tokens after a 50-token prompt (positions past the
    64-token window): the port's paged path equals the reference's paged
    engine program step for step."""
    cfg, jcfg, tp, jp = f32
    prompt = _tokens(cfg, 21, 50).tolist()
    got, _ = _paged_greedy(cfg, tp, prompt, 24)
    jeng = JRealEngine(jcfg, JEngineConfig(max_slots=2, max_seq=96,
                                           replicate=False),
                       n_instances=1, seed=0)
    # the engine's weights are the fixture's: the same init and key
    assert all(np.array_equal(a, b) for a, b in zip(
        jax.tree_util.tree_leaves(jeng.params),
        jax.tree_util.tree_leaves(jp)))
    jeng.submit(JRequest(rid=0, prompt_len=50, max_new_tokens=24,
                         arrival_time=0.0, prompt_tokens=prompt))
    want = jeng.run(200)[0].output_tokens
    assert got == want


def test_paged_stream_equals_model_api_stream(f32):
    """Torch against torch (the reference's tests/test_paged_decode.py
    hybrid case): the paged path's greedy stream equals the port's model
    API over its ring-buffer cache, inside the window."""
    cfg, _, tp, _ = f32
    for seed, n in ((30, 9), (31, 17)):
        prompt = _tokens(cfg, seed, n).tolist()
        want = _api_greedy(H, cfg, tp, prompt, 16,
                           lambda x: torch.tensor(x, dtype=torch.int32))
        got, _ = _paged_greedy(cfg, tp, prompt, 16)
        assert got == want


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_chunked_prefill_equals_monolithic(dtype, f32, bf16):
    """Chunks of 8 and 16 against one bucketed pass: the same greedy stream
    past the window; in bf16 the same blob bit for bit (the sequential
    scan resumes exactly and the carried conv rows are bf16 already), in
    float32 the carried conv rows are rounded to bf16 at each chunk
    boundary (as the reference's), so the blob is allclose."""
    cfg, _, tp, _ = bf16 if dtype == "bfloat16" else f32
    prompt = _tokens(cfg, 40, 45).tolist()
    want, wblob = _paged_greedy(cfg, tp, prompt, 24)
    for chunk in (8, 16):
        got, blob = _paged_greedy(cfg, tp, prompt, 24, chunk=chunk)
        assert got == want
        if dtype == "bfloat16":
            assert _bits(blob) == _bits(wblob)
        else:
            torch.testing.assert_close(blob, wblob, rtol=0, atol=2e-2)
