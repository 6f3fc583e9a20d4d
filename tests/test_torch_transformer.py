"""The port's non-paged dense model API (``models/transformer.py``, and the
VLM and encoder built on it) against the reference's, on float32 reduced
configs with converted params: forward (causal, windowed, encoder,
inputs_embeds), prefill (capacity and window override, int8 cache),
decode_step (full, ring buffer, int8) and decode_step_ragged within 1e-5.
Then the reference's ring-decode tests and its prefill + decode ==
forward test for the dense, VLM and MoE families, port against port."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs in parallel workers on few cores
torch.set_num_threads(1)
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.models import encoder as jenc  # noqa: E402
from repro.models import transformer as jT  # noqa: E402
from repro.models import vlm as jvlm  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import from_jax_numpy  # noqa: E402
from repro_torch.models import api, encoder, vlm  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
F32 = dict(dtype="float32", kv_dtype="float32")


def _pair(name, **over):
    over = {**F32, **over}
    jcfg = dataclasses.replace(jax_config(name).reduced(), **over)
    cfg = dataclasses.replace(get_config(name).reduced(), **over)
    jparams = japi.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = from_jax_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                             device="cpu")
    return jcfg, cfg, jparams, tparams


@pytest.fixture(scope="module", params=["yi-9b", "qwen1.5-0.5b"])
def dense(request):
    """GQA rep 2 (yi) and MHA with QKV bias (qwen)."""
    return _pair(request.param)


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(
        2, cfg.vocab_size, (b, s)).astype(np.int32)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tol)


# --------------------------------------------------------------------------
# against the reference
# --------------------------------------------------------------------------

@pytest.mark.parametrize("window", [None, 8])
def test_forward_matches_reference(dense, window):
    jcfg, cfg, jp, tp = dense
    toks = _tokens(cfg, 2, 24, seed=0)
    want = jT.forward(jcfg, jp, jnp.asarray(toks), window_override=window,
                      q_chunk=8)
    got = T.forward(cfg, tp, torch.from_numpy(toks), window_override=window,
                    q_chunk=8)
    assert got.shape == (2, 24, cfg.vocab_size) and got.dtype == torch.float32
    _close(got, want)


def test_forward_inputs_embeds_plus_tokens_matches_reference(dense):
    jcfg, cfg, jp, tp = dense
    toks = _tokens(cfg, 2, 12, seed=1)
    emb = np.random.default_rng(1).standard_normal(
        (2, 12, cfg.d_model)).astype(np.float32)
    want = jT.forward(jcfg, jp, jnp.asarray(toks), jnp.asarray(emb))
    got = T.forward(cfg, tp, torch.from_numpy(toks), torch.from_numpy(emb))
    _close(got, want)


@pytest.mark.parametrize("capacity,window", [(None, None), (32, None),
                                             (8, 8)])
def test_prefill_matches_reference(dense, capacity, window):
    """Full cache, a cache longer than the prompt (zero-padded), and a
    window shorter than the prompt (the last 8 positions kept)."""
    jcfg, cfg, jp, tp = dense
    toks = _tokens(cfg, 2, 20, seed=2)
    jl, jc, jpos = jT.prefill(jcfg, jp, jnp.asarray(toks), capacity=capacity,
                              window_override=window, q_chunk=8)
    tl, tc, tpos = T.prefill(cfg, tp, torch.from_numpy(toks),
                             capacity=capacity, window_override=window,
                             q_chunk=8)
    assert tpos == jpos == 20 and tl.dtype == torch.float32
    _close(tl, jl)
    assert set(tc) == set(jc)
    for name in tc:
        assert tuple(tc[name].shape) == jc[name].shape
        _close(tc[name], jc[name])


def test_decode_steps_match_reference(dense):
    """Prefill 10 tokens into a cache of 16, then 6 greedy decode steps
    (the position an int, then a 0-d tensor): logits and caches."""
    jcfg, cfg, jp, tp = dense
    toks = _tokens(cfg, 2, 10, seed=3)
    _, jc, _ = jT.prefill(jcfg, jp, jnp.asarray(toks), capacity=16)
    tl, tc, _ = T.prefill(cfg, tp, torch.from_numpy(toks), capacity=16)
    cur = tl.argmax(-1)
    for step in range(6):
        pos = 10 + step
        jl, jc = jT.decode_step(jcfg, jp, jnp.asarray(cur.numpy(), jnp.int32),
                                jc, jnp.int32(pos))
        tpos = pos if step % 2 else torch.tensor(pos, dtype=torch.int32)
        before = tc["k"].clone()
        tl, tc2 = T.decode_step(cfg, tp, cur, tc, tpos)
        assert torch.equal(tc["k"], before)          # input cache kept
        tc = tc2
        _close(tl, jl)
        _close(tc["k"], jc["k"])
        _close(tc["v"], jc["v"])
        cur = tl.argmax(-1)


def test_ring_decode_matches_reference():
    """A window of 8 with the cache as a ring: 20 decode steps wrap it
    twice."""
    jcfg, cfg, jp, tp = _pair("yi-9b", sliding_window=8,
                              long_context_window=0)
    toks = _tokens(cfg, 1, 6, seed=4)
    _, jc, _ = jT.prefill(jcfg, jp, jnp.asarray(toks), capacity=8, q_chunk=8)
    _, tc, _ = T.prefill(cfg, tp, torch.from_numpy(toks), capacity=8,
                         q_chunk=8)
    cur = np.array([3], np.int32)
    for pos in range(6, 26):
        jl, jc = jT.decode_step(jcfg, jp, jnp.asarray(cur), jc,
                                jnp.int32(pos), window=8)
        tl, tc = T.decode_step(cfg, tp, torch.from_numpy(cur.copy()), tc,
                               pos, window=8)
        _close(tl, jl)
        _close(tc["k"], jc["k"])
        cur = np.asarray(jnp.argmax(jl, -1), np.int32)


def test_int8_cache_matches_reference():
    """An int8 config: prefill quantizes the kept rows per (token, head),
    decode quantizes each new row and attends over the dequantized cache.
    Prefill: f32 logits within 1e-5; the payloads equal where both
    packages round the same f32 row the same way (a row whose f32 values
    differ in their last bits can land on the other side of a rounding
    boundary), the scales within a bf16 step. Decode, fed the reference's
    cache at every step (converted bit for bit): the new row's payload and
    scale equal, and the logits within 1e-5."""
    jcfg, cfg, jp, tp = _pair("yi-9b", kv_dtype="int8")
    toks = _tokens(cfg, 2, 12, seed=5)
    jl, jc, _ = jT.prefill(jcfg, jp, jnp.asarray(toks), capacity=16)
    tl, tc, _ = T.prefill(cfg, tp, torch.from_numpy(toks), capacity=16)
    assert tc["k"].dtype == torch.int8 and tc["k_scale"].dtype == \
        torch.bfloat16
    _close(tl, jl)
    for name in ("k", "v"):
        same = (tc[name].numpy() == np.asarray(jc[name])).mean()
        assert same > 0.99, (name, same)
        _close(tc[name + "_scale"], jc[name + "_scale"],
               dict(rtol=2 ** -7, atol=1e-6))
    cur = np.asarray(jnp.argmax(jl, -1), np.int32)
    for pos in range(12, 16):
        tc = from_jax_numpy(jax.tree_util.tree_map(np.asarray, jc),
                            device="cpu")
        jl, jc = jT.decode_step(jcfg, jp, jnp.asarray(cur), jc,
                                jnp.int32(pos))
        tl, tc = T.decode_step(cfg, tp, torch.from_numpy(cur.copy()), tc,
                               pos)
        for name in ("k", "v", "k_scale", "v_scale"):
            np.testing.assert_array_equal(
                tc[name][:, :, pos].float().numpy(),
                np.asarray(jc[name][:, :, pos], np.float32), err_msg=name)
        _close(tl, jl)
        cur = np.asarray(jnp.argmax(jl, -1), np.int32)


def test_quantize_matches_reference():
    x = np.random.default_rng(6).standard_normal((3, 5, 2, 16)).astype(
        np.float32)
    jq, js = jT._quantize(jnp.asarray(x))
    tq, ts = T._quantize(torch.from_numpy(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.float().numpy(),
                                  np.asarray(js, np.float32))
    _close(T._dequantize(tq, ts), jT._dequantize(jq, js), dict(rtol=0,
                                                               atol=0))


def test_decode_step_ragged_matches_reference(dense):
    """Rows at positions 5, 9 and 7 of one cache, two steps."""
    jcfg, cfg, jp, tp = dense
    jc = jT.init_cache(jcfg, 3, 16)
    tc = T.init_cache(cfg, 3, 16, device="cpu")
    rng = np.random.default_rng(7)
    for name in ("k", "v"):
        fill = rng.standard_normal(tc[name].shape).astype(np.float32)
        jc[name] = jnp.asarray(fill)
        tc[name] = torch.from_numpy(fill)
    pos = np.array([5, 9, 7], np.int32)
    tok = _tokens(cfg, 1, 3, seed=8)[0]
    for _ in range(2):
        jl, jc = jT.decode_step_ragged(jcfg, jp, jnp.asarray(tok), jc,
                                       jnp.asarray(pos))
        tl, tc = T.decode_step_ragged(cfg, tp, torch.from_numpy(tok), tc,
                                      torch.from_numpy(pos))
        _close(tl, jl)
        _close(tc["k"], jc["k"])
        _close(tc["v"], jc["v"])
        tok = tl.argmax(-1).numpy().astype(np.int32)
        pos = pos + 1


def test_decode_step_ragged_equals_decode_step_at_equal_positions(dense):
    _, cfg, _, tp = dense
    toks = _tokens(cfg, 2, 9, seed=9)
    _, cache, _ = T.prefill(cfg, tp, torch.from_numpy(toks), capacity=12)
    cur = torch.tensor([4, 11])
    a, ca = T.decode_step(cfg, tp, cur, cache, 9)
    b, cb = T.decode_step_ragged(cfg, tp, cur, cache,
                                 torch.tensor([9, 9]))
    torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(ca["k"], cb["k"], rtol=0, atol=0)


def test_vlm_forward_and_prefill_match_reference():
    jcfg, cfg, jp, tp = _pair("internvl2-76b")
    toks = _tokens(cfg, 2, 10, seed=10)
    patches = np.random.default_rng(10).standard_normal(
        (2, 6, cfg.d_model)).astype(np.float32)
    want = jvlm.forward(jcfg, jp, jnp.asarray(toks), jnp.asarray(patches),
                        q_chunk=8)
    got = vlm.forward(cfg, tp, torch.from_numpy(toks),
                      torch.from_numpy(patches), q_chunk=8)
    assert got.shape == (2, 16, cfg.vocab_size)
    _close(got, want)
    batch = {"tokens": toks, "patch_embeds": patches}
    jl, jc, jpos = japi.prefill(jcfg, jp, {k: jnp.asarray(v)
                                           for k, v in batch.items()},
                                seq_budget=24)
    tl, tc, tpos = api.prefill(cfg, tp, {k: torch.from_numpy(v)
                                         for k, v in batch.items()},
                               seq_budget=24)
    assert tpos == jpos == 16
    _close(tl, jl)
    _close(tc["k"], jc["k"])


def test_encoder_forward_and_masked_unit_loss_match_reference():
    jcfg, cfg, jp, tp = _pair("hubert-xlarge")
    rng = np.random.default_rng(11)
    frames = rng.standard_normal((2, 14, cfg.d_model)).astype(np.float32)
    targets = rng.integers(0, cfg.vocab_size, (2, 14)).astype(np.int32)
    mask = rng.random((2, 14)) < 0.5
    want = jenc.forward(jcfg, jp, jnp.asarray(frames), q_chunk=8)
    got = encoder.forward(cfg, tp, torch.from_numpy(frames), q_chunk=8)
    _close(got, want)
    # bidirectional: the first frame's output sees the last frame
    moved = frames.copy()
    moved[:, -1] += 1.0
    assert not torch.allclose(
        encoder.forward(cfg, tp, torch.from_numpy(moved))[:, 0], got[:, 0])
    wl = jenc.masked_unit_loss(jcfg, jp, jnp.asarray(frames),
                               jnp.asarray(targets), jnp.asarray(mask))
    tl = encoder.masked_unit_loss(cfg, tp, torch.from_numpy(frames),
                                  torch.from_numpy(targets),
                                  torch.from_numpy(mask))
    np.testing.assert_allclose(tl.item(), float(wl), rtol=1e-5)
    with pytest.raises(ValueError, match="encoder-only"):
        api.prefill(cfg, tp, {"tokens": torch.zeros(1, 4, dtype=torch.int32)})
    assert api.init_cache(cfg, 1, 8, device="cpu") is None


# --------------------------------------------------------------------------
# tests/test_ring_decode.py, on the port
# --------------------------------------------------------------------------

def test_ring_mechanics_exact_through_wraps():
    """kv_cache_update at slot t % w + attention with kv_len equals direct
    attention over the true last-w entries, for t spanning 3 wraps."""
    rng = np.random.default_rng(0)
    B, w, K, D, H = 2, 8, 2, 16, 4
    ring_k = torch.zeros((B, w, K, D))
    ring_v = torch.zeros((B, w, K, D))
    hist_k, hist_v = [], []
    for t in range(3 * w + 5):
        kt, vt = (torch.from_numpy(rng.standard_normal((B, 1, K, D)).astype(
            np.float32)) for _ in range(2))
        qt = torch.from_numpy(rng.standard_normal((B, 1, H, D)).astype(
            np.float32))
        hist_k.append(kt)
        hist_v.append(vt)
        slot = torch.tensor(t % w, dtype=torch.int32)
        ring_k = L.kv_cache_update(ring_k, kt, slot)
        ring_v = L.kv_cache_update(ring_v, vt, slot)
        out_ring = L.attention(qt, ring_k, ring_v, causal=False,
                               kv_len=torch.tensor(min(t + 1, w)))
        out_ref = L.attention(qt, torch.cat(hist_k[-w:], 1),
                              torch.cat(hist_v[-w:], 1), causal=False)
        torch.testing.assert_close(out_ring, out_ref, rtol=1e-5, atol=1e-5,
                                   msg=f"wrap mismatch at t={t}")


def test_model_ring_decode_streams_past_capacity():
    """Model-level: decode far past the window stays finite and is
    deterministic (the same stream twice gives the same ring)."""
    base = get_config("yi-9b").reduced()
    w = 16
    cfg = dataclasses.replace(base, sliding_window=w, long_context_window=0)
    params = api.init_params(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
    toks = torch.from_numpy(_tokens(cfg, 1, 8, seed=0))
    rings = []
    for _ in range(2):
        _, ring, pos = T.prefill(cfg, params, toks, capacity=w, q_chunk=8)
        cur = torch.tensor([3])
        for step in range(3 * w):
            logits, ring = T.decode_step(cfg, params, cur, ring, pos + step,
                                         window=w)
            assert torch.isfinite(logits).all(), step
            cur = logits.argmax(-1)
        rings.append(ring["k"])
    assert torch.equal(rings[0].float(), rings[1].float())


def test_long_context_policy_uses_ring():
    cfg = get_config("yi-9b")
    assert api.decode_window(cfg, 524_288) == cfg.long_context_window
    assert api.decode_window(cfg, 32_768) == 0        # full cache below 64k
    mix = get_config("mixtral-8x7b")
    assert api.decode_window(mix, 32_768) == mix.sliding_window
    assert api.decode_window(get_config("mamba2-130m"), 524_288) == 0


# --------------------------------------------------------------------------
# tests/test_models.py::test_prefill_decode_matches_forward, on the port
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["yi-9b", "internvl2-76b", "mixtral-8x7b"])
def test_prefill_decode_matches_forward(name):
    """The logits for token t from prefill(t tokens) + one decode step
    match the forward over t+1 tokens at position t (bf16 reduced config,
    the reference test's tolerance)."""
    cfg = get_config(name).reduced()
    params = api.init_params(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
    toks = torch.from_numpy(_tokens(cfg, 2, 17, seed=3))
    mod = api.family(cfg)
    batch = {"tokens": toks[:, :16]}
    # MoE: compare in the drop-free regime (capacity dropping depends on
    # the grouping, which differs between the two paths)
    moe_kw = ({"capacity_factor": float(cfg.n_experts)}
              if cfg.arch_type == "moe" else {})
    if cfg.arch_type == "vlm":
        batch["patch_embeds"] = torch.zeros((2, 0, cfg.d_model),
                                            dtype=torch.bfloat16)
        full = mod.forward(cfg, params, toks, None, q_chunk=32)
    else:
        full = mod.forward(cfg, params, toks, q_chunk=32, **moe_kw)
    if cfg.arch_type == "moe":
        logits_p, cache, pos = mod.prefill(
            cfg, params, batch["tokens"], capacity=32,
            window_override=cfg.sliding_window or None, q_chunk=32,
            capacity_factor=float(cfg.n_experts))
    else:
        logits_p, cache, pos = api.prefill(cfg, params, batch, seq_budget=32,
                                           q_chunk=32)
    tol = dict(rtol=0.08, atol=0.08)
    torch.testing.assert_close(logits_p.float(), full[:, 15].float(), **tol)
    logits_d, _ = api.decode_step(cfg, params, toks[:, 16], cache, pos,
                                  seq_len=32)
    torch.testing.assert_close(logits_d.float(), full[:, 16].float(), **tol)
