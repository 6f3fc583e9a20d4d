"""The port's model layers against the reference's: same numpy inputs
through repro.models.layers and repro_torch.models.layers, f32 and bf16."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs in parallel workers on few
# cores, and idle OpenMP threads spin and starve the other workers
torch.set_num_threads(1)
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
DTYPES = ["float32", "bfloat16"]


@pytest.fixture(scope="module")
def cfgs():
    return get_config("llama3-8b").reduced(), jax_config("llama3-8b").reduced()


def _rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _pair(arr, dtype):
    """The same numpy array as a JAX array and a torch tensor of dtype."""
    return jnp.asarray(arr, getattr(jnp, dtype)), \
        torch.from_numpy(arr).to(getattr(torch, dtype))


def _close(got, want, dtype):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=TOL[dtype], atol=TOL[dtype])


def _params(rng, tree, dtype):
    """numpy param tree -> (jax tree, torch tree)."""
    jt, tt = {}, {}
    for k, v in tree.items():
        jt[k], tt[k] = _pair(v, dtype)
    return jt, tt


@pytest.mark.parametrize("dtype", DTYPES)
def test_rms_norm(dtype):
    rng = np.random.default_rng(0)
    jx, tx = _pair(_rand(rng, 2, 5, 256, scale=3.0), dtype)
    jw, tw = _pair(_rand(rng, 256), dtype)
    out = L.rms_norm(tx, tw, 1e-5)
    assert out.dtype == tx.dtype
    _close(out, JL.rms_norm(jx, jw, 1e-5), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_apply_rope_interleaved(dtype):
    rng = np.random.default_rng(1)
    jx, tx = _pair(_rand(rng, 2, 7, 4, 64), dtype)
    pos = rng.integers(0, 300, (2, 7)).astype(np.int32)
    out = L.apply_rope(tx, torch.from_numpy(pos), 500_000.0)
    _close(out, JL.apply_rope(jx, jnp.asarray(pos), 500_000.0), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kw", [
    dict(causal=True),
    dict(causal=True, q_chunk=4),                     # multi-chunk
    dict(causal=True, q_offset=6, q_chunk=3),         # chunk past offset
    dict(causal=False, kv_len=np.array([9, 13], np.int32)),
    dict(causal=True, window=5, q_chunk=8),
])
def test_attention(dtype, kw):
    rng = np.random.default_rng(2)
    sq = 10
    skv = sq + kw.get("q_offset", 0) + (3 if "kv_len" in kw else 0)
    jq, tq = _pair(_rand(rng, 2, sq, 4, 64), dtype)
    jk, tk = _pair(_rand(rng, 2, skv, 2, 64), dtype)
    jv, tv = _pair(_rand(rng, 2, skv, 2, 64), dtype)
    tkw = dict(kw)
    if "kv_len" in kw:
        tkw["kv_len"] = torch.from_numpy(kw["kv_len"])
        kw = dict(kw, kv_len=jnp.asarray(kw["kv_len"]))
    out = L.attention(tq, tk, tv, **tkw)
    assert out.shape == (2, sq, 4, 64) and out.dtype == tq.dtype
    _close(out, JL.attention(jq, jk, jv, **kw), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_qkv_proj_attn_out_mlp(cfgs, dtype):
    cfg, jcfg = cfgs
    rng = np.random.default_rng(3)
    d, h, k, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    s = 1 / np.sqrt(d)
    ja, ta = _params(rng, {"wq": _rand(rng, d, h * hd, scale=s),
                           "wk": _rand(rng, d, k * hd, scale=s),
                           "wv": _rand(rng, d, k * hd, scale=s),
                           "wo": _rand(rng, h * hd, d, scale=s)}, dtype)
    jx, tx = _pair(_rand(rng, 2, 6, d), dtype)
    pos = np.tile(np.arange(6, dtype=np.int32), (2, 1))
    got = L.qkv_proj(ta, cfg, tx, torch.from_numpy(pos))
    want = JL.qkv_proj(ja, jcfg, jx, jnp.asarray(pos))
    for g, w in zip(got, want):
        _close(g, w, dtype)
    jo, to = _pair(_rand(rng, 2, 6, h, hd), dtype)
    _close(L.attn_out(ta, to), JL.attn_out(ja, jo), dtype)
    f = cfg.d_ff
    jm, tm = _params(rng, {"w_gate": _rand(rng, d, f, scale=s),
                           "w_up": _rand(rng, d, f, scale=s),
                           "w_down": _rand(rng, f, d, scale=f ** -0.5)},
                     dtype)
    _close(L.mlp(tm, tx), JL.mlp(jm, jx), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_embed_unembed(cfgs, dtype):
    """embed gathers rows exactly; unembed of an f32 x against weights in
    ``dtype`` computes in f32, as the reference's type promotion does."""
    cfg, jcfg = cfgs
    rng = np.random.default_rng(4)
    je, te = _params(rng, {
        "tok": _rand(rng, cfg.vocab_size, cfg.d_model, scale=0.02),
        "unembed": _rand(rng, cfg.d_model, cfg.vocab_size, scale=0.06)},
        dtype)
    toks = rng.integers(0, cfg.vocab_size, (2, 5)).astype(np.int32)
    got = L.embed(te, torch.from_numpy(toks))
    np.testing.assert_array_equal(
        got.float().numpy(),
        np.asarray(JL.embed(je, jnp.asarray(toks)), np.float32))
    x = _rand(rng, 3, 1, cfg.d_model)
    got = L.unembed(te, cfg, torch.from_numpy(x))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(
        got.numpy(), np.asarray(JL.unembed(je, jcfg, jnp.asarray(x))),
        rtol=1e-5, atol=1e-5)


def test_greedy_sample_matches_reference():
    from repro.serving.sampling import sample as jsample
    from repro_torch.serving.sampling import sample
    rng = np.random.default_rng(5)
    logits = _rand(rng, 6, 1024)
    logits[2, 7] = logits[2, 9] = logits[2].max() + 1.0   # tie: first index
    got = sample(torch.from_numpy(logits))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jsample(jnp.asarray(logits))))


def test_temperature_sample_follows_softmax():
    """temperature > 0 draws from softmax(logits / T) with the caller's
    generator (checked by distribution: a different RNG than the
    reference's, so not token by token)."""
    from repro_torch.serving.sampling import sample
    logits = torch.tensor([[0.0, 1.0, 2.0, -1.0]]).repeat(20000, 1)
    gen = torch.Generator().manual_seed(0)
    draws = sample(logits, generator=gen, temperature=2.0)
    freq = torch.bincount(draws.long(), minlength=4).float() / len(draws)
    want = torch.softmax(logits[0] / 2.0, dim=-1)
    assert torch.allclose(freq, want, atol=0.015)
    again = sample(logits, generator=torch.Generator().manual_seed(0),
                   temperature=2.0)
    assert torch.equal(draws, again)          # same generator seed, same draws
    top1 = sample(logits[:50], generator=gen, temperature=1.0, top_k=1)
    assert (top1 == 2).all()
