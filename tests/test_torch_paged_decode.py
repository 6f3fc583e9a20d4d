"""The port's paged decode path against the reference's, float32 reduced
llama3-8b on converted weights: bucketed prefill (logits + KV rows), page
packing, and one decode step (next tokens, logits, and the pool after the
in-place KV scatter)."""
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

F32 = dict(dtype="float32", kv_dtype="float32")


@pytest.fixture(scope="module")
def setup():
    jcfg = dataclasses.replace(jax_config("llama3-8b").reduced(), **F32)
    cfg = dataclasses.replace(get_config("llama3-8b").reduced(), **F32)
    jparams = api.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = from_jax_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                             device="cpu")
    return cfg, jcfg, tparams, jparams


def _prompt(cfg, n, bucket, seed):
    toks = np.zeros((1, bucket), np.int32)
    toks[0, :n] = np.random.default_rng(seed).integers(1, cfg.vocab_size, n)
    return toks


@pytest.mark.parametrize("n", [5, 8, 13])
def test_prefill_bucketed_matches_reference(setup, n):
    cfg, jcfg, tp, jp = setup
    bucket = PD.next_bucket(n, lo=cfg.page_size)
    assert bucket == JPD.next_bucket(n, lo=jcfg.page_size)
    toks = _prompt(cfg, n, bucket, seed=n)
    logits, k, v = PD.prefill_bucketed(cfg, tp, torch.from_numpy(toks), n)
    jl, jk, jv = JPD.prefill_bucketed(jcfg, jp, jnp.asarray(toks),
                                      jnp.int32(n))
    assert logits.shape == (1, cfg.vocab_size) and logits.dtype == torch.float32
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl),
                               rtol=1e-4, atol=1e-4)
    # rows >= n are padding garbage in both packages: compare the real rows
    for got, want in ((k, jk), (v, jv)):
        assert got.shape == want.shape
        np.testing.assert_allclose(got[:, :n].numpy(),
                                   np.asarray(want)[:, :n],
                                   rtol=1e-4, atol=1e-4)


def test_pack_pages_bit_exact():
    rng = np.random.default_rng(0)
    k = rng.standard_normal((2, 24, 2, 64)).astype(np.float32)
    v = rng.standard_normal((2, 24, 2, 64)).astype(np.float32)
    got = PD.pack_pages(torch.from_numpy(k), torch.from_numpy(v), 3, 8)
    want = JPD.pack_pages(jnp.asarray(k), jnp.asarray(v), 3, 8)
    for g, w in zip(got, want):
        assert g.shape == (2, 2, 3, 8, 64)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_decode_step_matches_reference(setup):
    """One decode step over a pool both packages filled from the same
    prefill KV: identical next tokens, logits within 1e-4, and the same pool
    after each layer's in-place KV scatter."""
    cfg, jcfg, tp, jp = setup
    page, slots = cfg.page_size, 4
    table_w = 4
    n_blocks = slots * table_w + 1
    rng = np.random.default_rng(7)
    pool_k = rng.standard_normal((cfg.n_layers, cfg.n_kv_heads, n_blocks,
                                  page, cfg.head_dim)).astype(np.float32)
    pool_v = rng.standard_normal(pool_k.shape).astype(np.float32)
    # slot s owns blocks [1 + s*table_w, ...): distinct destinations
    tables = (1 + np.arange(slots * table_w, dtype=np.int32)).reshape(
        slots, table_w)
    pos = np.array([3, 9, 17, 30], np.int32)      # page-boundary crossings
    token = rng.integers(1, cfg.vocab_size, slots).astype(np.int32)

    tk, tv = torch.from_numpy(pool_k.copy()), torch.from_numpy(pool_v.copy())
    nxt, logits = PD.decode_step_paged(
        cfg, tp, torch.from_numpy(token), tk, tv, torch.from_numpy(tables),
        torch.from_numpy(pos))
    jn, jl, jk, jv = JPD.decode_step_paged(
        jcfg, jp, jnp.asarray(token), jnp.asarray(pool_k),
        jnp.asarray(pool_v), jnp.asarray(tables), jnp.asarray(pos),
        interpret=True)
    assert nxt.dtype == torch.int32
    np.testing.assert_array_equal(nxt.numpy(), np.asarray(jn))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-4,
                               atol=1e-4)
    # the scatter touched exactly one row per slot per layer
    changed = (tk.numpy() != pool_k).any(axis=(1, 4))    # (L, P, page)
    assert changed.sum() == cfg.n_layers * slots
