"""The port's paged decode step on an int8 KV pool against the reference's,
float32 reduced llama3-8b on converted weights: the same quantized pool
(payload and scales) goes through both; next tokens, logits and the pool
after each layer's in-place quantize-and-scatter are compared."""
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
from repro.kernels.paged_attention_int8 import (  # noqa: E402
    dequantize_pages as jdeq, quantize_pages as jquant)
from repro.models import api  # noqa: E402
from repro.models import paged_decode as JPD  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import from_jax_numpy  # noqa: E402
from repro_torch.models import paged_decode as PD  # noqa: E402

F32 = dict(dtype="float32", kv_dtype="float32")


def _bf16(a) -> torch.Tensor:
    """A JAX bf16 array -> a torch bf16 tensor with the same bits."""
    return torch.from_numpy(np.array(a).view(np.int16)).view(torch.bfloat16)


@pytest.fixture(scope="module")
def setup():
    jcfg = dataclasses.replace(jax_config("llama3-8b").reduced(), **F32)
    cfg = dataclasses.replace(get_config("llama3-8b").reduced(), **F32)
    jparams = api.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = from_jax_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                             device="cpu")
    return cfg, jcfg, tparams, jparams


@pytest.mark.parametrize("window", [0, 12])
def test_decode_step_int8_matches_reference(setup, window):
    """One decode step over one int8 pool (a quantized random pool, four
    slots at page-boundary positions, with and without a sliding window):
    identical next tokens, logits within 1e-4 (f32 on both sides; the
    attention reads the same int8 bytes), and the same pool afterwards.
    The rows each step writes are quantized from K/V that the two
    frameworks compute in f32 with different summation orders (agreeing to
    ~1e-6), so a row within that distance of an int8 rounding boundary may
    round one step apart: the written rows must agree within one
    quantization step; every other byte must be untouched."""
    cfg, jcfg, tp, jp = setup
    cfg = dataclasses.replace(cfg, sliding_window=window)
    jcfg = dataclasses.replace(jcfg, sliding_window=window)
    page, slots, table_w = cfg.page_size, 4, 4
    n_blocks = slots * table_w + 1
    rng = np.random.default_rng(7)
    shape = (cfg.n_layers, cfg.n_kv_heads, n_blocks, page, cfg.head_dim)
    kq, ks = jquant(jnp.asarray(rng.standard_normal(shape), jnp.float32))
    vq, vs = jquant(jnp.asarray(rng.standard_normal(shape), jnp.float32))
    tables = (1 + np.arange(slots * table_w, dtype=np.int32)).reshape(
        slots, table_w)
    pos = np.array([3, 9, 17, 30], np.int32)
    token = rng.integers(1, cfg.vocab_size, slots).astype(np.int32)

    tk, tv = torch.from_numpy(np.array(kq)), torch.from_numpy(np.array(vq))
    tks, tvs = _bf16(ks), _bf16(vs)
    nxt, logits = PD.decode_step_paged(
        cfg, tp, torch.from_numpy(token), tk, tv, torch.from_numpy(tables),
        torch.from_numpy(pos), k_scales=tks, v_scales=tvs)
    jn, jl, jk, jv, jks, jvs = JPD.decode_step_paged(
        jcfg, jp, jnp.asarray(token), kq, vq, jnp.asarray(tables),
        jnp.asarray(pos), k_scales=ks, v_scales=vs, interpret=True)
    np.testing.assert_array_equal(nxt.numpy(), np.asarray(jn))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl),
                               rtol=1e-4, atol=1e-4)
    # the rows this step writes: one per slot per layer
    rows = np.zeros((n_blocks, page), bool)
    for b, p in enumerate(pos):
        rows[tables[b, p // page], p % page] = True
    for got, got_s, want, want_s, old, old_s in (
            (tk, tks, jk, jks, kq, ks), (tv, tvs, jv, jvs, vq, vs)):
        for t, j, o in ((got.numpy(), np.array(want), np.array(old)),
                        (got_s.view(torch.int16).numpy(),
                         np.array(want_s).view(np.int16),
                         np.array(old_s).view(np.int16))):
            np.testing.assert_array_equal(t[:, :, ~rows], o[:, :, ~rows])
            np.testing.assert_array_equal(j[:, :, ~rows], o[:, :, ~rows])
        assert (got.numpy()[:, :, rows] != np.array(old)[:, :, rows]).any()
        deq = (got.float() * got_s.float()).numpy()[:, :, rows]
        jdq = np.asarray(jdeq(want, want_s))[:, :, rows]
        step = np.maximum(got_s.float().numpy()[:, :, rows],
                          np.array(want_s, np.float32)[:, :, rows])
        assert (np.abs(deq - jdq) <= step + 1e-7).all()
