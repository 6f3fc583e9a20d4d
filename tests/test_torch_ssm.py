"""The port's Mamba-2 model (``models/ssm.py`` through ``models/api.py``)
against the reference's, on a float32 reduced mamba2-130m with converted
params: the chunked scan, forward, prefill (logits and cache), decode_step
and a greedy stream; then the port's own invariants, torch against torch,
and the bit-exact conversion of the Mamba-2 param tree."""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs in parallel workers on few
# cores, and idle OpenMP threads spin and starve the other workers
torch.set_num_threads(1)
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import from_jax_numpy  # noqa: E402
from repro_torch.kernels import ssd_scan as SSD  # noqa: E402
from repro_torch.models import api, ssm  # noqa: E402

# f32 on both sides; the two packages sum in other orders
TOL = dict(rtol=1e-4, atol=1e-4)
ARCH = "mamba2-130m"


@pytest.fixture(scope="module")
def setup():
    jcfg = dataclasses.replace(jax_config(ARCH).reduced(), dtype="float32")
    cfg = dataclasses.replace(get_config(ARCH).reduced(), dtype="float32")
    jparams = japi.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = from_jax_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                             device="cpu")
    return cfg, jcfg, tparams, jparams


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(
        2, cfg.vocab_size, (b, s)).astype(np.int32)


def _ssd_inputs(b, s, h, p, n, seed):
    rng = np.random.default_rng(seed)
    xdt = (rng.standard_normal((b, s, h, p)) * 0.5).astype(np.float32)
    a = (-np.abs(rng.standard_normal((b, s, h))) * 0.3).astype(np.float32)
    B = (rng.standard_normal((b, s, n)) * 0.3).astype(np.float32)
    C = (rng.standard_normal((b, s, n)) * 0.3).astype(np.float32)
    return xdt, a, B, C


# --------------------------------------------------------------------------
# ssd_chunked
# --------------------------------------------------------------------------

@pytest.mark.parametrize("s,chunk,with_h0", [
    (64, 16, False),    # s a multiple of chunk
    (50, 16, False),    # padded to 64
    (12, 32, False),    # s < chunk: chunk = s
    (40, 16, True),     # initial state (decode continuation), padded
])
def test_ssd_chunked_matches_reference(s, chunk, with_h0):
    b, h, p, n = 2, 3, 16, 32
    case = _ssd_inputs(b, s, h, p, n, seed=s)
    h0 = (np.random.default_rng(1).standard_normal((b, h, p, n))
          .astype(np.float32) if with_h0 else None)
    jy, jh = jssm.ssd_chunked(*map(jnp.asarray, case),
                              h0=None if h0 is None else jnp.asarray(h0),
                              chunk=chunk)
    before = SSD.launches
    y, hf = ssm.ssd_chunked(*map(torch.from_numpy, case),
                            h0=None if h0 is None else torch.from_numpy(h0),
                            chunk=chunk)
    assert SSD.launches == before
    assert y.shape == (b, s, h, p) and hf.shape == (b, h, p, n)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(hf.numpy(), np.asarray(jh), **TOL)


def test_segsum_matches_reference():
    a = -np.abs(np.random.default_rng(2).standard_normal((3, 9))) \
        .astype(np.float32)
    got = ssm._segsum(torch.from_numpy(a)).numpy()
    want = np.asarray(jssm._segsum(jnp.asarray(a)))
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-6, atol=1e-6)


# --------------------------------------------------------------------------
# the model against the reference
# --------------------------------------------------------------------------

def test_forward_matches_reference(setup):
    cfg, jcfg, tp, jp = setup
    toks = _tokens(cfg, 2, 40, seed=0)          # 40 > chunk 32: padded
    want = jax.jit(functools.partial(jssm.forward, jcfg))(jp,
                                                          jnp.asarray(toks))
    got = api.forward(cfg, tp, torch.from_numpy(toks))
    assert got.shape == (2, 40, cfg.vocab_size) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_prefill_and_decode_step_match_reference(setup):
    cfg, jcfg, tp, jp = setup
    toks = _tokens(cfg, 2, 41, seed=1)
    jl, jc, jpos = japi.prefill(jcfg, jp, {"tokens": jnp.asarray(toks[:, :40])})
    tl, tc, tpos = api.prefill(cfg, tp, {"tokens": torch.from_numpy(
        toks[:, :40])})
    assert tpos == int(jpos) == 40
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    assert tc["conv"].dtype == torch.bfloat16        # bf16 even in f32
    assert tc["ssm"].dtype == torch.float32
    for key in ("conv", "ssm"):
        assert tuple(tc[key].shape) == jc[key].shape, key
    # the conv state holds in_proj rows cast to bf16 in both packages; the
    # f32 rows differ in their last bits (summation order), and the cast
    # rounds each side to its nearest bf16, which can then differ by a step
    np.testing.assert_allclose(tc["conv"].float().numpy(),
                               np.asarray(jc["conv"], np.float32),
                               rtol=2 ** -8, atol=TOL["atol"])
    assert (tc["conv"].float().numpy()
            == np.asarray(jc["conv"], np.float32)).mean() > 0.99
    np.testing.assert_allclose(tc["ssm"].numpy(), np.asarray(jc["ssm"]),
                               **TOL)
    jd, jc2 = japi.decode_step(jcfg, jp, jnp.asarray(toks[:, 40]), jc,
                               jnp.int32(40), seq_len=41)
    td, tc2 = api.decode_step(cfg, tp, torch.from_numpy(toks[:, 40]), tc,
                              40, seq_len=41)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), **TOL)
    np.testing.assert_allclose(tc2["ssm"].numpy(), np.asarray(jc2["ssm"]),
                               **TOL)
    assert not torch.equal(tc2["ssm"], tc["ssm"])    # input cache kept


def test_greedy_stream_matches_reference(setup):
    """16 greedy tokens through api.prefill / api.decode_step, identical in
    both packages."""
    cfg, jcfg, tp, jp = setup
    toks = _tokens(cfg, 2, 36, seed=2)
    n_new = 16
    jprefill = jax.jit(lambda p, t: japi.prefill(jcfg, p, {"tokens": t})[:2])
    jdecode = jax.jit(lambda p, t, c: japi.decode_step(jcfg, p, t, c, 0, 0))
    logits, cache = jprefill(jp, jnp.asarray(toks))
    want = [np.asarray(jnp.argmax(logits, -1))]
    for _ in range(n_new - 1):
        logits, cache = jdecode(jp, jnp.asarray(want[-1], jnp.int32), cache)
        want.append(np.asarray(jnp.argmax(logits, -1)))

    logits, tcache, pos = api.prefill(cfg, tp,
                                      {"tokens": torch.from_numpy(toks)})
    got = [logits.argmax(-1)]
    for i in range(n_new - 1):
        logits, tcache = api.decode_step(cfg, tp, got[-1], tcache, pos + i,
                                         seq_len=pos + n_new)
        got.append(logits.argmax(-1))
    got = torch.stack(got, 1).numpy()
    np.testing.assert_array_equal(got, np.stack(want, 1))
    assert len(set(got[0].tolist())) > 1        # not one token repeated


# --------------------------------------------------------------------------
# the port's own invariants
# --------------------------------------------------------------------------

@pytest.mark.parametrize("conv_dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("split", [11, 39])
def test_prefill_split_equals_forward(setup, split, conv_dtype,
                                      monkeypatch):
    """prefill(:t) then one decode_step gives forward's logits at t. As the
    model runs, the prefill stores the conv state in bf16 (as the reference
    does), so the decode input differs from the f32 forward by bf16
    rounding of three conv rows per layer: the bf16 tolerance covers that.
    With the conv state kept in f32 the check holds to f32 rounding."""
    cfg, _, tp, _ = setup
    monkeypatch.setattr(ssm, "CONV_STATE_DTYPE", getattr(torch, conv_dtype))
    toks = torch.from_numpy(_tokens(cfg, 2, split + 1, seed=3))
    full = ssm.forward(cfg, tp, toks)
    _, cache, pos = ssm.prefill(cfg, tp, toks[:, :split])
    assert cache["conv"].dtype == getattr(torch, conv_dtype)
    logits, _ = ssm.decode_step(cfg, tp, toks[:, split], cache, pos)
    tol = TOL if conv_dtype == "float32" else dict(rtol=2e-2, atol=2e-2)
    torch.testing.assert_close(logits, full[:, split], **tol)


def test_chunk_length_does_not_change_the_result(setup):
    """The SSD split is exact for any chunk length: chunk 8 and chunk 32
    differ only in rounding."""
    cfg, _, tp, _ = setup
    toks = torch.from_numpy(_tokens(cfg, 2, 48, seed=4))
    a = ssm.forward(cfg, tp, toks, chunk=8)
    b = ssm.forward(cfg, tp, toks, chunk=32)
    torch.testing.assert_close(a, b, **TOL)


def test_api_dispatch():
    cfg = get_config(ARCH).reduced()
    assert api.family(cfg) is ssm
    assert api.decode_window(cfg, 1 << 20) == 0
    assert api.decode_capacity(cfg, 77) == 77
    cache = api.init_cache(cfg, 3, 100, device="cpu")
    assert tuple(cache["conv"].shape) == (cfg.n_layers, 3, cfg.ssm_conv - 1,
                                          ssm.conv_dim(cfg))
    assert tuple(cache["ssm"].shape) == (cfg.n_layers, 3, cfg.ssm_n_heads,
                                         cfg.ssm_head_dim, cfg.ssm_state)
    dense = get_config("llama3-8b")
    assert api.decode_window(dense, 100_000) == dense.long_context_window
    # every family's model API is ported: the dense, VLM and audio ones
    # since the training slice (tests/test_torch_transformer.py), the hybrid
    # one in tests/test_torch_hybrid.py
    for arch_type, module in (("dense", "transformer"), ("vlm", "vlm"),
                              ("audio", "encoder"), ("hybrid", "hybrid"),
                              ("moe", "moe")):
        other = dataclasses.replace(dense, arch_type=arch_type)
        assert api.family(other).__name__ == f"repro_torch.models.{module}"
    with pytest.raises(ValueError, match="encoder-only"):
        api.prefill(get_config("hubert-xlarge"), {},
                    {"tokens": torch.zeros(1, 4, dtype=torch.int32)})


# --------------------------------------------------------------------------
# params
# --------------------------------------------------------------------------

def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (k,))
    else:
        yield prefix, tree


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_conversion_is_bit_exact(dtype):
    """The Mamba-2 tree mixes f32 leaves (A_log, D, dt_bias) with leaves in
    the config dtype; each converts bit for bit in its own dtype."""
    jcfg = dataclasses.replace(jax_config(ARCH).reduced(), dtype=dtype)
    jparams = japi.init_params(jcfg, jax.random.PRNGKey(5))
    tparams = from_jax_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                             device="cpu")
    jl, tl = dict(_leaves(jparams)), dict(_leaves(tparams))
    assert jl.keys() == tl.keys()
    kinds = set()
    for path, jv in jl.items():
        want = np.asarray(jv)
        tv = tl[path]
        kinds.add(str(tv.dtype))
        assert str(tv.dtype) == f"torch.{want.dtype.name}", path
        assert tuple(tv.shape) == want.shape, path
        if want.dtype.name == "bfloat16":
            np.testing.assert_array_equal(tv.view(torch.int16).numpy(),
                                          want.view(np.int16), str(path))
        else:
            np.testing.assert_array_equal(tv.view(torch.int32).numpy(),
                                          want.view(np.int32), str(path))
    assert "torch.float32" in kinds and f"torch.{dtype}" in kinds


def test_port_init_matches_reference_layout_and_scales():
    cfg = get_config(ARCH).reduced()
    conv = from_jax_numpy(jax.tree_util.tree_map(
        np.asarray, japi.init_params(jax_config(ARCH).reduced(),
                                     jax.random.PRNGKey(1))), device="cpu")
    own = api.init_params(cfg, torch.Generator().manual_seed(0),
                          device="cpu")
    cl, ol = dict(_leaves(conv)), dict(_leaves(own))
    assert cl.keys() == ol.keys()
    for path in cl:
        assert cl[path].shape == ol[path].shape, path
        assert cl[path].dtype == ol[path].dtype, path
    lay = own["layers"]
    for key in ("D", "dt_bias"):                          # exact constants
        assert torch.equal(lay[key], conv["layers"][key]), key
    # log(linspace(1, 16, h)): torch and XLA round the last bit differently
    torch.testing.assert_close(lay["A_log"], conv["layers"]["A_log"],
                               rtol=1e-6, atol=1e-6)
    assert abs(float(own["embed"]["tok"].float().std()) - 0.02) < 2e-3
    assert abs(float(lay["conv_w"].float().std()) - 0.5) < 0.05
    w = lay["in_proj"].float()
    assert abs(float(w.std()) - cfg.d_model ** -0.5) < 5e-3
    assert not torch.equal(w[0], w[1])                   # layers differ
