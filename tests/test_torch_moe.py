"""The port's MoE family (``models/moe.py`` through ``models/api.py``)
against the reference's, on reduced mixtral-8x7b and dbrx-132b with
converted params: routing (expert indices, kept slots, drops, tie order)
exactly; ``moe_mlp``'s output and aux loss at capacity factors 1.25,
n_experts and 2·n_experts and groups of 8, 16 and 32 tokens, and a finite
``DECODE_CAPACITY_FACTOR``; the model API (forward with aux, prefill,
decode_step); then the port's own invariants, torch against torch: a
slot's ``decode_mlp`` output does not depend on the other slots, and
prefill + decode_step reproduce forward."""
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
from repro.models import moe as JM  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import from_jax_numpy  # noqa: E402
from repro_torch.kernels import moe_mlp as MOE  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.models import moe as TM  # noqa: E402
from repro_torch.models.transformer import layer_params  # noqa: E402

ARCHS = ["mixtral-8x7b", "dbrx-132b"]
F32 = dict(dtype="float32", kv_dtype="float32")
# f32 on both sides; the packages sum the experts in other orders
TOL = dict(rtol=1e-5, atol=1e-5)
# through whole models (2 layers, f32): the same sums, compounded
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)
# bf16: the tolerance of the reference's own bf16 model checks
# (tests/test_models.py); one layer's routed MLP on the same bf16 inputs
BF16_TOL = dict(rtol=0.08, atol=0.08)


def _convert(jparams):
    return from_jax_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                          device="cpu")


@functools.lru_cache(maxsize=None)
def _setup(name):
    """(port cfg, reference cfg, port params, reference params): float32
    reduced config, the reference's init converted bit for bit."""
    jcfg = dataclasses.replace(jax_config(name).reduced(), **F32)
    cfg = dataclasses.replace(get_config(name).reduced(), **F32)
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    return cfg, jcfg, _convert(jparams), jparams


@pytest.fixture(params=ARCHS)
def setup(request):
    return _setup(request.param)


@pytest.fixture
def layer_setup():
    """One routed layer's setup: reduced mixtral and dbrx have the same
    MoE layer (4 experts top-2, d 256, f 512), so mixtral's serves both."""
    return _setup("mixtral-8x7b")


def _layer0(tparams, jparams):
    return (layer_params(tparams["layers"], 0),
            jax.tree_util.tree_map(lambda a: a[0], jparams["layers"]))


def _ref_routing(jcfg, router, xg, cap):
    """The reference's routing internals (``moe_mlp``), from its own ops:
    (top-k indices, kept mask, renormalised gates, probs)."""
    probs = jax.nn.softmax(jnp.asarray(xg, jnp.float32) @ router, axis=-1)
    topk_p, topk_i = jax.lax.top_k(probs, jcfg.top_k)
    topk_p = topk_p / (jnp.sum(topk_p, axis=-1, keepdims=True) + 1e-9)
    onehot = jax.nn.one_hot(topk_i, jcfg.n_experts, dtype=jnp.float32)
    g = xg.shape[1]
    flat = onehot.reshape(xg.shape[0], g * jcfg.top_k, jcfg.n_experts)
    pos = jnp.sum((jnp.cumsum(flat, axis=1) - flat).reshape(onehot.shape)
                  * onehot, axis=-1)
    return (np.asarray(topk_i), np.asarray(pos < cap), np.asarray(topk_p),
            np.asarray(probs))


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


# --------------------------------------------------------------------------
# routing and moe_mlp
# --------------------------------------------------------------------------

@pytest.mark.parametrize("group", [8, 16, 32])
@pytest.mark.parametrize("cf_mult", [None, 1.0, 2.0])
def test_moe_mlp_matches_reference(layer_setup, group, cf_mult):
    """cf 1.25 (``None``), n_experts and 2·n_experts: the same experts,
    the same kept slots and the same drops, token for token; output and
    aux within f32 tolerance."""
    cfg, jcfg, tp, jp = layer_setup
    p, jl = _layer0(tp, jp)
    cf = 1.25 if cf_mult is None else cf_mult * cfg.n_experts
    # a shared offset skews every token towards the same experts, so the
    # capacity at cf 1.25 drops some
    x = _x((2, 32, cfg.d_model), seed=group) \
        + _x((cfg.d_model,), seed=4)
    g = min(group, x.shape[0] * x.shape[1])
    xg = x.reshape(-1, g, cfg.d_model)
    cap = int(max(cfg.top_k, g * cfg.top_k / cfg.n_experts * cf))
    want_i, want_keep, want_p, want_probs = _ref_routing(
        jcfg, jl["router"], xg, cap)
    probs, got_i, got_p, keep, _ = TM.route(cfg, p["router"],
                                            torch.as_tensor(xg), cap)
    np.testing.assert_array_equal(got_i.numpy(), want_i)
    np.testing.assert_array_equal(keep.numpy(), want_keep)
    np.testing.assert_allclose(got_p.numpy(), want_p, **TOL)
    np.testing.assert_allclose(probs.numpy(), want_probs, **TOL)
    if cf_mult is None:
        assert (~keep).sum() > 0          # the capacity really dropped
    else:
        assert keep.all()                 # drop-free
    yj, aj = JM.moe_mlp(jcfg, jl, jnp.asarray(x), capacity_factor=cf,
                        group_size=group)
    yt, at = TM.moe_mlp(cfg, p, torch.as_tensor(x), capacity_factor=cf,
                        group_size=group)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), **TOL)
    np.testing.assert_allclose(float(at), float(aj), **TOL)


def test_aux_loss_top1_branch(layer_setup):
    """k == 1 takes the reference's other aux branch (choice 0's
    one-hot, not the mean over choices)."""
    cfg, jcfg, tp, jp = layer_setup
    cfg1 = dataclasses.replace(cfg, top_k=1)
    jcfg1 = dataclasses.replace(jcfg, top_k=1)
    p, jl = _layer0(tp, jp)
    x = _x((1, 16, cfg.d_model), seed=7)
    yj, aj = JM.moe_mlp(jcfg1, jl, jnp.asarray(x))
    yt, at = TM.moe_mlp(cfg1, p, torch.as_tensor(x))
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), **TOL)
    np.testing.assert_allclose(float(at), float(aj), **TOL)


def test_group_must_divide_tokens(layer_setup):
    cfg, _, tp, _ = layer_setup
    x = torch.zeros((1, 24, cfg.d_model))
    with pytest.raises(ValueError, match="not divisible by group 16"):
        TM.moe_mlp(cfg, layer_params(tp["layers"], 0), x, group_size=16)


@pytest.mark.parametrize("cf_mult", [None, 1.0])
def test_serving_without_aux_gives_the_same_output(layer_setup, cf_mult):
    """``aux=False`` (the serving paths) returns the same output bits and
    no aux loss, with drops (cf 1.25) and drop-free."""
    cfg, _, tp, _ = layer_setup
    p = layer_params(tp["layers"], 0)
    cf = 1.25 if cf_mult is None else cf_mult * cfg.n_experts
    x = torch.as_tensor(_x((2, 16, cfg.d_model), seed=9)
                        + _x((cfg.d_model,), seed=4))
    want, aux = TM.moe_mlp(cfg, p, x, capacity_factor=cf, group_size=16)
    got, none = TM.moe_mlp(cfg, p, x, capacity_factor=cf, group_size=16,
                           aux=False)
    assert none is None and aux is not None
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype,error", [(torch.bfloat16, ValueError),
                                         (torch.float32, TypeError)])
def test_kernel_path_has_no_fallback(layer_setup, dtype, error):
    """Forced onto the kernel, CPU tensors (and f32 experts) raise before
    any build or launch: no silent fall back to ``expert_mix``."""
    cfg, _, tp, _ = layer_setup
    p = layer_params(tp["layers"], 0)
    p = {"router": p["router"],
         "experts": {k: v.to(dtype) for k, v in p["experts"].items()}}
    x = torch.zeros((1, 8, cfg.d_model), dtype=dtype)
    assert not TM.on_kernel(x, p["experts"])
    before = MOE.launches
    with pytest.raises(error):
        TM.moe_mlp(cfg, p, x, capacity_factor=float(cfg.n_experts),
                   kernel=True, aux=False)
    assert MOE.launches == before


def test_finite_decode_capacity_drops_like_reference(layer_setup, monkeypatch):
    """A finite DECODE_CAPACITY_FACTOR: decode_mlp over 8 slots drops the
    reference's tokens (capacity max(k, 8·k/E) = 4 slots an expert)."""
    cfg, jcfg, tp, jp = layer_setup
    p, jl = _layer0(tp, jp)
    monkeypatch.setattr(JM, "DECODE_CAPACITY_FACTOR", 1.0)
    monkeypatch.setattr(TM, "DECODE_CAPACITY_FACTOR", 1.0)
    # a shared offset skews every token towards the same experts
    x = _x((8, 1, cfg.d_model), seed=3) + _x((cfg.d_model,), 4)
    cap = int(max(cfg.top_k, 8 * cfg.top_k / cfg.n_experts))
    _, want_keep, _, _ = _ref_routing(jcfg, jl["router"],
                                      x.reshape(1, 8, -1), cap)
    _, _, _, keep, _ = TM.route(cfg, p["router"],
                                torch.as_tensor(x.reshape(1, 8, -1)), cap)
    np.testing.assert_array_equal(keep.numpy(), want_keep)
    assert not want_keep.all()
    np.testing.assert_allclose(
        TM.decode_mlp(cfg, p, torch.as_tensor(x)).numpy(),
        np.asarray(JM.decode_mlp(jcfg, jl, jnp.asarray(x))), **TOL)


def test_ties_pick_lower_expert_first(layer_setup):
    """A zero router gives every expert probability 1/E: both packages
    pick experts 0..k-1, in that order, for every token."""
    cfg, jcfg, tp, jp = layer_setup
    p, jl = _layer0(tp, jp)
    p = {**p, "router": torch.zeros_like(p["router"])}
    jl = {**jl, "router": jnp.zeros_like(jl["router"])}
    x = _x((1, 16, cfg.d_model), seed=5)
    _, topk_i, _, _, _ = TM.route(cfg, p["router"],
                                  torch.as_tensor(x), 16 * cfg.top_k)
    want = np.broadcast_to(np.arange(cfg.top_k), (1, 16, cfg.top_k))
    np.testing.assert_array_equal(topk_i.numpy(), want)
    np.testing.assert_array_equal(
        _ref_routing(jcfg, jl["router"], x, 16 * cfg.top_k)[0], want)
    np.testing.assert_allclose(
        TM.moe_mlp(cfg, p, torch.as_tensor(x))[0].numpy(),
        np.asarray(JM.moe_mlp(jcfg, jl, jnp.asarray(x))[0]), **TOL)


@pytest.mark.parametrize("k", [1, 2, 4])
def test_top_k_tie_order_matches_lax_top_k(k):
    """Rows full of ties (values from {0, 1/4, 1/2}): the same indices in
    the same order as ``jax.lax.top_k``."""
    rng = np.random.default_rng(k)
    probs = (rng.integers(0, 3, (64, 16)) / 4).astype(np.float32)
    vals, idx = TM.top_k(torch.as_tensor(probs), k)
    jv, ji = jax.lax.top_k(jnp.asarray(probs), k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_decode_mlp_slot_is_batch_invariant(dtype):
    """A slot's decode_mlp output is the same bits whatever the other 7
    slots hold, and wherever the token sits in the batch."""
    cfg = dataclasses.replace(get_config("mixtral-8x7b").reduced(),
                              dtype=dtype)
    params = TM.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    p = layer_params(params["layers"], 1)
    dt = getattr(torch, dtype)
    x = torch.as_tensor(_x((8, 1, cfg.d_model), seed=1)).to(dt)
    other = torch.as_tensor(_x((8, 1, cfg.d_model), seed=2)).to(dt)
    y = TM.decode_mlp(cfg, p, x)
    mixed = other.clone()
    mixed[0] = x[0]
    assert torch.equal(TM.decode_mlp(cfg, p, mixed)[0], y[0])
    moved = other.clone()
    moved[5] = x[0]
    assert torch.equal(TM.decode_mlp(cfg, p, moved)[5], y[0])


def test_moe_mlp_bf16_matches_reference():
    """bf16 params and activations: the same routing (the router runs in
    f32 on the same bf16 inputs) and outputs within the reference's bf16
    tolerance."""
    jcfg = jax_config("mixtral-8x7b").reduced()
    cfg = get_config("mixtral-8x7b").reduced()
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(1))
    p, jl = _layer0(_convert(jparams), jparams)
    x = jnp.asarray(_x((2, 16, cfg.d_model), seed=9), jnp.bfloat16)
    xt = _convert({"x": x})["x"]
    yj, aj = JM.moe_mlp(jcfg, jl, x)
    yt, at = TM.moe_mlp(cfg, p, xt)
    assert yt.dtype == torch.bfloat16
    np.testing.assert_allclose(yt.float().numpy(),
                               np.asarray(yj, np.float32), **BF16_TOL)
    np.testing.assert_allclose(float(at), float(aj), **TOL)


# --------------------------------------------------------------------------
# params
# --------------------------------------------------------------------------

def test_init_params_layout_and_scales():
    """The port's init has the reference's leaves, shapes and dtypes (the
    router in f32), the reference's scales, and is reproducible from its
    generator; meta tensors give the same tree without memory."""
    name = "dbrx-132b"
    jcfg, cfg = jax_config(name).reduced(), get_config(name).reduced()
    want = jax.eval_shape(lambda: JM.init_params(jcfg,
                                                 jax.random.PRNGKey(0)))
    flat = {tuple(k.key for k in path): (tuple(v.shape),
                                        np.dtype(v.dtype).name)
            for path, v in jax.tree_util.tree_flatten_with_path(want)[0]}
    params = api.init_params(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
    meta = api.init_params(cfg, None, device="meta")

    def leaves(tree, prefix=()):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from leaves(v, prefix + (k,))
            else:
                yield prefix + (k,), v
    for tree in (params, meta):
        got = {path: (tuple(v.shape), str(v.dtype).removeprefix("torch."))
               for path, v in leaves(tree)}
        assert got == flat
    lay = params["layers"]
    d, f = cfg.d_model, cfg.d_ff
    for leaf, std in ((lay["router"], 0.02),
                      (lay["experts"]["w_gate"], d ** -0.5),
                      (lay["experts"]["w_down"], f ** -0.5),
                      (lay["attn"]["wq"], d ** -0.5)):
        assert abs(leaf.float().std().item() / std - 1) < 0.05
    again = api.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    assert torch.equal(again["layers"]["experts"]["w_up"],
                       lay["experts"]["w_up"])


# --------------------------------------------------------------------------
# model API
# --------------------------------------------------------------------------

def test_forward_with_aux_matches_reference(setup):
    cfg, jcfg, tp, jp = setup
    toks = np.random.default_rng(0).integers(2, cfg.vocab_size, (2, 16))
    lj, aj = JM.forward(jcfg, jp, jnp.asarray(toks, jnp.int32), q_chunk=8,
                        return_aux=True)
    lt, at = api.forward(cfg, tp, torch.as_tensor(toks), q_chunk=8,
                         return_aux=True)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **MODEL_TOL)
    np.testing.assert_allclose(float(at), float(aj), **TOL)


def test_api_prefill_and_decode_match_reference(setup):
    """api.prefill (capacity from the decode window, cf 1.25) and three
    api.decode_step calls: logits and caches."""
    cfg, jcfg, tp, jp = setup
    rng = np.random.default_rng(4)
    toks = rng.integers(2, cfg.vocab_size, (2, 12))
    lj, cj, pos = japi.prefill(jcfg, jp, {"tokens": jnp.asarray(
        toks, jnp.int32)}, seq_budget=32, q_chunk=8)
    lt, ct, tpos = api.prefill(cfg, tp, {"tokens": torch.as_tensor(toks)},
                               seq_budget=32, q_chunk=8)
    assert tpos == pos
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **MODEL_TOL)
    for name in ("k", "v"):
        assert tuple(ct[name].shape) == cj[name].shape
        np.testing.assert_allclose(ct[name].numpy(), np.asarray(cj[name]),
                                   **MODEL_TOL)
    for step in range(3):
        nxt = rng.integers(2, cfg.vocab_size, 2)
        lj, cj = japi.decode_step(jcfg, jp, jnp.asarray(nxt, jnp.int32), cj,
                                  jnp.int32(pos + step), seq_len=32)
        lt, ct = api.decode_step(cfg, tp, torch.as_tensor(nxt), ct,
                                 tpos + step, seq_len=32)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **MODEL_TOL)
        np.testing.assert_allclose(ct["k"].numpy(), np.asarray(cj["k"]),
                                   **MODEL_TOL)


def test_prefill_decode_reproduce_forward():
    """Torch against torch, drop-free: prefill(16 tokens) then one decode
    step give forward's logits at positions 15 and 16 (f32; a ring cache
    of the reduced window 64 holds all 17)."""
    cfg = dataclasses.replace(get_config("mixtral-8x7b").reduced(), **F32)
    params = TM.init_params(cfg, torch.Generator().manual_seed(3),
                            device="cpu")
    toks = torch.as_tensor(
        np.random.default_rng(3).integers(2, cfg.vocab_size, (2, 17)))
    cf = float(cfg.n_experts)
    full = TM.forward(cfg, params, toks, q_chunk=8, capacity_factor=cf)
    logits, cache, pos = TM.prefill(cfg, params, toks[:, :16], q_chunk=8,
                                    capacity_factor=cf)
    assert pos == 16 and cache["k"].shape[2] == cfg.sliding_window
    torch.testing.assert_close(logits, full[:, 15], **MODEL_TOL)
    logits, _ = TM.decode_step(cfg, params, toks[:, 16], cache, pos,
                               window=cfg.sliding_window)
    torch.testing.assert_close(logits, full[:, 16], **MODEL_TOL)


def test_api_dispatch_moe():
    cfg = get_config("mixtral-8x7b")
    assert api.family(cfg) is TM
    assert api.decode_window(cfg, 100) == 4096
    assert api.decode_capacity(get_config("dbrx-132b"), 100_000) == 8192
    cache = api.init_cache(cfg.reduced(), 3, 100, device="cpu")
    assert tuple(cache["k"].shape) == (2, 3, 64, 2, 64)
    assert cache["k"].dtype == torch.bfloat16


# --------------------------------------------------------------------------
# the paged engine against the routed model API
# --------------------------------------------------------------------------

def _ref_greedy(jcfg, jparams, prompt, n_new):
    """The reference's routed path (its tests/test_paged_decode.py): a
    drop-free prefill into the dense ring cache, then routed decode
    steps."""
    logits, cache, pos = JM.prefill(jcfg, jparams,
                                    jnp.asarray([prompt], jnp.int32),
                                    capacity_factor=float(jcfg.n_experts))
    out = [int(jnp.argmax(logits[0]))]
    step = jax.jit(lambda p, t, c, q: JM.decode_step(
        jcfg, p, t, c, q, window=jcfg.sliding_window))
    for i in range(n_new - 1):
        logits, cache = step(jparams, jnp.asarray([out[-1]], jnp.int32),
                             cache, jnp.int32(pos + i))
        out.append(int(jnp.argmax(logits[0])))
    return out


def _own_greedy(cfg, params, prompt, n_new):
    """The port's routed model API, the same path in torch."""
    logits, cache, pos = TM.prefill(cfg, params, torch.as_tensor([prompt]),
                                    capacity_factor=float(cfg.n_experts))
    out = [int(logits[0].argmax())]
    for i in range(n_new - 1):
        logits, cache = TM.decode_step(cfg, params, torch.as_tensor(
            [out[-1]]), cache, pos + i, window=cfg.sliding_window)
        out.append(int(logits[0].argmax()))
    return out


def test_paged_engine_matches_routed_model_api():
    """float32 reduced mixtral on the reference's converted weights: the
    port's paged engine (paged attention, drop-free routed MLP) emits the
    reference's routed greedy stream, and the port's own routed model API
    emits it too."""
    from repro_torch.serving.engine import EngineConfig, RealEngine
    from repro_torch.serving.request import Request
    jcfg = dataclasses.replace(jax_config("mixtral-8x7b").reduced(), **F32)
    cfg = dataclasses.replace(get_config("mixtral-8x7b").reduced(), **F32)
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    params = _convert(jparams)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(1, cfg.vocab_size, n).tolist() for n in (5, 13)]
    n_new = 12
    eng = RealEngine(cfg, EngineConfig(max_slots=4, max_seq=64,
                                       replicate=False),
                     n_instances=1, device="cpu", params=params)
    reqs = [Request(rid=i, prompt_len=len(p), max_new_tokens=n_new,
                    arrival_time=0.0, prompt_tokens=p)
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    assert len(eng.run(200)) == len(prompts)
    for r, p in zip(reqs, prompts):
        want = _ref_greedy(jcfg, jparams, p, n_new)
        assert r.output_tokens == want
        assert _own_greedy(cfg, params, p, n_new) == want
