"""The port's training path (``models/api.loss``, ``training/*``) against the
reference's, on float32 reduced configs with converted params: the loss and
every gradient leaf of each of the six families against
``jax.value_and_grad(repro.models.api.loss)``; AdamW's update, schedule and
clipping; the data pipeline bit for bit; checkpoints crossing between the
packages both ways bit for bit; five ``train()`` steps against the
reference's history; and the reference's end-to-end loss test on the port.
"""
import dataclasses
import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs in parallel workers on few cores
torch.set_num_threads(1)
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.training import checkpoint as jck  # noqa: E402
from repro.training import data as jdata  # noqa: E402
from repro.training import optimizer as jopt  # noqa: E402
from repro.training import train_loop as jloop  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import from_jax_numpy  # noqa: E402
from repro_torch.models import api, ssm  # noqa: E402
from repro_torch.training import checkpoint as ck  # noqa: E402
from repro_torch.training import data  # noqa: E402
from repro_torch.training import optimizer as opt  # noqa: E402
from repro_torch.training import train_loop as loop  # noqa: E402
from repro_torch.training.tree import leaves, leaves_with_paths  # noqa: E402

# one reduced config of each family
FAMILIES = ["qwen1.5-0.5b", "mixtral-8x7b", "mamba2-130m",
            "recurrentgemma-9b", "internvl2-76b", "hubert-xlarge"]
B, S = 2, 32


def _configs(name, dtype="float32"):
    return (dataclasses.replace(jax_config(name).reduced(), dtype=dtype),
            dataclasses.replace(get_config(name).reduced(), dtype=dtype))


def _params(jcfg, seed=0):
    jparams = japi.init_params(jcfg, jax.random.PRNGKey(seed))
    return jparams, from_jax_numpy(jax.tree_util.tree_map(np.asarray,
                                                          jparams),
                                   device="cpu")


def _jax_leaves(tree):
    """(path, numpy leaf) in jax.tree order, paths as the port writes them."""
    return [("/".join(jck._seg(p) for p in path), np.asarray(leaf))
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]]


def _torch_batch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


# --------------------------------------------------------------------------
# loss and gradients, every family
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", FAMILIES)
def test_loss_and_gradients_match_reference(name):
    """Loss within 1e-5 relative; each gradient leaf's largest absolute
    difference at most 1e-4 x the reference leaf's largest magnitude."""
    jcfg, cfg = _configs(name)
    jparams, tparams = _params(jcfg)
    batch = jdata.make_batch(jcfg, B, S, seed=1, n_patches=8)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: japi.loss(jcfg, p, b, q_chunk=16)))(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    flat = [p.requires_grad_() for p in leaves(tparams)]
    loss = api.loss(cfg, tparams, _torch_batch(batch), q_chunk=16)
    # the encoder never reads its token embedding: zero, as in jax.grad
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(
        flat, torch.autograd.grad(loss, flat, allow_unused=True))]
    assert loss.dtype == torch.float32 and loss.ndim == 0
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    want = _jax_leaves(jgrads)
    paths = ["/".join(p) for p, _ in leaves_with_paths(tparams)]
    assert paths == [p for p, _ in want]
    for path, g, (_, w) in zip(paths, grads, want):
        assert g.shape == w.shape and g.dtype == torch.float32, path
        bound = 1e-4 * np.abs(w).max()
        err = np.abs(g.numpy() - w).max()
        assert err <= bound, (path, err, bound)


def test_vlm_loss_without_patches_matches_reference():
    jcfg, cfg = _configs("internvl2-76b")
    jparams, tparams = _params(jcfg)
    toks = jdata.make_batch(jcfg, B, S, seed=2)["tokens"]
    want = japi.loss(jcfg, jparams, {"tokens": jnp.asarray(toks)})
    got = api.loss(cfg, tparams, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)


# --------------------------------------------------------------------------
# optimizer
# --------------------------------------------------------------------------

def test_optimizer_update_matches_reference():
    """Three AdamW steps on the same gradients (one step clipped): params,
    m, v and the metrics within 1e-6 relative (elementwise, or to the
    leaf's largest magnitude near 0), every leaf in its dtype,
    decay on every leaf with ndim >= 2 (the stacked norms and A_log)."""
    jcfg, _ = _configs("mamba2-130m")
    jparams, tparams = _params(jcfg)
    ocfg = opt.OptimizerConfig(warmup_steps=2, total_steps=10)
    jocfg = jopt.OptimizerConfig(warmup_steps=2, total_steps=10)
    rng = np.random.default_rng(0)
    jst, tst = jopt.init(jparams), opt.init(tparams)
    for step, mag in enumerate((1e-3, 10.0, 1e-2)):    # step 2 is clipped
        g = [(rng.standard_normal(np.shape(p)) * mag).astype(np.float32)
             for p in jax.tree.leaves(jparams)]
        jg = jax.tree.unflatten(jax.tree.structure(jparams),
                                [jnp.asarray(x) for x in g])
        tg = from_jax_numpy(jax.tree_util.tree_map(np.asarray, jg),
                            device="cpu")
        jparams, jst, jm = jopt.update(jocfg, jparams, jg, jst)
        tparams, tst, tm = opt.update(ocfg, tparams, tg, tst)
        assert int(tst.step) == int(jst.step) == step + 1
        for key in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                       rtol=1e-6)
        for tree_t, tree_j in ((tparams, jparams), (tst.m, jst.m),
                               (tst.v, jst.v)):
            for t, (path, w) in zip(leaves(tree_t), _jax_leaves(tree_j)):
                assert t.dtype == getattr(torch, str(w.dtype)), path
                # 1e-6 relative, an element near 0 relative to its leaf's
                # largest magnitude (the two packages round m, v and the
                # step in other orders)
                np.testing.assert_allclose(
                    t.numpy(), w, rtol=1e-6,
                    atol=1e-6 * float(np.abs(w).max()), err_msg=path)
    assert float(tm["grad_norm"]) > 0
    # the stacked (L, h) A_log decays, as in the reference
    a0 = from_jax_numpy(np.asarray(japi.init_params(
        jcfg, jax.random.PRNGKey(0))["layers"]["A_log"]), device="cpu")
    moved, _, _ = opt.update(ocfg, {"A_log": a0},
                             {"A_log": torch.zeros_like(a0)},
                             opt.init({"A_log": a0}))
    assert a0.ndim == 2 and not torch.equal(moved["A_log"], a0)


def test_schedule_warmup_cosine():
    ocfg = opt.OptimizerConfig(lr=1e-3, warmup_steps=10, total_steps=100)
    assert float(opt.schedule(ocfg, torch.tensor(5, dtype=torch.int32))) \
        == pytest.approx(5e-4)
    assert float(opt.schedule(ocfg, torch.tensor(10, dtype=torch.int32))) \
        == pytest.approx(1e-3)
    assert float(opt.schedule(ocfg, torch.tensor(100, dtype=torch.int32))) \
        == pytest.approx(0.0, abs=1e-9)
    jocfg = jopt.OptimizerConfig(lr=1e-3, warmup_steps=10, total_steps=100)
    for s in range(0, 120, 7):
        np.testing.assert_allclose(
            float(opt.schedule(ocfg, torch.tensor(s, dtype=torch.int32))),
            float(jopt.schedule(jocfg, jnp.int32(s))), rtol=1e-6,
            atol=1e-6 * ocfg.lr)    # 1 + cos near pi cancels


def test_grad_clipping():
    ocfg = opt.OptimizerConfig(clip_norm=1.0, weight_decay=0.0)
    params = {"w": torch.ones((4, 4))}
    grads = {"w": torch.full((4, 4), 100.0)}
    p2, _, m = opt.update(ocfg, params, grads, opt.init(params))
    assert float(m["grad_norm"]) == pytest.approx(400.0)
    # clipped: the effective g is g / 400, m_hat = g_clip, the step is
    # bounded by lr
    assert float((p2["w"] - params["w"]).abs().max()) < 2 * ocfg.lr
    assert torch.equal(params["w"], torch.ones((4, 4)))   # inputs kept


# --------------------------------------------------------------------------
# data
# --------------------------------------------------------------------------

def test_token_stream_equals_reference():
    jcfg, cfg = _configs("qwen1.5-0.5b")
    for seed in (0, 7):
        dj = iter(jdata.TokenStream(jcfg, jdata.DataConfig(3, 40, seed)))
        dt = iter(data.TokenStream(cfg, data.DataConfig(3, 40, seed)))
        for _ in range(4):
            a, b = next(dj), next(dt)
            assert b["tokens"].dtype == np.int32
            np.testing.assert_array_equal(a["tokens"], b["tokens"])
    assert b["tokens"].shape == (3, 41)
    assert b["tokens"].max() < cfg.vocab_size


@pytest.mark.parametrize("name", FAMILIES)
def test_make_batch_equals_reference(name):
    jcfg, cfg = _configs(name)
    want = jdata.make_batch(jcfg, 2, 16, seed=3)
    got = data.make_batch(cfg, 2, 16, seed=3)
    assert set(got) == set(want)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key])


# --------------------------------------------------------------------------
# checkpoints
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["mamba2-130m", "recurrentgemma-9b"])
def test_checkpoints_cross_both_ways_bit_for_bit(name):
    """bf16 params (Mamba-2 mixes f32 leaves in; the hybrid keeps a list of
    layer dicts, keys "0", "1", ...) and an optimizer state: the reference
    writes, the port restores, and the reverse."""
    jcfg, cfg = _configs(name, dtype="bfloat16")
    jparams, tparams = _params(jcfg, seed=4)
    tree_t = {"params": tparams, "opt": opt.init(tparams)}
    tree_j = {"params": jparams, "opt": jopt.init(jparams)}
    with tempfile.TemporaryDirectory() as d:
        jck.save(d, tree_j, step=17)
        got, step = ck.restore(d, tree_t)
    assert step == 17
    pairs = list(zip(leaves_with_paths(got), _jax_leaves(tree_j)))
    assert any(t.dtype == torch.bfloat16 for (_, t), _ in pairs)
    for (path, t), (jpath, w) in pairs:
        assert "/".join(path) == jpath
        assert t.dtype == getattr(torch, str(w.dtype))
        assert np.array_equal(
            t.view(torch.int16).numpy() if t.dtype == torch.bfloat16
            else t.numpy(), w.view(np.int16) if w.dtype.name == "bfloat16"
            else w)
    with tempfile.TemporaryDirectory() as d:
        ck.save(d, tree_t, step=5)
        back, step = jck.restore(d, tree_j)
        again, _ = ck.restore(d, tree_t)
    assert step == 5
    for (_, w), (_, j) in zip(_jax_leaves(tree_j), _jax_leaves(back)):
        assert w.dtype == j.dtype and w.tobytes() == j.tobytes()
    for a, b in zip(leaves(tree_t), leaves(again)):
        assert a.dtype == b.dtype and torch.equal(a, b)


# --------------------------------------------------------------------------
# the train loop
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["qwen1.5-0.5b", "mamba2-130m"])
def test_five_train_steps_match_reference_history(name):
    jcfg, cfg = _configs(name)
    jparams, tparams = _params(jcfg, seed=5)
    args = (jdata.DataConfig(batch_size=2, seq_len=32),
            jopt.OptimizerConfig(warmup_steps=2, total_steps=10),
            jloop.TrainerConfig(steps=5, log_every=1))
    want = jloop.train(jcfg, *args, params=jparams)["history"]
    got = loop.train(cfg, data.DataConfig(batch_size=2, seq_len=32),
                     opt.OptimizerConfig(warmup_steps=2, total_steps=10),
                     loop.TrainerConfig(steps=5, log_every=1),
                     params=tparams, device="cpu")["history"]
    assert [h["step"] for h in got] == [1, 2, 3, 4, 5]
    assert set(got[0]) == set(want[0])
    for g, w in zip(got, want):
        for key in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(g[key], w[key], rtol=1e-4,
                                       err_msg=key)


@pytest.mark.parametrize("remat", [True, False])
def test_remat_recomputes_each_scan_once(remat):
    """With remat the backward recomputes the forward: every layer's scan
    runs twice a step (once without), then the backward differentiates the
    plain form; the loss and the update do not depend on remat."""
    _, cfg = _configs("mamba2-130m")
    _, tparams = _params(_configs("mamba2-130m")[0], seed=6)
    step = loop.make_train_step(cfg, opt.OptimizerConfig(), q_chunk=32,
                                remat=remat)
    batch = _torch_batch(data.make_batch(cfg, 2, 32, seed=6))
    ssm.plain_scans = 0
    p2, _, m = step(tparams, opt.init(tparams), batch)
    assert ssm.plain_scans == cfg.n_layers * (2 if remat else 1)
    ref = loop.make_train_step(cfg, opt.OptimizerConfig(), q_chunk=32,
                               remat=not remat)
    p3, _, m3 = ref(tparams, opt.init(tparams), batch)
    assert float(m["loss"]) == float(m3["loss"])
    for a, b in zip(leaves(p2), leaves(p3)):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


def test_loss_decreases_end_to_end():
    """The reference's end-to-end test, on the port (bf16 reduced qwen)."""
    cfg = get_config("qwen1.5-0.5b").reduced()
    out = loop.train(cfg, data.DataConfig(batch_size=4, seq_len=64),
                     opt.OptimizerConfig(warmup_steps=5, total_steps=40),
                     loop.TrainerConfig(steps=40, log_every=10),
                     device="cpu")
    h = out["history"]
    assert h[-1]["loss"] < h[0]["loss"] - 1.0
    assert all(np.isfinite(r["grad_norm"]) for r in h)
