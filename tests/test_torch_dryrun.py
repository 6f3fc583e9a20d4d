"""The port's dry-run tools against the reference's: the sharding builders'
specs and DTensor placements for every assigned config on both production
meshes (params, optimizer state, batches and decode caches, every profile,
and the degraded layouts), the inputs' stand-ins (``launch/specs.py``) against
``jax.eval_shape``, the per-device FLOPs that ``launch/op_cost.py`` counts
against ``hlo_cost.aggregate`` of the reference's compiled step on one
device, ``op_cost``'s counters against hand counts on a fake 2x2 mesh, one
reduced record per family on that mesh, and the layers' mesh hooks leaving
plain-tensor results unchanged bit for bit.

The reference's ``launch/dryrun.py`` and ``launch/hillclimb.py`` are never
imported here: importing them sets ``XLA_FLAGS`` to 512 host devices for
the rest of the process. The fake process group of the 2x2 mesh lives in a
module fixture that destroys it afterwards."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch.distributed as dist  # noqa: E402
from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402
from torch.distributed.tensor import DTensor, Replicate, Shard  # noqa: E402

from repro.configs import INPUT_SHAPES as J_SHAPES  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.configs import shape_applicable as j_shape_applicable  # noqa: E402
from repro.distributed import sharding as JSH  # noqa: E402
from repro.launch import hlo_cost  # noqa: E402
from repro.launch import specs as JSP  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.training.optimizer import OptimizerConfig as JOptimizerConfig  # noqa: E402
from repro.training.optimizer import init as jopt_init  # noqa: E402
from repro.training.train_loop import make_train_step as jmake_train_step  # noqa: E402
from repro_torch.configs import ASSIGNED, INPUT_SHAPES, InputShape, get_config  # noqa: E402
from repro_torch.distributed import sharding as SH  # noqa: E402
from repro_torch.launch import dryrun, op_cost  # noqa: E402
from repro_torch.launch import specs as SP  # noqa: E402
from repro_torch.models import api, hybrid, moe, ssm  # noqa: E402
from repro_torch.distributed import layout as ML  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.training.optimizer import OptimizerConfig  # noqa: E402
from repro_torch.training.train_loop import make_train_step  # noqa: E402
from repro_torch.training.tree import leaves, leaves_with_paths, unflatten  # noqa: E402

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
LOST = [{1}, {0, 5}]


# --------------------------------------------------------------------------
# layouts: specs and placements against the reference's PartitionSpecs
# --------------------------------------------------------------------------

def _norm(entry):
    if isinstance(entry, tuple) and len(entry) == 1:
        return entry[0]
    return entry


def _want_placements(spec, names):
    """The reference spec's placements, derived here independently."""
    out = [Replicate()] * len(names)
    for dim, axes in enumerate(spec):
        for a in (axes,) if isinstance(axes, str) else (axes or ()):
            out[names.index(a)] = Shard(dim)
    return tuple(out)


def _compare(jtree_shardings, ttree_shardings, names):
    want = [tuple(_norm(e) for e in s.spec)
            for s in jax.tree_util.tree_leaves(jtree_shardings)]
    got = dryrun.sharding_leaves(ttree_shardings)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.spec == w
        assert g.placements == _want_placements(w, names)
    return len(got)


@pytest.fixture(scope="module", params=ASSIGNED)
def structs(request):
    name = request.param
    jcfg, tcfg = jax_config(name), get_config(name)
    jp = JSP.params_struct(jcfg)
    tp = SP.params_struct(tcfg)
    return name, jcfg, tcfg, jp, tp


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_layouts_equal_the_reference(structs, mesh_name):
    """Params under every profile, their AdamW moments, every shape's batch
    and every decode cache: the port's spec and placements per leaf equal
    the reference's; and the degraded layouts after shard losses."""
    name, jcfg, tcfg, jp, tp = structs
    shape, names = MESHES[mesh_name]
    jm = JSH.abstract_mesh(shape, names)
    tm = SH.abstract_mesh(shape, names)
    # the train step's AdamW m and v shard exactly like their param, and
    # the step count replicates
    pshard, opt, _ = dryrun.build_lowerable(
        tcfg, INPUT_SHAPES["train_4k"], tm)[2]
    assert opt.step == SH.replicated(tm) and opt.step.spec == ()
    assert opt.m == pshard and opt.v == pshard
    n = 0
    for profile in SH.PROFILES:
        jsh = JSH.params_shardings(jp, jm, profile)
        tsh = SH.params_shardings(tp, tm, profile)
        n += _compare(jsh, tsh, names)
        for sname, jshape in J_SHAPES.items():
            ok, _ = j_shape_applicable(jcfg, jshape)
            if not ok:
                continue
            ins = JSP.input_specs(jcfg, jshape)
            tins = SP.input_specs(tcfg, INPUT_SHAPES[sname])
            if jshape.kind == "decode":
                n += _compare(
                    JSH.cache_shardings(ins["cache"], jm, jcfg.arch_type),
                    SH.cache_shardings(tins["cache"], tm, tcfg.arch_type),
                    names)
                for lost in LOST:
                    n += _compare(
                        JSH.degraded_cache_shardings(ins["cache"], jm, lost,
                                                     jcfg.arch_type),
                        SH.degraded_cache_shardings(tins["cache"], tm, lost,
                                                    tcfg.arch_type), names)
            else:
                n += _compare(JSH.batch_shardings(ins, jm, profile),
                              SH.batch_shardings(tins, tm, profile), names)
        for lost in LOST:
            n += _compare(JSH.degraded_params_shardings(jp, jm, lost, profile),
                          SH.degraded_params_shardings(tp, tm, lost, profile),
                          names)
    assert n > 100


# --------------------------------------------------------------------------
# specs: the stand-ins against jax.eval_shape's
# --------------------------------------------------------------------------

def _jleaves(tree):
    return {tuple(JSH._seg(p) for p in path): (tuple(leaf.shape),
                                               np.dtype(leaf.dtype).name)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _tleaves(tree):
    return {path:
            (tuple(leaf.shape), str(leaf.dtype).removeprefix("torch."))
            for path, leaf in leaves_with_paths(tree) if leaf is not None}


def test_specs_equal_eval_shape(structs):
    name, jcfg, tcfg, jp, tp = structs
    assert _tleaves(tp) == _jleaves(jp)
    assert _tleaves(SP.opt_state_struct(tp)) == \
        _jleaves(JSP.opt_state_struct(jp))
    for sname, jshape in J_SHAPES.items():
        assert _tleaves(SP.input_specs(tcfg, INPUT_SHAPES[sname])) == \
            _jleaves(JSP.input_specs(jcfg, jshape)), sname


# --------------------------------------------------------------------------
# flops: op_cost on one device against hlo_cost of the compiled reference
# --------------------------------------------------------------------------

def _port_moe_mlp(cfg, p, x, *, capacity_factor=1.25,
                  group_size=jmoe.GROUP_SIZE):
    """The reference's routing, then the port's expert form (every expert
    over every row, weighted by its combine weight, summed over experts),
    in jnp: the port's MoE program, for XLA to count."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    g = min(group_size, b * s)
    xg = x.reshape((b * s) // g, g, d)
    cap = int(max(k, g * k / e * capacity_factor))
    probs = jax.nn.softmax(xg.astype(jnp.float32) @ p["router"], axis=-1)
    topk_p, topk_i = jax.lax.top_k(probs, k)
    topk_p = topk_p / (jnp.sum(topk_p, axis=-1, keepdims=True) + 1e-9)
    onehot = jax.nn.one_hot(topk_i, e, dtype=jnp.float32)
    flat = onehot.reshape(xg.shape[0], g * k, e)
    pos = jnp.sum((jnp.cumsum(flat, axis=1) - flat).reshape(
        xg.shape[0], g, k, e) * onehot, axis=-1)
    combine = jnp.sum(onehot * (topk_p * (pos < cap))[..., None], axis=2)
    xt = xg.reshape(b * s, d).astype(jnp.float32)
    w = {n: p["experts"][n].astype(jnp.float32)
         for n in ("w_gate", "w_up", "w_down")}
    h = jax.nn.silu(jnp.einsum("td,edf->etf", xt, w["w_gate"])) * \
        jnp.einsum("td,edf->etf", xt, w["w_up"])
    y = jnp.einsum("etf,efd->etd", h, w["w_down"])
    out = jnp.sum(combine.reshape(b * s, e).T[..., None] * y, axis=0)
    me = jnp.mean(probs, axis=(0, 1))
    ce = jnp.mean(jnp.mean(onehot, axis=2), axis=(0, 1))
    aux = cfg.router_aux_coef * e * jnp.sum(me * ce)
    return out.reshape(b, s, d).astype(x.dtype), aux


def _jax_flops(jcfg, kind, b, s):
    p = JSP.params_struct(jcfg)
    if kind == "train":
        step = jmake_train_step(jcfg, JOptimizerConfig(), q_chunk=256,
                                remat=False)
        opt = jax.eval_shape(lambda: jopt_init(
            japi.init_params(jcfg, jax.random.PRNGKey(0))))
        batch = {"tokens": jax.ShapeDtypeStruct((b, s + 1), jnp.int32)}
        lowered = jax.jit(step).lower(p, opt, batch)
    elif kind == "prefill":
        batch = {"tokens": jax.ShapeDtypeStruct((b, s), jnp.int32)}
        lowered = jax.jit(lambda p, bt: japi.prefill(
            jcfg, p, bt, q_chunk=256)[:2]).lower(p, batch)
    else:
        cache = jax.eval_shape(lambda: japi.init_cache(jcfg, b, s))
        lowered = jax.jit(lambda p, t, c, pos: japi.decode_step(
            jcfg, p, t, c, pos, seq_len=s)).lower(
            p, jax.ShapeDtypeStruct((b,), jnp.int32), cache,
            jax.ShapeDtypeStruct((), jnp.int32))
    return hlo_cost.aggregate(lowered.compile().as_text())["flops"]


def _zeros(tree):
    return unflatten(tree, [torch.zeros(t.shape, dtype=t.dtype)
                            for t in leaves(tree)])


def _port_flops(tcfg, kind, b, s):
    with FakeTensorMode(allow_non_fake_inputs=True):
        p = _zeros(SP.params_struct(tcfg))
        cost = op_cost.CostMode()
        if kind == "train":
            step = make_train_step(tcfg, OptimizerConfig(), q_chunk=256,
                                   remat=False)
            opt = _zeros(SP.opt_state_struct(SP.params_struct(tcfg)))
            batch = {"tokens": torch.zeros((b, s + 1), dtype=torch.int32)}
            with cost:
                step(p, opt, batch)
        elif kind == "prefill":
            batch = {"tokens": torch.zeros((b, s), dtype=torch.int32)}
            with cost:
                api.prefill(tcfg, p, batch, q_chunk=256)
        else:
            cache = _zeros(api.init_cache(tcfg, b, s, device="meta"))
            with cost:
                api.decode_step(tcfg, p, torch.zeros((b,), dtype=torch.int32),
                                cache, torch.zeros((), dtype=torch.int32),
                                seq_len=s)
    return cost.flops


@pytest.mark.parametrize("kind", ["prefill", "decode", "train"])
@pytest.mark.parametrize("name", ["qwen1.5-0.5b", "mixtral-8x7b",
                                  "mamba2-130m", "recurrentgemma-9b"])
def test_flops_match_hlo_cost_on_one_device(name, kind, monkeypatch):
    """Reduced dense, MoE, SSM and hybrid steps (batch 2, 64 positions,
    remat off on both sides). The port's MoE is another algorithm than the
    reference's dispatch (every expert over every row, E/k times the expert
    FLOPs, no dispatch or combine products), so for MoE the reference is
    lowered with its ``moe_mlp`` replaced by that form in jnp."""
    if name == "mixtral-8x7b":
        monkeypatch.setattr(jmoe, "moe_mlp", _port_moe_mlp)
    b, s = 2, 64
    jcfg = dataclasses.replace(jax_config(name).reduced(), dtype="float32")
    tcfg = dataclasses.replace(get_config(name).reduced(), dtype="float32")
    want = _jax_flops(jcfg, kind, b, s)
    got = _port_flops(tcfg, kind, b, s)
    assert abs(got - want) <= 0.01 * want, (got, want)


# --------------------------------------------------------------------------
# op_cost and the records on a fake 2x2 mesh
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mesh2x2():
    from torch.distributed.device_mesh import DeviceMesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    assert not dist.is_initialized()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    try:
        yield DeviceMesh("cpu", torch.arange(4).reshape(2, 2),
                         mesh_dim_names=("data", "model"))
    finally:
        dist.destroy_process_group()


def test_op_cost_counts_by_hand(mesh2x2):
    """x (8, 16) f32 split over data, w (16, 32) f32 split over model: the
    product runs as one (4, 16) @ (16, 16) per device; replicating its
    columns all-gathers (4, 16) into (4, 32). A plain program's bytes: each
    op's inputs plus outputs, views free."""
    with FakeTensorMode():
        x = DTensor.from_local(torch.empty(4, 16), mesh2x2,
                               [Shard(0), Replicate()], run_check=False)
        w = DTensor.from_local(torch.empty(16, 16), mesh2x2,
                               [Replicate(), Shard(1)], run_check=False)
        cost = op_cost.CostMode()
        with cost:
            y = x @ w
            y.redistribute(mesh2x2, [Shard(0), Replicate()])
        assert cost.flops == 2 * 4 * 16 * 16
        assert cost.coll == {"all_gather": 2 * 4 * 16 * 4}
        assert cost.totals()["coll_bytes"] == 512.0
        a, b = torch.empty(8, 16), torch.empty(32, 16)
        plain = op_cost.CostMode()
        with plain:
            z = torch.relu(a @ b.t())          # t() is a view: free
        assert plain.flops == 2 * 8 * 32 * 16
        assert plain.bytes == (8 * 16 + 32 * 16 + 8 * 32) * 4 + \
            2 * 8 * 32 * 4
        assert plain.coll == {}
        # the product and the relu live at once: peak 2 x (8, 32) f32
        assert plain.peak_bytes == 2 * 8 * 32 * 4
        del z


FAMILY_RECORDS = [("qwen1.5-0.5b", "decode"), ("mixtral-8x7b", "prefill"),
                  ("mamba2-130m", "prefill"), ("recurrentgemma-9b", "decode"),
                  ("internvl2-76b", "prefill"), ("hubert-xlarge", "train")]


@pytest.mark.parametrize("name,kind", FAMILY_RECORDS)
def test_reduced_record_on_fake_mesh(mesh2x2, name, kind):
    cfg = get_config(name).reduced()
    rec = dryrun.dry_run(cfg, InputShape("t", 64, 8, kind), mesh2x2,
                         device="cpu")
    assert rec["n_devices"] == 4
    assert rec["flops"] > 0 and rec["hlo_bytes"] > rec["flops"] / 100
    assert rec["argument_bytes"] > 0 and rec["temp_bytes"] > 0
    assert rec["coll_total"] == sum(rec["collective_bytes"].values()) > 0
    one = dryrun.dry_run(cfg, InputShape("t", 64, 8, kind),
                         {"data": 1, "model": 1}, device="cpu")
    # four devices split the work: each does less than one device alone
    assert rec["flops"] < one["flops"] and one["coll_total"] == 0


# --------------------------------------------------------------------------
# the mesh hooks leave plain tensors alone
# --------------------------------------------------------------------------

def test_hooks_leave_plain_tensors_bit_equal():
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 8, 64, generator=g)
    w = torch.randn(64, 32, generator=g)
    assert ML.use_weight(w) is w and ML.split_ready(x, -1, 4) is x
    assert ML.contract_ready(x, w)[0] is x and ML.grad_split_ready(x, 0, 1) is x
    q = torch.randn(2, 8, 4, 16, generator=g)
    k = torch.randn(2, 8, 2, 16, generator=g)
    v = torch.randn(2, 8, 2, 16, generator=g)
    base = L.attention(q, k, v, causal=True, q_chunk=4)
    with L.shard_hints("model"):
        hinted = L.attention(q, k, v, causal=True, q_chunk=4)
    assert torch.equal(base, hinted)
    # the RG-LRU recurrence over unbound positions == indexing each one
    a, b = torch.rand(2, 33, 16, generator=g), torch.randn(2, 33, 16,
                                                           generator=g)
    h0 = torch.randn(2, 16, generator=g)
    cur, steps = h0, []
    for t in range(b.shape[1]):
        cur = torch.addcmul(b[:, t], a[:, t], cur)
        steps.append(cur)
    got, last = hybrid._sequential(a, b, h0)
    assert torch.equal(got, torch.stack(steps, dim=1)) and \
        torch.equal(last, cur)
    # the NLL: log-softmax and gather, as before
    logits = torch.randn(2, 8, 50, generator=g, dtype=torch.bfloat16)
    tg = torch.randint(0, 50, (2, 8), generator=g)
    logp = torch.log_softmax(logits.float(), dim=-1)
    assert torch.equal(L.token_nll(logits, tg),
                       -torch.gather(logp, -1, tg[..., None])[..., 0])


@pytest.mark.parametrize("name", ["qwen1.5-0.5b", "mixtral-8x7b",
                                  "mamba2-130m", "recurrentgemma-9b"])
def test_model_outputs_bit_equal_with_hints(name):
    """A family's forward, and the Mamba-2 block's projections through
    ``row_matmul``, give the same bits with the sequence hint on."""
    cfg = get_config(name).reduced()
    p = api.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    tokens = torch.randint(1, cfg.vocab_size, (2, 16),
                           generator=torch.Generator().manual_seed(1))
    base = api.forward(cfg, p, tokens)
    with L.shard_hints("model"):
        assert torch.equal(api.forward(cfg, p, tokens), base)
    if name == "mamba2-130m":
        blk = {k: v[0] for k, v in p["layers"].items()}
        x = L.embed(p["embed"], tokens)
        xn = L.rms_norm(x, blk["norm_in"], cfg.norm_eps)
        assert torch.equal(L.row_matmul(xn, blk["in_proj"]),
                           xn @ blk["in_proj"])
        out, _, _ = ssm.ssd_block(cfg, blk, x)
        assert out.dtype == x.dtype and out.shape == x.shape
    if name == "mixtral-8x7b":
        blk = {k: (v[0] if not isinstance(v, dict) else
                   {kk: vv[0] for kk, vv in v.items()})
               for k, v in p["layers"].items()}
        xt = torch.randn(16, cfg.d_model, generator=torch.Generator()
                         .manual_seed(2))
        wts = torch.rand(16, cfg.n_experts,
                         generator=torch.Generator().manual_seed(3))
        want = torch.zeros_like(xt)
        for e in range(cfg.n_experts):
            wg, wu, wd = (blk["experts"][n][e].float()
                          for n in ("w_gate", "w_up", "w_down"))
            want += wts[:, e:e + 1] * ((torch.nn.functional.silu(xt @ wg)
                                        * (xt @ wu)) @ wd)
        assert torch.equal(moe.expert_mix(blk["experts"], xt, wts), want)


def test_hillclimb_roofline_is_the_h100s():
    """The hillclimb's terms divide by an H100 SXM's peaks (bf16 dense,
    HBM) and one 400 Gb/s NDR port per card."""
    from repro_torch.launch import hillclimb
    assert (hillclimb.PEAK, hillclimb.HBM, hillclimb.LINK) == \
        (989e12, 3.35e12, 400e9 / 8)
    rec = {"flops": 989e12, "hlo_bytes": 6.7e12, "coll_total": 25e9}
    assert hillclimb.terms(rec) == (1.0, 2.0, 0.5)
