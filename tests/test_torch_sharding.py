"""The port's sharding rules (``distributed/sharding.py``, plain Python
over shapes) against the reference's (``jax.sharding`` specs over an
abstract mesh): ``param_spec`` under every profile on a sweep of shapes,
the decode-cache rules of every family, and ``degradation_summary`` —
key for key — for the five full-size dense configs, the MoE configs and
the hybrid recurrentgemma-9b (its per-layer param list and per-layer decode
state), 4 and 8 shards, and several lost sets. Nothing is allocated: the
reference's trees come from ``jax.eval_shape`` and the port's from meta
tensors."""
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
import jax  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.distributed import sharding as JSH  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.serving.engine import EngineConfig as JEngineConfig  # noqa: E402
from repro.serving.engine import RealEngine as JRealEngine  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.distributed import sharding as SH  # noqa: E402
from repro_torch.models import api, transformer  # noqa: E402
from repro_torch.serving.engine import EngineConfig, RealEngine  # noqa: E402

DENSE = ["llama3-8b", "yi-9b", "qwen1.5-0.5b", "qwen1.5-32b", "deepseek-67b"]
MOE = ["mixtral-8x7b", "dbrx-132b"]
HYBRID = ["recurrentgemma-9b"]
LOST = [{1}, {1, 2}, {0, 2, 3}]


def _jmesh(n_data, n_model):
    return JSH.abstract_mesh((n_data, n_model), ("data", "model"))


def _trees(name):
    """(name, reference param and cache shapes, port param and cache
    shapes) at full size, for B = 8 sequences of 256 tokens."""
    jcfg, tcfg = jax_config(name), get_config(name)
    jp = jax.eval_shape(lambda: japi.init_params(jcfg, jax.random.PRNGKey(0)))
    jc = jax.eval_shape(lambda: japi.init_cache(jcfg, 8, 256))
    tp = api.init_params(tcfg, None, device="meta")
    tc = SH.decode_cache_shape(tcfg, 8, 256)
    return name, jp, jc, tp, tc


@pytest.fixture(scope="module", params=DENSE + MOE + HYBRID)
def trees(request):
    return _trees(request.param)


def test_param_and_cache_trees_have_the_reference_leaves(trees):
    """Same leaves (by path), shapes and dtypes in both packages — the
    census walks the same tensors."""
    _, jp, jc, tp, tc = trees

    def flat(tree):
        return {tuple(JSH._seg(p) for p in path): leaf for path, leaf in
                jax.tree_util.tree_flatten_with_path(tree)[0]}
    for jtree, ttree in ((jp, tp), (jc, tc)):
        want = {k: (tuple(v.shape), np.dtype(v.dtype).name)
                for k, v in flat(jtree).items()}
        got = {path: (tuple(leaf.shape),
                      str(leaf.dtype).removeprefix("torch."))
               for path, leaf in SH._leaves(ttree)}
        assert got == want


@pytest.mark.parametrize("n_shards", [4, 8])
def test_degradation_summary_matches_reference(trees, n_shards):
    name, jp, jc, tp, tc = trees
    arch = get_config(name).arch_type
    for lost in LOST:
        want = JSH.degradation_summary(jp, _jmesh(1, n_shards), lost,
                                       cache_shape=jc, arch_type=arch)
        got = SH.degradation_summary(tp, SH.mesh(n_shards), lost,
                                     cache_shape=tc, arch_type=arch)
        assert got == want, (name, n_shards, lost)


@pytest.mark.parametrize("name", MOE)
def test_expert_parallel_summary_matches_reference(name):
    """The expert-parallel profile at a 16-way model axis: dbrx's 16
    experts split over it, mixtral's 8 do not (its expert stacks fall back
    to the last-dim rule), and the summaries equal the reference's at 16
    shards and after losing some."""
    _, jp, jc, tp, tc = _trees(name)
    cfg = get_config(name)
    shape = (cfg.n_layers, cfg.n_experts, cfg.d_model, cfg.d_ff)
    spec = SH.param_spec(("layers", "experts", "w_gate"), shape,
                         SH.mesh(16), True, "expert_parallel")
    assert (spec[1] == "model") == (cfg.n_experts % 16 == 0)
    for lost in [{15}] + LOST:
        for profile in ("expert_parallel", "serve_model_only"):
            want = JSH.degradation_summary(jp, _jmesh(1, 16), lost,
                                           profile=profile, cache_shape=jc,
                                           arch_type="moe")
            got = SH.degradation_summary(tp, SH.mesh(16), lost,
                                         profile=profile, cache_shape=tc,
                                         arch_type="moe")
            assert got == want, (name, profile, lost)


def test_losing_every_shard_raises():
    tp = transformer.init_params(get_config("llama3-8b").reduced(), None,
                                 device="meta")
    with pytest.raises(ValueError, match="all 4 model shards lost"):
        SH.degradation_summary(tp, SH.mesh(4), {0, 1, 2, 3})
    with pytest.raises(ValueError):
        SH.degraded_mesh(SH.mesh(2), [0, 1, 1, 0])   # a set: 2 lost of 2
    assert SH.degraded_mesh(SH.mesh(4), [2, 2]) == {"data": 1, "model": 3}


SHAPES = [(), (7,), (64,), (4096,), (8, 4096), (4096, 14336), (5120, 27392),
          (32, 4096, 1024), (32, 64), (2, 3), (95, 8192, 8192),
          (8, 4, 4096, 14336), (40, 5120), (24, 1024)]
PATHS = [("layers", "attn", "wq"), ("embed", "tok"), ("layers", "attn", "bq"),
         ("layers", "experts", "w_up")]


@pytest.mark.parametrize("profile", SH.PROFILES)
def test_param_spec_matches_reference_on_a_sweep(profile):
    for (nd, nm), shape, path, stacked in itertools.product(
            [(1, 4), (1, 3), (2, 4), (16, 8), (4, 6)], SHAPES, PATHS,
            [False, True]):
        want = JSH.param_spec(path, shape, _jmesh(nd, nm), stacked, profile)
        got = SH.param_spec(path, shape, SH.mesh(nm, nd), stacked, profile)
        assert got == tuple(want), (profile, nd, nm, shape, path, stacked)


def test_degraded_spec_matches_reference():
    for shape, lost in itertools.product(SHAPES, LOST):
        want = JSH.degraded_spec(("layers", "mlp", "w_up"), shape,
                                 _jmesh(2, 8), lost, True)
        got = SH.degraded_spec(("layers", "mlp", "w_up"), shape,
                               SH.mesh(8, 2), lost, True)
        assert got == tuple(want), (shape, lost)


CACHES = {
    "dense": {"k": (32, 8, 256, 8, 128), "v": (32, 8, 256, 8, 128),
              "k_scale": (32, 8, 256, 8, 1), "v_scale": (32, 7, 30, 8, 1)},
    "ssm": {"conv": (24, 8, 3, 1792), "ssm": (24, 8, 24, 64, 128)},
    "hybrid": {"h": (8, 4096), "conv": (6, 3, 4000),
               "k": (8, 2048, 1, 256), "v": (9, 100, 1, 256)},
}


@pytest.mark.parametrize("arch", ["dense", "moe", "vlm", "ssm", "hybrid",
                                  "audio"])
def test_cache_specs_match_reference(arch):
    tree = CACHES.get("dense" if arch in ("moe", "vlm", "audio") else arch)
    jtree = {k: jax.ShapeDtypeStruct(s, np.float32) for k, s in tree.items()}
    ttree = {k: SH.Leaf(s, torch.float32) for k, s in tree.items()}
    for nd, nm in [(1, 4), (2, 3), (8, 8)]:
        want = [s.spec for s in jax.tree_util.tree_leaves(
            JSH.cache_shardings(jtree, _jmesh(nd, nm), arch))]
        got = SH.cache_specs(ttree, SH.mesh(nm, nd), arch)
        assert got == [tuple(w) for w in want], (arch, nd, nm)


@pytest.mark.parametrize("name", ["llama3-8b", "qwen1.5-32b"] + MOE + HYBRID)
def test_engine_degradation_layout_matches_reference(name):
    """The layout each engine attaches to a degraded instance (its own
    params and decode-cache shapes) on the reduced config."""
    kw = dict(max_slots=4, max_seq=64, n_shards=4)
    jeng = JRealEngine(jax_config(name).reduced(), JEngineConfig(**kw),
                       n_instances=1, seed=0)
    teng = RealEngine(get_config(name).reduced(), EngineConfig(**kw),
                      n_instances=1, seed=0, device="cpu")
    for lost in ({1}, {0, 3}):
        assert teng._degradation_layout(lost) == \
            jeng._degradation_layout(lost)
