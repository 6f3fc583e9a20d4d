"""repro_torch.convert: the reference's param pytree -> torch params, bit for
bit, keeping the layer-stacked layout."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs in parallel workers on few
# cores, and idle OpenMP threads spin and starve the other workers
torch.set_num_threads(1)
import jax  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.models import api  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import from_jax_numpy  # noqa: E402
from repro_torch.models import transformer  # noqa: E402


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (k,))
    else:
        yield prefix, tree


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_conversion_is_bit_exact(dtype):
    jcfg = dataclasses.replace(jax_config("llama3-8b").reduced(), dtype=dtype)
    jparams = api.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = from_jax_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                             device="cpu")
    jl = dict(_leaves(jparams))
    tl = dict(_leaves(tparams))
    assert jl.keys() == tl.keys()
    for path, jv in jl.items():
        tv = tl[path]
        assert tv.dtype == getattr(torch, dtype), path
        assert tuple(tv.shape) == tuple(jv.shape), path
        want = np.asarray(jv)
        bits = np.int16 if dtype == "bfloat16" else np.int32
        got = tv.view(torch.int16 if dtype == "bfloat16" else torch.int32)
        np.testing.assert_array_equal(got.numpy(), want.view(bits),
                                      err_msg=str(path))


def test_layer_stacked_layout_matches_port_init():
    """A converted reference tree and the port's own init share one
    structure: same keys, shapes and dtypes, leading n_layers axis on every
    leaf under ``layers``."""
    jcfg = jax_config("llama3-8b").reduced()
    cfg = get_config("llama3-8b").reduced()
    conv = from_jax_numpy(jax.tree_util.tree_map(
        np.asarray, api.init_params(jcfg, jax.random.PRNGKey(1))),
        device="cpu")
    gen = torch.Generator().manual_seed(0)
    own = transformer.init_params(cfg, gen, device="cpu")
    cl, ol = dict(_leaves(conv)), dict(_leaves(own))
    assert cl.keys() == ol.keys()
    for path in cl:
        assert cl[path].shape == ol[path].shape, path
        assert cl[path].dtype == ol[path].dtype, path
        if path[0] == "layers":
            assert cl[path].shape[0] == cfg.n_layers, path
    # the port's init keeps the reference's scales
    assert abs(float(own["embed"]["tok"].float().std()) - 0.02) < 2e-3
    wq = own["layers"]["attn"]["wq"].float()
    assert abs(float(wq.std()) - cfg.d_model ** -0.5) < 5e-3
    assert torch.equal(own["layers"]["norm_attn"],
                       torch.ones_like(own["layers"]["norm_attn"]))
