"""The port's configs against the reference's: every field (source
included), ``n_params``, ``n_active_params`` and ``reduced()`` of every
registered config; the input shapes and their policy for every registered
config; and, on converted float32 weights, the engine's greedy streams on
the reduced yi-9b (GQA rep 2), qwen1.5-0.5b (QKV bias, MHA) and
qwen1.5-32b (on the int8 pool) and the hybrid recurrentgemma-9b, with
monolithic and chunked prefill (the MoE configs' engine streams are
tests/test_torch_engine.py's)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs in parallel workers on few cores
torch.set_num_threads(1)
import jax  # noqa: E402

from repro import configs as JC  # noqa: E402
from repro.serving.engine import EngineConfig as JEngineConfig  # noqa: E402
from repro.serving.engine import RealEngine as JRealEngine  # noqa: E402
from repro.serving.request import Request as JRequest  # noqa: E402
from repro_torch import configs as TC  # noqa: E402
from repro_torch.convert import from_jax_numpy  # noqa: E402
from repro_torch.serving.engine import EngineConfig, RealEngine  # noqa: E402
from repro_torch.serving.request import Request  # noqa: E402

NEW = ["yi-9b", "qwen1.5-0.5b", "qwen1.5-32b", "deepseek-67b"]
MOE = ["mixtral-8x7b", "dbrx-132b"]
HYBRID = ["recurrentgemma-9b"]
TRAIN = ["internvl2-76b", "hubert-xlarge"]     # the VLM and the encoder
F32 = dict(dtype="float32", kv_dtype="float32")


def test_registry_holds_the_dense_family_and_mamba2():
    """Every config of the reference is registered (the VLM and the audio
    encoder since the training slice), in the reference's order, and
    ``ASSIGNED`` is the reference's list of 10."""
    assert TC.list_configs() == sorted(
        NEW + MOE + HYBRID + TRAIN + ["llama3-8b", "mamba2-130m"])
    assert TC.list_configs() == JC.list_configs()
    assert TC.ASSIGNED == JC.ASSIGNED and len(TC.ASSIGNED) == 10
    with pytest.raises(KeyError, match="unknown arch"):
        TC.get_config("gpt-2")


@pytest.mark.parametrize("name", NEW + MOE + ["llama3-8b", "mamba2-130m"]
                         + HYBRID + TRAIN)
def test_config_equals_reference_field_for_field(name):
    t, j = TC.get_config(name), JC.get_config(name)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.n_params() == j.n_params()
    assert t.n_active_params() == j.n_active_params()
    assert t.q_per_kv == j.q_per_kv and t.head_dim == j.head_dim
    assert dataclasses.asdict(t.reduced()) == dataclasses.asdict(j.reduced())


def test_input_shapes_and_policy_match_reference():
    assert {k: dataclasses.asdict(v) for k, v in TC.INPUT_SHAPES.items()} \
        == {k: dataclasses.asdict(v) for k, v in JC.INPUT_SHAPES.items()}
    for name in TC.list_configs():
        for shape in TC.INPUT_SHAPES:
            assert TC.shape_applicable(TC.get_config(name),
                                       TC.INPUT_SHAPES[shape]) == \
                JC.shape_applicable(JC.get_config(name),
                                    JC.INPUT_SHAPES[shape]), (name, shape)


def test_reduced_head_geometries():
    """What the CPU can run of each config's attention: GQA cut to rep 2,
    MHA kept at rep 1."""
    reps = {n: TC.get_config(n).reduced().q_per_kv for n in NEW}
    assert reps == {"yi-9b": 2, "qwen1.5-0.5b": 1, "qwen1.5-32b": 1,
                    "deepseek-67b": 2}
    assert TC.get_config("qwen1.5-0.5b").reduced().qkv_bias


def _to_jax(params):
    """The port's float32 params -> the reference's tree of jnp arrays."""
    if isinstance(params, dict):
        return {k: _to_jax(v) for k, v in params.items()}
    return jax.numpy.asarray(params.numpy())


CASES = [("yi-9b", {}), ("qwen1.5-0.5b", {}),
         ("qwen1.5-32b", dict(kv_quant=True)), ("recurrentgemma-9b", {})]


@pytest.mark.parametrize("chunk", [0, 8])
@pytest.mark.parametrize("name,knobs", CASES, ids=[c[0] for c in CASES])
def test_engine_streams_match_reference(name, knobs, chunk):
    """The same 3 prompts (5 to 20 tokens: up to three chunks of 8) x 8
    greedy tokens through both engines on the same weights and knobs."""
    jcfg = dataclasses.replace(JC.get_config(name).reduced(), **F32)
    tcfg = dataclasses.replace(TC.get_config(name).reduced(), **F32)
    ecfg = dict(max_slots=4, max_seq=64, replicate=False,
                prefill_chunk=chunk, **knobs)
    jeng = JRealEngine(jcfg, JEngineConfig(**ecfg), n_instances=1, seed=0)
    params = from_jax_numpy(jax.tree_util.tree_map(np.asarray, jeng.params),
                            device="cpu")
    if tcfg.qkv_bias:
        # the reference inits the biases at zero: make them matter
        rng = np.random.default_rng(3)
        for b in ("bq", "bk", "bv"):
            params["layers"]["attn"][b] = torch.as_tensor(
                rng.normal(0, 0.5, params["layers"]["attn"][b].shape),
                dtype=torch.float32)
        jeng.params = _to_jax(params)
        for inst in jeng.instances:
            inst.params = jeng.params
    teng = RealEngine(tcfg, EngineConfig(**ecfg), n_instances=1,
                      device="cpu", params=params)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, tcfg.vocab_size, n).tolist()
               for n in (5, 13, 20)]
    for eng, cls in ((jeng, JRequest), (teng, Request)):
        for i, p in enumerate(prompts):
            eng.submit(cls(rid=i, prompt_len=len(p), max_new_tokens=8,
                           arrival_time=0.0, prompt_tokens=p))
        assert len(eng.run(300)) == len(prompts)
    assert teng.instances[0].pool.quantized == knobs.get("kv_quant", False)
    assert {r.rid: r.output_tokens for r in teng.done} == \
        {r.rid: r.output_tokens for r in jeng.done}

