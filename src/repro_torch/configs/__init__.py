"""Config registry: ``get_config("<arch-id>")`` for every architecture the
reference registers: the dense family (``llama3-8b``, ``yi-9b``,
``qwen1.5-0.5b``, ``qwen1.5-32b``, ``deepseek-67b``), the MoE family
(``mixtral-8x7b``, ``dbrx-132b``), the SSM family's ``mamba2-130m``, the
hybrid family's ``recurrentgemma-9b``, the VLM ``internvl2-76b`` and the
audio encoder ``hubert-xlarge``. ``ASSIGNED`` is every one but the paper's
own ``llama3-8b``."""
from repro_torch.configs.base import (  # noqa: F401 — re-exported
    ARCH_TYPES, INPUT_SHAPES, InputShape, ModelConfig, shape_applicable,
)

from repro_torch.configs import (
    dbrx_132b, deepseek_67b, hubert_xlarge, internvl2_76b, llama3_8b,
    mamba2_130m, mixtral_8x7b, qwen1_5_0_5b, qwen1_5_32b, recurrentgemma_9b,
    yi_9b,
)

_REGISTRY = {
    m.CONFIG.name: m.CONFIG
    for m in (
        qwen1_5_0_5b, mamba2_130m, recurrentgemma_9b, yi_9b, qwen1_5_32b,
        internvl2_76b, mixtral_8x7b, deepseek_67b, dbrx_132b, hubert_xlarge,
        llama3_8b,
    )
}

ASSIGNED = [n for n in _REGISTRY if n != "llama3-8b"]


def get_config(name: str) -> ModelConfig:
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_configs():
    return sorted(_REGISTRY)
