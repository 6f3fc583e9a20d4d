"""Config registry: ``get_config("<arch-id>")`` for the architectures the
port runs so far: the dense family (``llama3-8b``, ``yi-9b``,
``qwen1.5-0.5b``, ``qwen1.5-32b``, ``deepseek-67b``) and the SSM family's
``mamba2-130m``."""
from repro_torch.configs.base import (  # noqa: F401 — re-exported
    ARCH_TYPES, INPUT_SHAPES, InputShape, ModelConfig, shape_applicable,
)

from repro_torch.configs import (
    deepseek_67b, llama3_8b, mamba2_130m, qwen1_5_0_5b, qwen1_5_32b, yi_9b,
)

_REGISTRY = {
    m.CONFIG.name: m.CONFIG
    for m in (qwen1_5_0_5b, mamba2_130m, yi_9b, qwen1_5_32b, deepseek_67b,
              llama3_8b)
}


def get_config(name: str) -> ModelConfig:
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_configs():
    return sorted(_REGISTRY)
