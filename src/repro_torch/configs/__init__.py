"""Config registry: ``get_config("<arch-id>")`` for the architectures the
port runs so far: the dense family's ``llama3-8b`` and the SSM family's
``mamba2-130m``."""
from repro_torch.configs.base import ModelConfig

from repro_torch.configs import llama3_8b, mamba2_130m

_REGISTRY = {m.CONFIG.name: m.CONFIG for m in (llama3_8b, mamba2_130m)}


def get_config(name: str) -> ModelConfig:
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_configs():
    return sorted(_REGISTRY)
