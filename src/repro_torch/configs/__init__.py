"""Config registry: ``get_config("<arch-id>")`` for the architectures the
port serves so far (the dense family's ``llama3-8b``)."""
from repro_torch.configs.base import ModelConfig

from repro_torch.configs import llama3_8b

_REGISTRY = {m.CONFIG.name: m.CONFIG for m in (llama3_8b,)}


def get_config(name: str) -> ModelConfig:
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_configs():
    return sorted(_REGISTRY)
