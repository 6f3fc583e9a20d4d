"""Weights drawn from the run's seed, on the device, in the dtype they are
served in: one ``randn`` per layer-stacked leaf, scaled in place.

The tree is the port's parameter layout for the model's family, drawn by
``families/<arch_type>.py`` with the helpers here: it is the interface
through which the benchmark hands the port and the reference the same
tensors. Scales follow the port's and the JAX package's initialisers:
1/sqrt(fan_in) for every projection and expert, 0.02 for the token embedding
and for the f32 router, ones for the norms.
"""
from __future__ import annotations

import math

import torch

from servebench import families

DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
          "float32": torch.float32}


def generator(seed: int, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % (1 << 63))
    return gen


def _normal(gen, shape, scale, dtype, device):
    x = torch.randn(shape, generator=gen, dtype=dtype, device=device)
    return x.mul_(scale)


def stacker(gen, model: dict, dtype, device):
    """``w(*shape, dtype=dtype, scale=None)``: an (n_layers, *shape) stack of
    normal draws from ``gen``, scaled by 1/sqrt(fan_in) (the matrix's rows)
    unless ``scale`` is given."""
    n = model["n_layers"]

    def w(*shape, dtype=dtype, scale=None):
        scale = scale if scale is not None else 1 / math.sqrt(shape[-2])
        return _normal(gen, (n, *shape), scale, dtype, device)
    return w


def embedding(gen, model: dict, dtype, device) -> dict:
    """The token embedding, the final norm and the unembedding."""
    d, v = model["d_model"], model["vocab_size"]
    return {"tok": _normal(gen, (v, d), 0.02, dtype, device),
            "norm_f": torch.ones((d,), dtype=dtype, device=device),
            "unembed": _normal(gen, (d, v), 1 / math.sqrt(d), dtype, device)}


def draw(model: dict, seed: int, device) -> dict:
    """The parameter tree of ``model`` (a configuration file's ``model``
    block), every random leaf from ``seed``: its family's layout
    (``families/<arch_type>.py``)."""
    return families.load(model).draw(model, seed, device)


def layer(stacked: dict, i: int) -> dict:
    """Layer ``i``'s leaves of ``params["layers"]`` (views)."""
    return {key: layer(val, i) if isinstance(val, dict) else val[i]
            for key, val in stacked.items()}
