"""Weights drawn from the run's seed, on the device, in the dtype they are
served in: one ``randn`` per layer-stacked leaf, scaled in place.

The tree is the port's parameter layout (``models/transformer.py``, dense;
``models/moe.py``, MoE): it is the interface through which the benchmark
hands the port and the reference the same tensors. Scales follow the port's
and the JAX package's initialisers: 1/sqrt(fan_in) for every projection and
expert, 0.02 for the token embedding and for the f32 router, ones for the
norms.
"""
from __future__ import annotations

import math

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
          "float32": torch.float32}


def generator(seed: int, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % (1 << 63))
    return gen


def _normal(gen, shape, scale, dtype, device):
    x = torch.randn(shape, generator=gen, dtype=dtype, device=device)
    return x.mul_(scale)


def draw(model: dict, seed: int, device) -> dict:
    """The parameter tree of ``model`` (a configuration file's ``model``
    block), every random leaf from ``seed``."""
    gen = generator(seed, device)
    dt = DTYPES[model["dtype"]]
    n, d, h, k = (model["n_layers"], model["d_model"], model["n_heads"],
                  model["n_kv_heads"])
    hd, f, v = model["head_dim"], model["d_ff"], model["vocab_size"]

    def w(*shape, dtype=dt, scale=None):
        """A (n_layers, *shape) stack; fan_in is the matrix's rows."""
        scale = scale if scale is not None else 1 / math.sqrt(shape[-2])
        return _normal(gen, (n, *shape), scale, dtype, device)

    layers = {
        "attn": {"wq": w(d, h * hd), "wk": w(d, k * hd), "wv": w(d, k * hd),
                 "wo": w(h * hd, d)},
        "norm_attn": torch.ones((n, d), dtype=dt, device=device),
        "norm_mlp": torch.ones((n, d), dtype=dt, device=device),
    }
    e = model.get("n_experts", 0)
    if e:
        layers["router"] = w(d, e, dtype=torch.float32, scale=0.02)
        layers["experts"] = {"w_gate": w(e, d, f), "w_up": w(e, d, f),
                             "w_down": w(e, f, d)}
    else:
        layers["mlp"] = {"w_gate": w(d, f), "w_up": w(d, f),
                         "w_down": w(f, d)}
    embed = {"tok": _normal(gen, (v, d), 0.02, dt, device),
             "norm_f": torch.ones((d,), dtype=dt, device=device),
             "unembed": _normal(gen, (d, v), 1 / math.sqrt(d), dt, device)}
    return {"embed": embed, "layers": layers}


def layer(stacked: dict, i: int) -> dict:
    """Layer ``i``'s leaves of ``params["layers"]`` (views)."""
    return {key: layer(val, i) if isinstance(val, dict) else val[i]
            for key, val in stacked.items()}
