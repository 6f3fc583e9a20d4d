"""Mixtral-style decoders (``models/moe.py`` in the port): the dense family
with each MLP replaced by a float32 router over ``n_experts`` SwiGLU experts,
of which each token takes its ``top_k``."""
from __future__ import annotations

import torch

from servebench import flops
from servebench import weights as W
from servebench.families import dense
from servebench.reference.moe import logits  # noqa: F401 — the reference


def draw(model: dict, seed: int, device) -> dict:
    gen = W.generator(seed, device)
    dt = W.DTYPES[model["dtype"]]
    w = W.stacker(gen, model, dt, device)
    d, f, e = model["d_model"], model["d_ff"], model["n_experts"]
    layers = dense.attention_layers(model, w, dt, device)
    layers["router"] = w(d, e, dtype=torch.float32, scale=0.02)
    layers["experts"] = {"w_gate": w(e, d, f), "w_up": w(e, d, f),
                         "w_down": w(e, f, d)}
    return {"embed": W.embedding(gen, model, dt, device), "layers": layers}


def tiny(model: dict) -> dict:
    """The dense cut, with 4 experts (``top_k`` kept)."""
    return dict(dense.tiny(model), n_experts=4)


def active_matmul_params(model: dict) -> int:
    """The dense count with the MLP's 3 d f replaced by the router's d e and
    the top-k experts' k 3 d f."""
    d, f = model["d_model"], model["d_ff"]
    attn = flops.attention_matmul_params(model)
    mlp = model["top_k"] * 3 * d * f + d * model["n_experts"]
    return model["n_layers"] * (attn + mlp) + d * model["vocab_size"]
