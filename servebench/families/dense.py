"""Llama-style dense decoders (``models/transformer.py`` in the port): on
every layer grouped-query attention and a SwiGLU MLP. ``flops.py``'s own
formulas are this family's, so it overrides none of them."""
from __future__ import annotations

import torch

from servebench import weights as W
from servebench.reference.dense import logits  # noqa: F401 — the reference


def attention_layers(model: dict, w, dtype, device) -> dict:
    """Each layer's attention projections and its two norms, from ``w``
    (``weights.stacker``)."""
    n, d, h, k = (model["n_layers"], model["d_model"], model["n_heads"],
                  model["n_kv_heads"])
    hd = model["head_dim"]
    return {
        "attn": {"wq": w(d, h * hd), "wk": w(d, k * hd), "wv": w(d, k * hd),
                 "wo": w(h * hd, d)},
        "norm_attn": torch.ones((n, d), dtype=dtype, device=device),
        "norm_mlp": torch.ones((n, d), dtype=dtype, device=device),
    }


def draw(model: dict, seed: int, device) -> dict:
    gen = W.generator(seed, device)
    dt = W.DTYPES[model["dtype"]]
    w = W.stacker(gen, model, dt, device)
    d, f = model["d_model"], model["d_ff"]
    layers = attention_layers(model, w, dt, device)
    layers["mlp"] = {"w_gate": w(d, f), "w_up": w(d, f), "w_down": w(f, d)}
    return {"embed": W.embedding(gen, model, dt, device), "layers": layers}


def tiny(model: dict) -> dict:
    """Two layers of width 128 (4 heads of 32; 2 KV heads where the model
    groups its queries, else 4), MLP 256, vocabulary 512, page 8."""
    return dict(model, n_layers=2, d_model=128, n_heads=4, head_dim=32,
                d_ff=256, vocab_size=512, page_size=8,
                n_kv_heads=2 if model["n_kv_heads"] < model["n_heads"] else 4)
