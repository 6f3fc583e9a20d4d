"""Dense decoder-only transformer params (llama family), in the reference's
LAYER-STACKED layout: every leaf under ``params["layers"]`` has a leading
n_layers axis, so a converted reference pytree and a fresh init share one
structure.
"""
from __future__ import annotations

import math

import torch

from repro_torch.models import layers as L


def _stacked(generator, n_layers, shape, dtype, device):
    """(n_layers, *shape) weight, N(0, 1/fan_in) per layer, drawn one layer
    at a time so the f32 draw never holds more than one layer."""
    out = torch.empty((n_layers, *shape), dtype=dtype, device=device)
    scale = 1.0 / math.sqrt(shape[0])
    for i in range(n_layers):
        out[i] = L.dense_init(generator, shape, scale, dtype, device=device)
    return out


def init_params(cfg, generator: torch.Generator, device="cuda", dtype=None):
    """Random dense-family params from ``generator`` (which must live on
    ``device``). Same init scales as the reference: 1/sqrt(fan_in) for
    projections, 0.02 for the token embedding, ones for norms."""
    if cfg.arch_type != "dense":
        raise NotImplementedError(
            f"the port initialises the dense family only, not "
            f"{cfg.arch_type!r}")
    dtype = dtype or L.torch_dtype(cfg.dtype)
    d, h, k, hd, f, n = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                         cfg.head_dim, cfg.d_ff, cfg.n_layers)

    def w(*shape):
        return _stacked(generator, n, shape, dtype, device)

    attn = {"wq": w(d, h * hd), "wk": w(d, k * hd), "wv": w(d, k * hd),
            "wo": w(h * hd, d)}
    if cfg.qkv_bias:
        for name, width in (("bq", h * hd), ("bk", k * hd), ("bv", k * hd)):
            attn[name] = torch.zeros((n, width), dtype=dtype, device=device)
    layers = {
        "attn": attn,
        "mlp": {"w_gate": w(d, f), "w_up": w(d, f), "w_down": w(f, d)},
        "norm_attn": torch.ones((n, d), dtype=dtype, device=device),
        "norm_mlp": torch.ones((n, d), dtype=dtype, device=device),
    }
    emb = L.init_embed(generator, cfg, dtype, device)
    return {"embed": emb, "layers": layers}


# --------------------------------------------------------------------------
# KV cache (model-level; the serving engine uses the paged pool)
# --------------------------------------------------------------------------

def kv_store_dtype(cfg) -> torch.dtype:
    """Dtype KV rows are stored in (int8 caches keep quantized payloads)."""
    return torch.int8 if cfg.kv_dtype == "int8" else L.torch_dtype(
        cfg.kv_dtype)


def init_cache(cfg, batch: int, capacity: int, dtype=None, device="cuda"):
    """Zeroed (L, batch, capacity, K, D) k/v; capacity = max sequence
    length (full attention) or the window (ring-buffer decode). An int8
    config adds (L, batch, capacity, K, 1) bf16 scales."""
    dtype = dtype or kv_store_dtype(cfg)
    shape = (cfg.n_layers, batch, capacity, cfg.n_kv_heads, cfg.head_dim)
    cache = {"k": torch.zeros(shape, dtype=dtype, device=device),
             "v": torch.zeros(shape, dtype=dtype, device=device)}
    if cfg.kv_dtype == "int8":
        sshape = shape[:-1] + (1,)
        for name in ("k_scale", "v_scale"):
            cache[name] = torch.zeros(sshape, dtype=torch.bfloat16,
                                      device=device)
    return cache


def _pad_seq(x, pad: int):
    """Zero rows appended to the sequence axis of (B, S, K, D)."""
    if pad == 0:
        return x
    return torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad))


def layer_params(layers, i: int):
    """Layer ``i``'s param dict: a view of the stacked leaves at index i."""
    return {key: layer_params(val, i) if isinstance(val, dict) else val[i]
            for key, val in layers.items()}
