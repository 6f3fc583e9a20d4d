"""Dense decoder-only transformer (llama/qwen/yi/deepseek families), also the
backbone of the VLM (patch-embedding inputs) and of the audio encoder
(bidirectional, no cache), in the reference's LAYER-STACKED layout: every
leaf under ``params["layers"]`` has a leading n_layers axis, so a converted
reference pytree and a fresh init share one structure. The model-level
forward, prefill and decode loop over the layers' views of that stack (the
reference scans over it); the serving engine runs the paged path
(``models/paged_decode.py``).
"""
from __future__ import annotations

import math
from typing import Optional

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
    """Random dense-family params (the VLM's and the audio encoder's too)
    from ``generator`` (which must live on ``device``). Same init scales as the reference: 1/sqrt(fan_in) for
    projections, 0.02 for the token embedding, ones for norms."""
    if cfg.arch_type not in ("dense", "vlm", "audio"):
        raise ValueError(f"the transformer stack backs the dense, vlm and "
                         f"audio families, not {cfg.arch_type!r}")
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


def unstacked(layers) -> list:
    """Every layer's param dict, as views made by one ``unbind`` per stacked
    leaf (the train path's forward). Under autograd an unbind's backward
    stacks the layers' gradients once, where one ``layer_params`` view per
    layer would each write a zero-filled gradient of the whole stack and
    then sum them: O(L^2) bytes."""
    parts = {key: unstacked(val) if isinstance(val, dict) else val.unbind(0)
             for key, val in layers.items()}
    n = len(next(iter(parts.values())))
    return [{key: part[i] for key, part in parts.items()} for i in range(n)]


# --------------------------------------------------------------------------
# forward (train / prefill)
# --------------------------------------------------------------------------

def _positions(b: int, s: int, device):
    return torch.arange(s, dtype=torch.int32, device=device)[None].expand(
        b, s)


def _block(cfg, p, x, positions, *, causal, window, q_chunk):
    h = L.rms_norm(x, p["norm_attn"], cfg.norm_eps)
    q, k, v = L.qkv_proj(p["attn"], cfg, h, positions)
    o = L.attention(q, k, v, causal=causal, window=window, q_chunk=q_chunk)
    x = x + L.attn_out(p["attn"], o)
    h = L.rms_norm(x, p["norm_mlp"], cfg.norm_eps)
    return x + L.mlp(p["mlp"], h)


def forward(cfg, params, tokens=None, inputs_embeds=None, *,
            window_override: Optional[int] = None, q_chunk: int = 1024):
    """Full-sequence forward -> logits (B, S, V) in the activation dtype.

    ``tokens``: (B, S) integers, or ``inputs_embeds``: (B, S, d) for the
    VLM / audio frontends (both: their sum). Causal unless
    ``cfg.is_encoder_only``."""
    if inputs_embeds is not None:
        x = inputs_embeds
        if tokens is not None:
            x = x + L.embed(params["embed"], tokens)
    else:
        x = L.embed(params["embed"], tokens)
    b, s, _ = x.shape
    positions = _positions(b, s, x.device)
    causal = not cfg.is_encoder_only
    window = window_override if window_override is not None \
        else cfg.sliding_window
    q_chunk = min(q_chunk, s)
    for p in unstacked(params["layers"]):
        x = _block(cfg, p, x, positions, causal=causal, window=window,
                   q_chunk=q_chunk)
    x = L.rms_norm(x, params["embed"]["norm_f"], cfg.norm_eps)
    return L.unembed(params["embed"], cfg, x)


# --------------------------------------------------------------------------
# int8 cache rows
# --------------------------------------------------------------------------

def _quantize(x):
    """Per-(token, head) symmetric int8: (q int8, scale bf16 (..., 1))."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    scale = (amax / 127.0 + 1e-8).to(torch.bfloat16)
    q = torch.clamp(torch.round(xf / scale.float()), -127, 127)
    return q.to(torch.int8), scale


def _dequantize(q, scale):
    return q.to(torch.bfloat16) * scale


# --------------------------------------------------------------------------
# prefill / decode (dense model-level cache)
# --------------------------------------------------------------------------

def prefill(cfg, params, tokens=None, inputs_embeds=None, *,
            capacity: Optional[int] = None,
            window_override: Optional[int] = None, q_chunk: int = 1024):
    """Run the prompt; returns (last-position logits (B, V) f32, the cache
    of the last ``capacity`` positions, zero-padded, and pos = S). An int8
    config stores quantized rows with their bf16 scales."""
    if inputs_embeds is not None:
        x = inputs_embeds
    else:
        x = L.embed(params["embed"], tokens)
    b, s, _ = x.shape
    capacity = capacity or s
    positions = _positions(b, s, x.device)
    window = window_override if window_override is not None \
        else cfg.sliding_window
    q_chunk = min(q_chunk, s)
    quant = cfg.kv_dtype == "int8"
    keep = min(capacity, s)
    pad = capacity - keep
    entries = []
    for i in range(cfg.n_layers):
        p = layer_params(params["layers"], i)
        h = L.rms_norm(x, p["norm_attn"], cfg.norm_eps)
        q, k, v = L.qkv_proj(p["attn"], cfg, h, positions)
        o = L.attention(q, k, v, causal=True, window=window, q_chunk=q_chunk)
        x = x + L.attn_out(p["attn"], o)
        h = L.rms_norm(x, p["norm_mlp"], cfg.norm_eps)
        x = x + L.mlp(p["mlp"], h)
        # keep the most recent `capacity` positions in the cache
        k_keep, v_keep = k[:, s - keep:], v[:, s - keep:]
        if quant:
            kq, ks = _quantize(k_keep)
            vq, vs = _quantize(v_keep)
            entries.append({"k": _pad_seq(kq, pad), "v": _pad_seq(vq, pad),
                            "k_scale": _pad_seq(ks, pad),
                            "v_scale": _pad_seq(vs, pad)})
        else:
            kdt = kv_store_dtype(cfg)
            entries.append({"k": _pad_seq(k_keep.to(kdt), pad),
                            "v": _pad_seq(v_keep.to(kdt), pad)})
    x = L.rms_norm(x, params["embed"]["norm_f"], cfg.norm_eps)
    # f32 logits: bf16 buckets vocab entries together, which makes greedy
    # argmax tie-break on noise
    logits = L.unembed(params["embed"], cfg, x[:, -1:].float())
    cache = {name: torch.stack([e[name] for e in entries])
             for name in entries[0]}
    return logits[:, 0], cache, s


def decode_step_ragged(cfg, params, token, cache, pos):
    """Decode with PER-REQUEST positions. token: (B,) integers; pos: (B,)
    integer tensor — each row writes its KV at its own position and
    attends to its own valid prefix. Full (non-ring) cache; the cache
    passed in is not modified. Returns (logits (B, V) f32, new cache)."""
    x = L.embed(params["embed"], token[:, None])
    b = x.shape[0]
    rows = torch.arange(b, device=x.device)
    pos = pos.to(device=x.device, dtype=torch.long)
    positions = pos[:, None]
    kv_len = pos + 1
    new = {"k": [], "v": []}
    for i in range(cfg.n_layers):
        p = layer_params(params["layers"], i)
        h = L.rms_norm(x, p["norm_attn"], cfg.norm_eps)
        q, k, v = L.qkv_proj(p["attn"], cfg, h, positions)
        ck = cache["k"][i].index_put((rows, pos),
                                     k[:, 0].to(cache["k"].dtype))
        cv = cache["v"][i].index_put((rows, pos),
                                     v[:, 0].to(cache["v"].dtype))
        o = L.attention(q, ck, cv, causal=False, kv_len=kv_len)
        x = x + L.attn_out(p["attn"], o)
        h = L.rms_norm(x, p["norm_mlp"], cfg.norm_eps)
        x = x + L.mlp(p["mlp"], h)
        new["k"].append(ck)
        new["v"].append(cv)
    x = L.rms_norm(x, params["embed"]["norm_f"], cfg.norm_eps)
    logits = L.unembed(params["embed"], cfg, x.float())
    return logits[:, 0], {name: torch.stack(t) for name, t in new.items()}


def decode_step(cfg, params, token, cache, pos, *, window: int = 0):
    """One decode step for a batch at one position ``pos`` (an int or a
    0-d tensor). token: (B,) integers; cache: dict of (L, B, C, K, D) (and
    the int8 scales). With ``window`` > 0 the cache is a ring buffer of its
    capacity. Returns (logits (B, V) f32, new cache); the cache passed in
    is not modified."""
    x = L.embed(params["embed"], token[:, None])
    b = x.shape[0]
    cap = cache["k"].shape[2]
    pos = torch.as_tensor(pos, dtype=torch.int32, device=x.device)
    slot = pos % cap if window else pos
    kv_len = torch.clamp(pos + 1, max=cap)
    positions = pos.expand(b, 1)
    quant = cfg.kv_dtype == "int8"
    names = ("k", "v", "k_scale", "v_scale") if quant else ("k", "v")
    new = {name: [] for name in names}
    for i in range(cfg.n_layers):
        p = layer_params(params["layers"], i)
        h = L.rms_norm(x, p["norm_attn"], cfg.norm_eps)
        q, k, v = L.qkv_proj(p["attn"], cfg, h, positions)
        if quant:
            kq, ks = _quantize(k)
            vq, vs = _quantize(v)
            c = {name: L.kv_cache_update(cache[name][i], val, slot)
                 for name, val in (("k", kq), ("v", vq), ("k_scale", ks),
                                   ("v_scale", vs))}
            k_full = _dequantize(c["k"], c["k_scale"])
            v_full = _dequantize(c["v"], c["v_scale"])
        else:
            c = {"k": L.kv_cache_update(cache["k"][i], k, slot),
                 "v": L.kv_cache_update(cache["v"][i], v, slot)}
            k_full, v_full = c["k"], c["v"]
        # a ring holds exactly the attend-to set: no causal mask beyond the
        # valid-length mask
        o = L.attention(q, k_full, v_full, causal=False, kv_len=kv_len)
        x = x + L.attn_out(p["attn"], o)
        h = L.rms_norm(x, p["norm_mlp"], cfg.norm_eps)
        x = x + L.mlp(p["mlp"], h)
        for name in names:
            new[name].append(c[name])
    x = L.rms_norm(x, params["embed"]["norm_f"], cfg.norm_eps)
    logits = L.unembed(params["embed"], cfg, x.float())
    return logits[:, 0], {name: torch.stack(t) for name, t in new.items()}
