"""Shared building blocks: RMSNorm, RoPE, GQA attention (chunked, online
softmax), SwiGLU. Plain functions on tensors; params are nested dicts.

Each function keeps the reference package's numerics where they decide the
result: f32 normalisation and RoPE, interleaved RoPE pairs, f32 score and
PV accumulation with -1e30 masking and a 1e-30 softmax floor. Attention is
written in plain ops (not a fused library attention) so that masking and
rounding follow the reference exactly.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

NEG_INF = -1e30


def torch_dtype(name: str) -> torch.dtype:
    """Config dtype string ("bfloat16", "float32") -> torch dtype."""
    return getattr(torch, name)


# --------------------------------------------------------------------------
# init helpers
# --------------------------------------------------------------------------

def dense_init(generator, shape, scale: Optional[float] = None,
               dtype=torch.bfloat16, device="cpu"):
    """N(0, scale^2) drawn in f32 then cast; scale defaults to
    1/sqrt(fan_in) with fan_in = shape[0] (shape[1] for a layer-stacked
    (L, fan_in, fan_out) weight — pass ``scale`` explicitly there)."""
    fan_in = shape[0]
    scale = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    x = torch.randn(shape, generator=generator, dtype=torch.float32,
                    device=device)
    return (x * scale).to(dtype)


def init_embed(generator, cfg, dtype=torch.bfloat16, device="cpu"):
    """Token embedding (N(0, 0.02^2)), final norm (ones) and, unless tied,
    the unembedding (1/sqrt(d_model)) — the reference's scales."""
    d = cfg.d_model
    emb = {"tok": dense_init(generator, (cfg.vocab_size, d), 0.02, dtype,
                             device),
           "norm_f": torch.ones((d,), dtype=dtype, device=device)}
    if not cfg.tie_embeddings:
        emb["unembed"] = dense_init(generator, (d, cfg.vocab_size),
                                    dtype=dtype, device=device)
    return emb


def kv_cache_dtype(cfg) -> torch.dtype:
    """Unquantized KV-cache carrier dtype: cfg.kv_dtype, except int8
    configs keep bf16 payloads on paths that carry no quantization scales."""
    return torch.bfloat16 if cfg.kv_dtype == "int8" \
        else torch_dtype(cfg.kv_dtype)


def rms_norm(x, weight, eps: float = 1e-5):
    dt = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * weight.float()).to(dt)


# --------------------------------------------------------------------------
# RoPE
# --------------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float, device="cpu"):
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    # a Python-scalar base: no host->device copy (which would synchronise
    # the stream) on every decode layer
    return 1.0 / torch.pow(float(theta), exps)


def apply_rope(x, positions, theta: float):
    """x: (..., S, H, D); positions: (..., S) int. Rotates INTERLEAVED pairs
    (x[..., ::2], x[..., 1::2]) — the reference layout, not the half-split
    one."""
    d = x.shape[-1]
    inv = rope_frequencies(d, theta, x.device)             # (D/2,)
    ang = positions[..., None].float() * inv                # (..., S, D/2)
    sin, cos = torch.sin(ang)[..., None, :], torch.cos(ang)[..., None, :]
    x1, x2 = x[..., ::2].float(), x[..., 1::2].float()
    out = torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.reshape(x.shape).to(x.dtype)


# --------------------------------------------------------------------------
# attention
# --------------------------------------------------------------------------

def _expand_kv(k, q_heads: int):
    """(B,S,K,D) -> (B,S,H,D) by repeating each kv head q_per_kv times."""
    kh = k.shape[2]
    if kh == q_heads:
        return k
    return k.repeat_interleave(q_heads // kh, dim=2)


def attention(q, k, v, *, causal: bool, window: int = 0,
              q_offset: int = 0, kv_len=None, q_chunk: int = 1024):
    """Chunked multi-head attention with online softmax.

    q: (B, Sq, H, D); k, v: (B, Skv, K, D) with K | H (GQA).
    causal: mask with absolute positions (q position = q_offset + index).
    window: if >0, query i attends only to kv positions > i - window (SWA).
    kv_len: optional (B,) tensor or int count of valid kv entries.
    Never materializes more than (B, H, q_chunk, Skv) scores at once.
    """
    b, sq, h, d = q.shape
    skv = k.shape[1]
    k = _expand_kv(k, h)
    v = _expand_kv(v, h)
    scale = 1.0 / math.sqrt(d)
    # q is pre-scaled in f32 and cast back; the products then accumulate in
    # f32 over operands in their storage dtype (exact upcasts)
    qt = (q.transpose(1, 2).float() * scale).to(q.dtype)   # (B,H,Sq,D)
    kt = k.transpose(1, 2).float()                          # (B,H,Skv,D)
    vt = v.transpose(1, 2)
    kv_pos = torch.arange(skv, dtype=torch.int32, device=q.device)

    def chunk_attn(q_c, q_pos):
        s = q_c.float() @ kt.transpose(-1, -2)              # (B,H,c,Skv)
        mask = torch.ones((q_pos.shape[0], skv), dtype=torch.bool,
                          device=q.device)
        if causal:
            mask &= kv_pos[None, :] <= q_pos[:, None]
        if window:
            mask &= kv_pos[None, :] > q_pos[:, None] - window
        if kv_len is not None:
            klen = torch.as_tensor(kv_len, device=q.device)
            if klen.ndim == 0:
                mask = mask & (kv_pos[None, :] < klen)
                mask = mask[None, None]
            else:
                mask = (mask[None] & (kv_pos[None, None, :]
                                      < klen[:, None, None]))[:, None]
        else:
            mask = mask[None, None]
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
        m = s.amax(dim=-1, keepdim=True)
        p = torch.exp(s - m)
        o = p.to(vt.dtype).float() @ vt.float()
        return o / (p.sum(dim=-1, keepdim=True) + 1e-30)

    outs = []
    for c0 in range(0, sq, q_chunk):
        c1 = min(c0 + q_chunk, sq)
        q_pos = q_offset + torch.arange(c0, c1, dtype=torch.int32,
                                        device=q.device)
        outs.append(chunk_attn(qt[:, :, c0:c1], q_pos))
    out = torch.cat(outs, dim=2) if len(outs) > 1 else outs[0]
    return out.transpose(1, 2).to(q.dtype)                  # (B,Sq,H,D)


# --------------------------------------------------------------------------
# attention block params + apply
# --------------------------------------------------------------------------

def qkv_proj(p, cfg, x, positions):
    """x: (B,S,d) -> q (B,S,H,D), k/v (B,S,K,D), with RoPE applied."""
    b, s, _ = x.shape
    h, k, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = x @ p["wq"]
    kk = x @ p["wk"]
    vv = x @ p["wv"]
    if cfg.qkv_bias:
        q, kk, vv = q + p["bq"], kk + p["bk"], vv + p["bv"]
    q = q.reshape(b, s, h, hd)
    kk = kk.reshape(b, s, k, hd)
    vv = vv.reshape(b, s, k, hd)
    q = apply_rope(q, positions, cfg.rope_theta)
    kk = apply_rope(kk, positions, cfg.rope_theta)
    return q, kk, vv


def attn_out(p, o):
    b, s, h, d = o.shape
    return o.reshape(b, s, h * d) @ p["wo"]


# --------------------------------------------------------------------------
# SwiGLU MLP
# --------------------------------------------------------------------------

def mlp(p, x):
    return (F.silu(x @ p["w_gate"]) * (x @ p["w_up"])) @ p["w_down"]


# --------------------------------------------------------------------------
# embeddings / unembedding
# --------------------------------------------------------------------------

def embed(p, tokens):
    return p["tok"][tokens.long()]


def unembed(p, cfg, x):
    """Logits in x's dtype. The weights are cast to x's dtype per call (an
    f32 ``x`` against bf16 weights computes in f32, as the reference's type
    promotion does); no f32 copy of the weights is kept between calls."""
    w = p["tok"].T if cfg.tie_embeddings else p["unembed"]
    return x @ w.to(x.dtype)
