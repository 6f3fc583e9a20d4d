"""Shared building blocks: RMSNorm, RoPE, GQA attention (chunked, online
softmax), SwiGLU. Plain functions on tensors; params are nested dicts.

Each function keeps the reference package's numerics where they decide the
result: f32 normalisation and RoPE, interleaved RoPE pairs, f32 score and
PV accumulation with -1e30 masking and a 1e-30 softmax floor. Attention is
written in plain ops (not a fused library attention) so that masking and
rounding follow the reference exactly.

On a mesh (the dry run lays params and inputs out as DTensors) each
function keeps its math and makes its layout explicit through the helpers
of ``distributed/layout.py``; attention, the cache update, the embedding
and the loss run on each device's local tensors, and ``_constrain_seq``
pins attention's K/V and scores to the sequence axis that ``shard_hints``
names. On plain tensors nothing changes.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.distributed import layout as ML
from repro_torch.distributed.layout import (
    contract_ready, grad_split_ready, is_dtensor, keep_grad_layout,
    local_value, mesh_placements, on_shards, partial_on_model,
    replicate_dim, split_ready, use_weight)
# the dry run's knobs, kept under this module as the reference keeps them
from repro_torch.distributed.layout import shard_hints  # noqa: F401

NEG_INF = -1e30

def torch_dtype(name: str) -> torch.dtype:
    """Config dtype string ("bfloat16", "float32") -> torch dtype."""
    return getattr(torch, name)


# --------------------------------------------------------------------------
# init helpers
# --------------------------------------------------------------------------

def dense_init(generator, shape, scale: Optional[float] = None,
               dtype=torch.bfloat16, *, device):
    """N(0, scale^2) drawn in f32 then cast; scale defaults to
    1/sqrt(fan_in) with fan_in = shape[0] (shape[1] for a layer-stacked
    (L, fan_in, fan_out) weight — pass ``scale`` explicitly there)."""
    fan_in = shape[0]
    scale = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    x = torch.randn(shape, generator=generator, dtype=torch.float32,
                    device=device)
    return (x * scale).to(dtype)


def init_embed(generator, cfg, dtype, device):
    """Token embedding (N(0, 0.02^2)), final norm (ones) and, unless tied,
    the unembedding (1/sqrt(d_model)) — the reference's scales."""
    d = cfg.d_model
    emb = {"tok": dense_init(generator, (cfg.vocab_size, d), 0.02, dtype,
                             device=device),
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


def row_matmul(x, w, rows: int = 0):
    """``x @ w`` in products of at most ``rows`` rows of ``x`` (all dims
    but the last are rows); ``rows=0`` is one product. cuBLAS picks its
    kernel, and with it the order of each dot product's sum, by the row
    count, so a row's bits depend on how many rows share the product:
    fixed-size blocks make them depend on the row alone. A prefill whose
    row count is a multiple of ``rows`` then gives every row the bits a
    chunked prefill of ``rows``-row chunks gives it. Operands of two
    dtypes compute in the wider one, as the reference's type promotion
    does (f32 frame embeddings through a bf16 encoder stay f32)."""
    x, w = contract_ready(x, w)
    if x.dtype != w.dtype:
        dt = torch.promote_types(x.dtype, w.dtype)
        x, w = x.to(dt), w.to(dt)
    n = x[..., 0].numel()
    if not rows or n <= rows:
        return keep_grad_layout(x @ w)
    flat = x.reshape(n, x.shape[-1])
    out = torch.cat([flat[i:i + rows] @ w for i in range(0, n, rows)])
    return out.reshape(*x.shape[:-1], w.shape[-1])


# --------------------------------------------------------------------------
# RoPE
# --------------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float, device):
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


def _constrain_seq(x, seq_dim: int):
    """Pin ``x``'s dim ``seq_dim`` to the hinted mesh axis (no-op when hints
    are off, on a plain tensor, or where the axis does not divide it)."""
    if ML.SEQ_SHARD_AXIS is None or not is_dtensor(x):
        return x
    from torch.distributed.tensor import Shard
    mesh = x.device_mesh
    names = mesh.mesh_dim_names or ()
    if ML.SEQ_SHARD_AXIS not in names:
        return x
    i = names.index(ML.SEQ_SHARD_AXIS)
    seq_dim %= x.ndim
    if x.placements[i].is_shard(seq_dim) or \
            x.shape[seq_dim] % (ML.shard_ways(x, seq_dim) * mesh.size(i)):
        return x
    pls = list(x.placements)
    pls[i] = Shard(seq_dim)
    return x.redistribute(mesh, pls)


def attention(q, k, v, *, causal: bool, window: int = 0,
              q_offset: int = 0, kv_len=None, q_chunk: int = 1024):
    """Chunked multi-head attention with online softmax.

    q: (B, Sq, H, D); k, v: (B, Skv, K, D) with K | H (GQA).
    causal: mask with absolute positions (q position = q_offset + index).
    window: if >0, query i attends only to kv positions > i - window (SWA).
    kv_len: optional (B,) tensor or int count of valid kv entries.
    Never materializes more than (B, H, q_chunk, Skv) scores at once.
    """
    kw = dict(causal=causal, window=window, q_offset=q_offset, q_chunk=q_chunk)
    if is_dtensor(q):
        return _mesh_attention(q, k, v, kv_len, **kw)
    return _attention(q, k, v, kv_len=kv_len, **kw)


def _mesh_attention(q, k, v, kv_len, **kw):
    """``attention`` on DTensors. Without a hint: the batch over the data
    axes and the heads over the model axis where it divides them, each
    shard's heads attended on its local tensors (heads are independent; K/V
    heads the axis does not divide are repeated to the query heads first).
    With ``shard_hints``: the query heads whole and K/V's sequence over the
    hinted axis, as DTensor ops (the softmax's max and sums reduce across
    it)."""
    if ML.SEQ_SHARD_AXIS is not None:
        return _attention(replicate_dim(q, 2), k, v, kv_len=kv_len, **kw)
    mesh = q.device_mesh
    b, h, kh = q.shape[0], q.shape[2], k.shape[2]
    names = mesh.mesh_dim_names
    m = mesh.size(names.index("model")) if "model" in names else 1
    if kh % m:
        k, v, kh = _expand_kv(k, h), _expand_kv(v, h), h
    heads = h if kh % m == 0 else 1
    pls = mesh_placements(mesh, 4, data=(0, b), model=(2, heads))
    klen = local_value(kv_len)
    if is_dtensor(kv_len) and kv_len.ndim:
        raise ValueError("per-row kv_len on a mesh is not supported")

    def local(q_, k_, v_):
        return _attention(q_, k_, v_, kv_len=klen, **kw)
    return on_shards(local, mesh, pls, (pls, pls, pls))(q, k, v)


def _attention(q, k, v, *, causal: bool, window: int, q_offset: int,
               kv_len, q_chunk: int):
    b, sq, h, d = q.shape
    skv = k.shape[1]
    kv_dtype = k.dtype
    k = _expand_kv(k, h)
    v = _expand_kv(v, h)
    scale = 1.0 / math.sqrt(d)
    k = _constrain_seq(k, 1)
    v = _constrain_seq(v, 1)
    # q is pre-scaled in f32 and cast back, then (as the reference's
    # einsum does) cast to the cache's dtype; the products accumulate in
    # f32 over operands in their storage dtype (exact upcasts)
    qt = (q.transpose(1, 2).float() * scale).to(q.dtype)   # (B,H,Sq,D)
    kt = k.transpose(1, 2).float()                          # (B,H,Skv,D)
    vt = v.transpose(1, 2)
    kv_pos = torch.arange(skv, dtype=torch.int32, device=q.device)

    def chunk_attn(q_c, q_pos):
        s = q_c.to(kv_dtype).float() @ kt.transpose(-1, -2)  # (B,H,c,Skv)
        s = _constrain_seq(s, 3)          # scores stay KV-seq-sharded
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
        # the shift takes no gradient (the reference's stop_gradient): the
        # normalised output does not depend on it
        m = s.amax(dim=-1, keepdim=True).detach()
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


def kv_cache_update(cache, new, slot):
    """Write ``new`` (B,1,K,D) at sequence position ``slot`` (an int or a
    0-d integer tensor) of ``cache`` (B,C,K,D) through a one-hot select,
    returning a new cache (the reference's form: elementwise, no indexed
    write)."""
    if is_dtensor(cache):
        return _mesh_cache_update(cache, new, slot)
    c = cache.shape[1]
    onehot = (torch.arange(c, device=cache.device) == slot)[None, :, None,
                                                            None]
    return torch.where(onehot, new.to(cache.dtype), cache)


def _mesh_cache_update(cache, new, slot):
    """``kv_cache_update`` on each device's local cache: ``new`` laid out
    as the cache is on every dim but the sequence (where it is one row),
    the one-hot over the device's own positions."""
    from torch.distributed.tensor import Replicate
    mesh = cache.device_mesh
    new_pl = [Replicate() if pl.is_shard(1) else pl for pl in cache.placements]
    ways = [mesh.size(i) for i, pl in enumerate(cache.placements)
            if pl.is_shard(1)]
    rows = cache.shape[1] // math.prod(ways)
    seq_axes = [i for i, pl in enumerate(cache.placements) if pl.is_shard(1)]
    pos = local_value(slot)

    def local(c, n):
        first = 0
        for i in seq_axes:       # this device's first position
            first = first * mesh.size(i) + mesh.get_local_rank(i)
        onehot = (torch.arange(rows, device=c.device) + first * rows
                  == pos)[None, :, None, None]
        return torch.where(onehot, n.to(c.dtype), c)

    return on_shards(local, mesh, list(cache.placements),
                     (list(cache.placements), new_pl))(cache, new)


# --------------------------------------------------------------------------
# attention block params + apply
# --------------------------------------------------------------------------

def qkv_proj(p, cfg, x, positions, rows: int = 0):
    """x: (B,S,d) -> q (B,S,H,D), k/v (B,S,K,D), with RoPE applied; the
    projections in products of ``rows`` rows (``row_matmul``)."""
    b, s, _ = x.shape
    h, k, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = row_matmul(x, p["wq"], rows)
    kk = row_matmul(x, p["wk"], rows)
    vv = row_matmul(x, p["wv"], rows)
    if cfg.qkv_bias:
        q, kk, vv = q + p["bq"], kk + p["bk"], vv + p["bv"]
    q = split_ready(q, -1, h).reshape(b, s, h, hd)
    kk = split_ready(kk, -1, k).reshape(b, s, k, hd)
    vv = split_ready(vv, -1, k).reshape(b, s, k, hd)
    q = apply_rope(q, positions, cfg.rope_theta)
    kk = apply_rope(kk, positions, cfg.rope_theta)
    return q, kk, vv


def attn_out(p, o, rows: int = 0):
    b, s, h, d = o.shape
    o = grad_split_ready(o.reshape(b, s, h * d), -1, h)
    return row_matmul(o, p["wo"], rows)


# --------------------------------------------------------------------------
# SwiGLU MLP
# --------------------------------------------------------------------------

def mlp(p, x, rows: int = 0):
    gate = F.silu(row_matmul(x, p["w_gate"], rows))
    return row_matmul(gate * row_matmul(x, p["w_up"], rows), p["w_down"],
                      rows)


# --------------------------------------------------------------------------
# embeddings / unembedding
# --------------------------------------------------------------------------

def embed(p, tokens):
    tab = use_weight(p["tok"])
    if is_dtensor(tab):
        return _mesh_embed(tab, tokens)
    return tab[tokens.long()]


def _mesh_embed(tab, tokens):
    """The lookup on each device's local tensors: its tokens (the batch over
    the batch axes where they divide it) from its copy of the table (whole
    rows; the model axis's split of the width kept). The table's gradient
    sums over the batch shards."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = tab.device_mesh
    tok_pl = mesh_placements(mesh, tokens.ndim, data=(0, tokens.shape[0]))
    tab_pl = [pl if pl.is_shard(1) else Replicate() for pl in tab.placements]
    out_pl = [Shard(tokens.ndim) if t.is_shard(1) else pl
              for pl, t in zip(tok_pl, tab_pl)]
    grad_pl = [Partial() if pl.is_shard(0) else t
               for pl, t in zip(tok_pl, tab_pl)]
    return on_shards(lambda t, ids: t[ids.long()], mesh, out_pl,
                     (tab_pl, tok_pl), (grad_pl, tok_pl))(tab, tokens)


def unembed(p, cfg, x):
    """Logits in x's dtype. The weights are cast to x's dtype per call (an
    f32 ``x`` against bf16 weights computes in f32, as the reference's type
    promotion does); no f32 copy of the weights is kept between calls."""
    w = p["tok"].T if cfg.tie_embeddings else p["unembed"]
    x, w = contract_ready(x, w)
    return keep_grad_layout(x @ w.to(x.dtype))


# --------------------------------------------------------------------------
# loss
# --------------------------------------------------------------------------

def token_nll(logits, targets):
    """Per-position negative log-likelihood of ``targets`` under
    ``logits``, the log-softmax in f32. On DTensors whose vocab dim is
    split over the model axis it is computed vocab-parallel: the max and
    the sum of exponentials reduce across the split, and each device picks
    the targets in its own slice of the vocab."""
    if is_dtensor(logits):
        return _mesh_token_nll(logits, targets)
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -torch.gather(logp, -1, targets.long()[..., None])[..., 0]


def _mesh_token_nll(logits, targets):
    mesh = logits.device_mesh
    names = mesh.mesh_dim_names
    lf = logits.float()
    vocab = lf.shape[-1]
    lead = lf.ndim - 1
    lg_pl = mesh_placements(mesh, lf.ndim, data=(0, lf.shape[0]),
                            model=(-1, vocab))
    row_pl = mesh_placements(mesh, lead, data=(0, lf.shape[0]))
    if "model" not in names or \
            not lg_pl[names.index("model")].is_shard(lf.ndim - 1):
        # the vocab whole on every device: each takes its rows' losses
        return on_shards(token_nll, mesh, row_pl, (lg_pl, row_pl),
                         (lg_pl, row_pl))(lf, targets)
    model = names.index("model")
    shift = lf.amax(dim=-1, keepdim=True).detach()
    sum_pl = partial_on_model(mesh, row_pl)
    shift_pl = mesh_placements(mesh, lf.ndim, data=(0, lf.shape[0]))
    width = vocab // mesh.size(model)

    def local(lg, sh, tg):
        lo = mesh.get_local_rank(model) * width
        sumexp = torch.exp(lg - sh).sum(dim=-1)
        idx = tg.long() - lo
        mine = (idx >= 0) & (idx < width)
        picked = torch.gather(lg, -1, idx.clamp(0, width - 1)[..., None])
        return sumexp, torch.where(mine, picked[..., 0], 0.0)

    sumexp, picked = on_shards(
        local, mesh, (sum_pl, sum_pl), (lg_pl, shift_pl, row_pl),
        (lg_pl, shift_pl, row_pl))(lf, shift, targets)
    return torch.log(sumexp) + shift[..., 0] - picked
