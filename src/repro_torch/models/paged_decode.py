"""Paged decode fast path (dense family): the serving engine's hot loop over
a block-paged KV pool (serving/kvcache.py), attending through the paged-
attention kernel (kernels/ops.py: the CUDA kernel on the card, its plain
version on the CPU).

Pool layout is the kernel's native layout with a leading stacked-layer
axis: k_pages / v_pages : (L, K, n_blocks, page, D). A Python loop over L
hands each layer's (K, P, page, D) view straight to the kernel.

Entry points:

  * ``prefill_bucketed`` — run a prompt padded to a power-of-2 bucket.
    Causality makes the tail padding invisible to positions < true_len, so
    the last real token's logits and the first true_len KV rows are exact.
  * ``prefill_chunk`` — one chunk of a chunked prefill over KV carry
    buffers from ``init_chunk_buffers`` (updated IN PLACE); the chunks
    together give the rows and logits ``prefill_bucketed`` gives.
  * ``decode_step_paged`` — one continuous-batching decode step: write each
    request's new KV into its current page IN PLACE (the pool tensors are
    updated, not returned), attend over the paged pool, sample on device.
    On an int8 pool (``k_scales``/``v_scales`` given) the new rows are
    quantized and attention runs through the int8 kernel. The caller does
    the step's one host sync.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops
from repro_torch.kernels.paged_attention_int8 import quantize_pages
from repro_torch.models import layers as L
from repro_torch.models.transformer import layer_params
from repro_torch.serving.sampling import sample

# families the port's paged serving path covers so far
PAGED_FAMILIES = ("dense",)


def kv_layer_indices(cfg):
    """Model layer indices that carry paged KV: every layer (dense)."""
    return tuple(range(cfg.n_layers))


def next_bucket(n: int, lo: int = 8) -> int:
    """Smallest power of two >= max(n, lo)."""
    b = lo
    while b < n:
        b *= 2
    return b


def table_pages(cfg, max_seq: int) -> int:
    """Block-table width (pages per slot) for serving ``max_seq``: the whole
    sequence, or only the resident ring ceil(window/page) + 1 on a windowed
    arch (pages out of the window are recycled)."""
    full = -(-max_seq // cfg.page_size)
    if not cfg.sliding_window:
        return full
    return min(full, -(-cfg.sliding_window // cfg.page_size) + 1)


def kv_dtype(cfg) -> torch.dtype:
    """Paged-pool storage dtype (see layers.kv_cache_dtype)."""
    return L.kv_cache_dtype(cfg)


def init_pages(cfg, n_blocks: int, page_size: int, dtype=None,
               device="cuda"):
    """Zeroed paged pool buffers in kernel layout (L, K, P, page, D)."""
    dtype = dtype or kv_dtype(cfg)
    shape = (cfg.n_layers, cfg.n_kv_heads, n_blocks, page_size, cfg.head_dim)
    return (torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device))


# --------------------------------------------------------------------------
# prefill (bucketed)
# --------------------------------------------------------------------------

def prefill_bucketed(cfg, params, tokens, true_len: int, *,
                     q_chunk: int = 1024):
    """Prompt forward over bucket-padded tokens.

    tokens: (1, S_bucket) int32, positions [true_len, S_bucket) are padding.
    Returns (logits (1, V) f32 at position true_len-1, k, v (L, S_bucket, K,
    D) in the pool dtype). Rows >= true_len of k/v are garbage and must be
    masked/overwritten by the caller.
    """
    x = L.embed(params["embed"], tokens)
    b, s, _ = x.shape
    positions = torch.arange(s, dtype=torch.int32,
                             device=x.device)[None, :].expand(b, s)
    q_chunk = min(q_chunk, s)
    ks, vs = [], []
    for i in range(cfg.n_layers):
        p = layer_params(params["layers"], i)
        h = L.rms_norm(x, p["norm_attn"], cfg.norm_eps)
        q, k, v = L.qkv_proj(p["attn"], cfg, h, positions)
        o = L.attention(q, k, v, causal=True, window=cfg.sliding_window,
                        q_chunk=q_chunk)
        x = x + L.attn_out(p["attn"], o)
        h = L.rms_norm(x, p["norm_mlp"], cfg.norm_eps)
        x = x + L.mlp(p["mlp"], h)
        ks.append(k[0].to(kv_dtype(cfg)))
        vs.append(v[0].to(kv_dtype(cfg)))
    x = L.rms_norm(x, params["embed"]["norm_f"], cfg.norm_eps)
    xt = x[:, true_len - 1:true_len]                       # (1,1,d)
    # f32 logits (greedy tie determinism)
    logits = L.unembed(params["embed"], cfg, xt.float())
    return logits[:, 0], torch.stack(ks), torch.stack(vs)


def init_chunk_buffers(cfg, bucket: int, device="cuda"):
    """Zeroed full-precision KV carry buffers for a chunked prefill:
    (L, S_bucket, K, D) in the ACTIVATION dtype — later chunks attend over
    earlier chunks' keys at the precision the monolithic prefill sees. Cast
    to the pool's KV dtype only at page-write time."""
    shape = (len(kv_layer_indices(cfg)), bucket, cfg.n_kv_heads,
             cfg.head_dim)
    dt = L.torch_dtype(cfg.dtype)
    return (torch.zeros(shape, dtype=dt, device=device),
            torch.zeros(shape, dtype=dt, device=device))


def prefill_chunk(cfg, params, tokens, start: int, take: int, k_buf, v_buf,
                  *, q_chunk: int = 1024):
    """One chunk of a chunked prefill.

    tokens: (1, C) int32 — prompt rows at absolute positions
    [start, start + C); rows past the true prompt end are padding. start:
    absolute position of the chunk's first row (a multiple of C: the engine
    makes C a power of two, so chunks tile the bucket). take: rows of this
    chunk that are real prompt (C except on the final chunk). k_buf/v_buf:
    (L, S_bucket, K, D) carry from ``init_chunk_buffers``, UPDATED IN PLACE.

    Each layer writes its buffer rows [start, start + C), then attends the
    C query rows against the WHOLE buffer with ``q_offset=start``: masked
    (future) entries contribute exact zeros. Returns (logits (1, V) f32 at
    absolute position start + take - 1, k_buf, v_buf).
    """
    x = L.embed(params["embed"], tokens)
    c = x.shape[1]
    positions = (start + torch.arange(c, dtype=torch.int32,
                                      device=x.device))[None, :]
    q_chunk = min(q_chunk, c)
    for i in range(cfg.n_layers):
        p = layer_params(params["layers"], i)
        h = L.rms_norm(x, p["norm_attn"], cfg.norm_eps)
        q, k, v = L.qkv_proj(p["attn"], cfg, h, positions)
        k_buf[i, start:start + c] = k[0]
        v_buf[i, start:start + c] = v[0]
        o = L.attention(q, k_buf[i][None], v_buf[i][None], causal=True,
                        window=cfg.sliding_window, q_offset=start,
                        q_chunk=q_chunk)
        x = x + L.attn_out(p["attn"], o)
        h = L.rms_norm(x, p["norm_mlp"], cfg.norm_eps)
        x = x + L.mlp(p["mlp"], h)
    x = L.rms_norm(x, params["embed"]["norm_f"], cfg.norm_eps)
    xt = x[:, take - 1:take]
    logits = L.unembed(params["embed"], cfg, xt.float())
    return logits[:, 0], k_buf, v_buf


def pack_pages(k_seq, v_seq, n_pages: int, page: int):
    """(L, S, K, D) prefill KV -> (L, K, n_pages, page, D) pool blocks.
    S must cover n_pages*page (bucket padding guarantees it)."""
    l, s, kh, d = k_seq.shape
    span = n_pages * page

    def to_blocks(x):
        x = x[:, :span].reshape(l, n_pages, page, kh, d)
        return x.permute(0, 3, 1, 2, 4)                # (L, K, n_pages, page, D)

    return to_blocks(k_seq), to_blocks(v_seq)


# --------------------------------------------------------------------------
# decode (paged)
# --------------------------------------------------------------------------

def _paged_attn_layer(cfg, p, x, kl, vl, block_tables, lengths, dst_block,
                      dst_off, positions, *, starts=None, kl_scale=None,
                      vl_scale=None):
    """One attention layer of the paged decode hot loop: scatter this
    step's KV into the current page of ``kl``/``vl`` (in place — they are
    views of the pool), attend through the paged kernel, apply the MLP.
    With ``kl_scale``/``vl_scale`` the pool is int8: the new rows are
    quantized (per-token scales) before the scatter, and attention runs
    through the int8 kernel."""
    h = L.rms_norm(x, p["norm_attn"], cfg.norm_eps)
    q, k, v = L.qkv_proj(p["attn"], cfg, h, positions)    # (B,1,{H,K},D)
    k_rows = k[:, 0].transpose(0, 1)                       # (K, B, D)
    v_rows = v[:, 0].transpose(0, 1)
    q0 = q[:, 0].contiguous()
    if kl_scale is not None:
        for pool, scale, rows in ((kl, kl_scale, k_rows),
                                  (vl, vl_scale, v_rows)):
            qr, sr = quantize_pages(rows)
            pool[:, dst_block, dst_off] = qr
            scale[:, dst_block, dst_off] = sr
        o = ops.paged_attention_int8(q0, kl, kl_scale, vl, vl_scale,
                                     block_tables, lengths, starts)
    else:
        kl[:, dst_block, dst_off] = k_rows.to(kl.dtype)
        vl[:, dst_block, dst_off] = v_rows.to(vl.dtype)
        o = ops.paged_attention(q0, kl, vl, block_tables, lengths, starts)
    x = x + L.attn_out(p["attn"], o[:, None].to(x.dtype))
    h = L.rms_norm(x, p["norm_mlp"], cfg.norm_eps)
    return x + L.mlp(p["mlp"], h)


def _sample_head(cfg, params, x, generator, temperature):
    """Final norm -> f32 logits -> on-device sample (shared decode tail)."""
    x = L.rms_norm(x, params["embed"]["norm_f"], cfg.norm_eps)
    logits = L.unembed(params["embed"], cfg, x.float())[:, 0]    # (B, V)
    nxt = sample(logits, generator=generator, temperature=temperature)
    return nxt, logits


def _window_addressing(cfg, page: int, block_tables, pos, base):
    """Where this step's KV lands and what the kernel may attend to, in
    WINDOW-RELATIVE coordinates. ``base`` (B,) is the absolute position of
    each slot's first resident page (None = zeros). Returns (dst_block,
    dst_off, lengths, starts); ``starts`` is None on unwindowed archs."""
    rows = torch.arange(pos.shape[0], device=pos.device)
    if base is None:
        base = torch.zeros_like(pos)
    rel = pos - base
    dst_block = block_tables[rows, torch.div(rel, page,
                                             rounding_mode="floor").long()]
    dst_off = rel % page
    lengths = (rel + 1).to(torch.int32)
    starts = None
    if cfg.sliding_window:
        starts = torch.clamp(
            torch.clamp(pos + 1 - cfg.sliding_window, min=0) - base,
            min=0).to(torch.int32)
    return dst_block.long(), dst_off.long(), lengths, starts


def decode_step_paged(cfg, params, token, k_pages, v_pages, block_tables,
                      pos, generator=None, *, base=None, k_scales=None,
                      v_scales=None, temperature: float = 0.0):
    """One decode step for B slots over the paged pool.

    token: (B,) int32 — last sampled token per slot (garbage for idle
    slots); k_pages/v_pages: (L, K, P, page, D), UPDATED IN PLACE;
    block_tables: (B, table_pages) int32 (idle slots point every entry at a
    scratch block); pos: (B,) int32 absolute write position (RoPE uses it);
    base: optional (B,) int32 first-resident-page position. An int8 pool
    passes int8 ``k_pages``/``v_pages`` with their (L, K, P, page, 1) bf16
    ``k_scales``/``v_scales``, also UPDATED IN PLACE.

    Each layer writes the new KV at (block_tables[b, (pos-base)//page],
    pos%page) and attends over [max(0, pos+1-window), pos]. Returns
    (next_token (B,) int32, logits (B, V) f32), both on the device.
    """
    page = k_pages.shape[3]
    block_tables = block_tables.contiguous()
    dst_block, dst_off, lengths, starts = _window_addressing(
        cfg, page, block_tables, pos, base)
    positions = pos[:, None]
    x = L.embed(params["embed"], token[:, None])          # (B, 1, d)
    for i in range(cfg.n_layers):
        x = _paged_attn_layer(cfg, layer_params(params["layers"], i), x,
                              k_pages[i], v_pages[i], block_tables, lengths,
                              dst_block, dst_off, positions, starts=starts,
                              kl_scale=None if k_scales is None
                              else k_scales[i],
                              vl_scale=None if v_scales is None
                              else v_scales[i])
    return _sample_head(cfg, params, x, generator, temperature)
