"""Paged decode fast path (dense family): the serving engine's hot loop over
a block-paged KV pool (serving/kvcache.py), attending through the paged-
attention kernel (kernels/ops.py: the CUDA kernel on the card, its plain
version on the CPU).

Pool layout is the kernel's native layout with a leading stacked-layer
axis: k_pages / v_pages : (L, K, n_blocks, page, D). A Python loop over L
hands each layer's (K, P, page, D) view straight to the kernel.

Two entry points:

  * ``prefill_bucketed`` — run a prompt padded to a power-of-2 bucket.
    Causality makes the tail padding invisible to positions < true_len, so
    the last real token's logits and the first true_len KV rows are exact.
  * ``decode_step_paged`` — one continuous-batching decode step: write each
    request's new KV into its current page IN PLACE (the pool tensors are
    updated, not returned), attend over the paged pool, sample on device.
    The caller does the step's one host sync.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops
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


def init_pages(cfg, n_blocks: int, page_size: int, dtype=None, device="cpu"):
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
                      dst_off, positions, *, starts=None):
    """One attention layer of the paged decode hot loop: scatter this
    step's KV into the current page of ``kl``/``vl`` (in place — they are
    views of the pool), attend through the paged kernel, apply the MLP."""
    h = L.rms_norm(x, p["norm_attn"], cfg.norm_eps)
    q, k, v = L.qkv_proj(p["attn"], cfg, h, positions)    # (B,1,{H,K},D)
    kl[:, dst_block, dst_off] = k[:, 0].transpose(0, 1).to(kl.dtype)
    vl[:, dst_block, dst_off] = v[:, 0].transpose(0, 1).to(vl.dtype)
    o = ops.paged_attention(q[:, 0].contiguous(), kl, vl, block_tables,
                            lengths, starts)
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
                      temperature: float = 0.0):
    """One decode step for B slots over the paged pool.

    token: (B,) int32 — last sampled token per slot (garbage for idle
    slots); k_pages/v_pages: (L, K, P, page, D), UPDATED IN PLACE;
    block_tables: (B, table_pages) int32 (idle slots point every entry at a
    scratch block); pos: (B,) int32 absolute write position (RoPE uses it);
    base: optional (B,) int32 first-resident-page position.

    Each layer writes the new KV at (block_tables[b, (pos-base)//page],
    pos%page) and attends over [max(0, pos+1-window), pos]. Returns
    (next_token (B,) int32, logits (B, V) f32), both on the device.
    """
    if k_scales is not None:
        raise NotImplementedError("int8 KV pools are not ported yet")
    page = k_pages.shape[3]
    block_tables = block_tables.contiguous()
    dst_block, dst_off, lengths, starts = _window_addressing(
        cfg, page, block_tables, pos, base)
    positions = pos[:, None]
    x = L.embed(params["embed"], token[:, None])          # (B, 1, d)
    for i in range(cfg.n_layers):
        x = _paged_attn_layer(cfg, layer_params(params["layers"], i), x,
                              k_pages[i], v_pages[i], block_tables, lengths,
                              dst_block, dst_off, positions, starts=starts)
    return _sample_head(cfg, params, x, generator, temperature)
