"""Plain PyTorch versions of the port's kernels: the allclose targets that
the CPU tests use and that ``chip_smoke.py`` holds each CUDA kernel against.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.paged_attention_int8 import dequantize_pages


def paged_attention_ref(q, k_pages, v_pages, block_tables, lengths,
                        starts=None):
    """Decode attention over a block-paged KV pool.

    q:            (B, H, D)            one query token per sequence
    k_pages/v_pages: (K, P, page, D)   pool: kv-head major, P physical pages
    block_tables: (B, pages_per_seq) int32 physical page per logical page
    lengths:      (B,) int32           valid tokens per sequence
    starts:       optional (B,) int32  window start per sequence — positions
                  < starts[b] are masked out (at least one position must stay
                  valid, i.e. starts[b] < lengths[b])
    Returns (B, H, D) in q's dtype.
    """
    b, h, d = q.shape
    kheads, _, page, _ = k_pages.shape
    pages_per_seq = block_tables.shape[1]
    rep = h // kheads
    bt = block_tables.long()
    pos = torch.arange(pages_per_seq * page, device=q.device)
    out = []
    for i in range(b):
        # gather this sequence's KV (K, pages*page, D)
        ki = k_pages[:, bt[i]].reshape(kheads, pages_per_seq * page, d)
        vi = v_pages[:, bt[i]].reshape(kheads, pages_per_seq * page, d)
        kq = ki.repeat_interleave(rep, dim=0).float()       # (H, S, D)
        vq = vi.repeat_interleave(rep, dim=0).float()
        s = torch.einsum("hd,hsd->hs", q[i].float(), kq) / math.sqrt(d)
        mask = pos < lengths[i]
        if starts is not None:
            mask &= pos >= starts[i]
        s = torch.where(mask[None], s, torch.full_like(s, -1e30))
        p = torch.softmax(s, dim=-1)
        out.append(torch.einsum("hs,hsd->hd", p, vq))
    return torch.stack(out).to(q.dtype)


def paged_attention_int8_ref(q, k_pages, k_scales, v_pages, v_scales,
                             block_tables, lengths, starts=None):
    """Decode attention over an int8 block-paged KV pool: dequantize
    (``k * scale`` in f32), run ``paged_attention_ref`` in f32, cast to
    q's dtype. k/v_pages: (K, P, page, D) int8; k/v_scales: (K, P, page, 1)
    bfloat16; the other arguments as ``paged_attention_ref``."""
    k = dequantize_pages(k_pages, k_scales)
    v = dequantize_pages(v_pages, v_scales)
    return paged_attention_ref(q.float(), k, v, block_tables, lengths,
                               starts).to(q.dtype)


def ssd_scan_ref(xdt, a, B, C, h0=None):
    """Mamba-2 SSD scan as the plain sequential recurrence, one position at
    a time (independent of the chunked form), in f32:

      state_t = state_{t-1} * exp(a_t) + x_t B_t^T,   y_t = state_t C_t

    xdt: (b, s, h, p) inputs pre-multiplied by dt; a: (b, s, h) log decays;
    B, C: (b, s, n); h0: optional (b, h, p, n) initial state (None = 0).
    Returns (y (b, s, h, p) f32, h_final (b, h, p, n) f32).
    """
    b, s, h, p = xdt.shape
    n = B.shape[-1]
    state = torch.zeros((b, h, p, n), dtype=torch.float32,
                        device=xdt.device) if h0 is None else h0.float()
    ys = []
    for t in range(s):
        xt = xdt[:, t].float()                              # (b,h,p)
        at = torch.exp(a[:, t].float())                     # (b,h)
        Bt = B[:, t].float()                                # (b,n)
        Ct = C[:, t].float()
        state = state * at[..., None, None] + \
            xt[..., None] * Bt[:, None, None, :]
        ys.append(torch.einsum("bhpn,bn->bhp", state, Ct))
    return torch.stack(ys, dim=1), state
