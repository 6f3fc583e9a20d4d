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
    # f32, or f64 kept (a float64 gradient check runs this in f64)
    dt = torch.float64 if xdt.dtype == torch.float64 else torch.float32
    state = torch.zeros((b, h, p, n), dtype=dt,
                        device=xdt.device) if h0 is None else h0.to(dt)
    ys = []
    for t in range(s):
        xt = xdt[:, t].to(dt)                               # (b,h,p)
        at = torch.exp(a[:, t].to(dt))                      # (b,h)
        Bt = B[:, t].to(dt)                                 # (b,n)
        Ct = C[:, t].to(dt)
        state = state * at[..., None, None] + \
            xt[..., None] * Bt[:, None, None, :]
        ys.append(torch.einsum("bhpn,bn->bhp", state, Ct))
    return torch.stack(ys, dim=1), state


SSD_SUB_CHUNK = 32      # positions per sub-chunk of the backward kernel


def ssd_scan_backward_ref(xdt, a, B, C, h0, gy, gh=None):
    """Backward of the SSD scan over sub-chunks of ``SSD_SUB_CHUNK``
    positions, as the kernels (``csrc/ssd_scan_bwd.cu``) cut it, in torch
    ops (no autograd): a state pass keeps the state entering each
    sub-chunk, then a reverse walk carries dS, the gradient into the state
    leaving the sub-chunk. (The kernels' own order of work — dB and dC as
    products over the heads, gy . y without a per-head dC — is written out
    in ``tests/test_torch_ssd_scan_bwd_tiles.py``.) Per sub-chunk, with cum the cumulative log decay inside it,
    L[i, j] = exp(cum_i - cum_j) (j <= i) and e = exp(total - cum):

      G = (C B^T) o L,   M = (gy x^T) o L
      dx  = diag(e) B dS^T + G^T gy         dB = sum_h diag(e) x dS + M^T C
      dC  = sum_h diag(exp(cum)) gy S_in + M B
      dcum = gy . y - x . dx  (+ <S_out, dS> at the last position), and da
      its reverse cumulative sum in the sub-chunk; gy . y = C . dC_h
      dS  <- exp(total) dS + (diag(exp(cum)) gy)^T C   (dh0 after the first)

    xdt: (b, s, h, p); a: (b, s, h); B, C: (b, s, n); h0: (b, h, p, n) or
    None (0); gy: (b, s, h, p) and gh: (b, h, p, n) or None (0), the
    gradients of y and of the final state. Computes in f32 (f64 kept) and
    returns (dxdt, da, dB, dC, dh0), each in its input's dtype (dh0 None
    when h0 is None)."""
    b, s, h, p = xdt.shape
    n = B.shape[-1]
    dt = torch.float64 if xdt.dtype == torch.float64 else torch.float32
    q = SSD_SUB_CHUNK
    pad = -s % q
    c = (s + pad) // q

    def chunks(t, *tail):           # zero-padded, (c, b, q, *tail) in dt
        t = t.to(dt)
        if pad:
            t = torch.cat([t, t.new_zeros((b, pad, *tail))], 1)
        return t.reshape(b, c, q, *tail).transpose(0, 1)

    x, ac, Bc, Cc, gyc = (chunks(xdt, h, p), chunks(a, h), chunks(B, n),
                          chunks(C, n), chunks(gy, h, p))
    cum = torch.cumsum(ac, 2)                               # (c, b, q, h)
    total = cum[:, :, -1]                                   # (c, b, h)
    e = torch.exp(total[:, :, None] - cum)
    ecum = torch.exp(cum)
    tri = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))

    # state pass: the state entering every sub-chunk
    state = (torch.zeros((b, h, p, n), dtype=dt, device=x.device)
             if h0 is None else h0.to(dt))
    s_in = []
    for ci in range(c):
        s_in.append(state)
        state = state * torch.exp(total[ci])[..., None, None] + torch.einsum(
            "bjhp,bjh,bjn->bhpn", x[ci], e[ci], Bc[ci])

    # reverse walk
    dS = (torch.zeros_like(state) if gh is None else gh.to(dt))
    bdot = (state * dS).sum((-2, -1))                       # (b, h)
    dx, da, dB, dC = [], [], [], []
    for ci in reversed(range(c)):
        diff = cum[ci].transpose(1, 2)[..., :, None] - \
            cum[ci].transpose(1, 2)[..., None, :]           # (b, h, i, j)
        L = torch.where(tri, torch.exp(torch.where(tri, diff, 0)), 0)
        G = torch.einsum("bin,bjn->bij", Cc[ci], Bc[ci])[:, None] * L
        M = torch.einsum("bihp,bjhp->bhij", gyc[ci], x[ci]) * L
        dxc = e[ci][..., None] * torch.einsum("btn,bhpn->bthp", Bc[ci], dS) \
            + torch.einsum("bhit,bihp->bthp", G, gyc[ci])
        dBh = e[ci][..., None] * torch.einsum("bthp,bhpn->bthn", x[ci], dS) \
            + torch.einsum("bhit,bin->bthn", M, Cc[ci])
        dCh = ecum[ci][..., None] * torch.einsum("bihp,bhpn->bihn", gyc[ci],
                                                 s_in[ci]) \
            + torch.einsum("bhij,bjn->bihn", M, Bc[ci])
        dcum = torch.einsum("bin,bihn->bih", Cc[ci], dCh) - \
            (x[ci] * dxc).sum(-1)                            # (b, q, h)
        dcum[:, -1] += bdot
        da.append(torch.flip(torch.cumsum(torch.flip(dcum, [1]), 1), [1]))
        dx.append(dxc)
        dB.append(dBh.sum(2))
        dC.append(dCh.sum(2))
        dS = torch.exp(total[ci])[..., None, None] * dS + torch.einsum(
            "bihp,bih,bin->bhpn", gyc[ci], ecum[ci], Cc[ci])
        bdot = (s_in[ci] * dS).sum((-2, -1))

    def joined(parts, like):        # sub-chunks in order, padding cut
        out = torch.stack(parts[::-1], 1)
        return out.reshape(b, c * q, *out.shape[3:])[:, :s].to(like.dtype)

    return (joined(dx, xdt), joined(da, a), joined(dB, B), joined(dC, C),
            None if h0 is None else dS.to(h0.dtype))


# --------------------------------------------------------------------------
# routed MLP (csrc/moe_mlp.cu): the down kernel's exact split of h
# --------------------------------------------------------------------------

def moe_split3(h):
    """f32 ``h`` as three bf16 tensors with hi + mid + lo == h exactly (for
    |h| >= 2^-110 and 0): each part the top 16 bits of what the parts before
    it left, as the down kernel splits its A operand."""
    mask = -65536                                   # 0xffff0000 as int32

    def top(v):
        return (v.view(torch.int32) & mask).view(torch.float32)

    hi = top(h)
    r = h - hi
    mid = top(r)
    return hi.bfloat16(), mid.bfloat16(), (r - mid).bfloat16()
