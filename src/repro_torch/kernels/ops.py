"""Kernel dispatch: a tensor on the CPU takes the kernel's plain PyTorch
version (``kernels/ref.py``); any other tensor goes to the CUDA kernel,
which launches or raises — it never falls back to the plain version."""
from __future__ import annotations

import torch

from repro_torch.kernels import paged_attention as _pa
from repro_torch.kernels import paged_attention_int8 as _pa8
from repro_torch.kernels import ref
from repro_torch.kernels import ssd_scan as _ssd


def paged_attention(q, k_pages, v_pages, block_tables, lengths, starts=None):
    """Decode attention over a block-paged KV pool. ``starts`` (optional,
    (B,) int32) masks positions below a per-sequence window start — the
    sliding-window recycling path. See ``kernels/paged_attention.py``."""
    assert q.ndim == 3 and k_pages.ndim == 4
    assert q.shape[1] % k_pages.shape[0] == 0, "H must be a multiple of K"
    if q.device.type == "cpu":
        return ref.paged_attention_ref(q, k_pages, v_pages, block_tables,
                                       lengths, starts)
    return _pa.paged_attention(q, k_pages, v_pages, block_tables, lengths,
                               starts)


def paged_attention_int8(q, k_pages, k_scales, v_pages, v_scales,
                         block_tables, lengths, starts=None):
    """Decode attention over an int8-quantized block-paged KV pool
    (per-row symmetric bf16 scales, dequantized after the page load). Same
    ``starts`` semantics as ``paged_attention``. See
    ``kernels/paged_attention_int8.py``."""
    assert q.ndim == 3 and k_pages.ndim == 4
    assert k_pages.dtype == torch.int8 and v_pages.dtype == torch.int8
    assert q.shape[1] % k_pages.shape[0] == 0, "H must be a multiple of K"
    if q.device.type == "cpu":
        return ref.paged_attention_int8_ref(q, k_pages, k_scales, v_pages,
                                            v_scales, block_tables, lengths,
                                            starts)
    return _pa8.paged_attention_int8(q, k_pages, k_scales, v_pages, v_scales,
                                     block_tables, lengths, starts)


def ssd_scan(xdt, a, B, C, chunk: int = 64, h0=None):
    """Mamba-2 SSD chunked scan: xdt (b, s, h, p), a (b, s, h) log decays,
    B, C (b, s, n), optional h0 (b, h, p, n); ``s`` must be a multiple of
    ``chunk``. Returns (y (b, s, h, p) f32, h_final (b, h, p, n) f32). See
    ``kernels/ssd_scan.py``."""
    assert xdt.ndim == 4 and a.ndim == 3 and B.ndim == 3 and C.ndim == 3
    if chunk <= 0 or xdt.shape[1] % chunk:
        raise ValueError(f"seq {xdt.shape[1]} is not a multiple of chunk "
                         f"{chunk}")
    if xdt.device.type == "cpu":
        return ref.ssd_scan_ref(xdt, a, B, C, h0)
    return _ssd.ssd_scan(xdt, a, B, C, chunk=chunk, h0=h0)


def ssd_scan_backward(xdt, a, B, C, h0, gy, gh):
    """Gradients of ``ssd_scan`` for xdt, a, B, C and h0, given gy (the
    gradient of y) and gh (of the final state; None = 0). Returns (dxdt,
    da, dB, dC, dh0), each in its input's dtype, dh0 None when h0 is None.
    See ``kernels/ssd_scan.py``."""
    assert xdt.ndim == 4 and a.ndim == 3 and B.ndim == 3 and C.ndim == 3
    if xdt.device.type == "cpu":
        return ref.ssd_scan_backward_ref(xdt, a, B, C, h0, gy, gh)
    return _ssd.ssd_scan_backward(xdt, a, B, C, h0, gy, gh)
