"""Kernel dispatch: a tensor on the CPU takes the kernel's plain PyTorch
version (``kernels/ref.py``); any other tensor goes to the CUDA kernel,
which launches or raises — it never falls back to the plain version."""
from __future__ import annotations

from repro_torch.kernels import paged_attention as _pa
from repro_torch.kernels import ref


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
