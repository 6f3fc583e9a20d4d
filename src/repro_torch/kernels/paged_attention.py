"""Hopper kernel: decode attention over a block-paged KV pool.

The CUDA source is ``csrc/paged_attention.cu`` (its header comment gives the
design and the bound) with ``csrc/paged_attention_common.cuh`` (the split
layout and the merge pass it shares with the int8 kernel);
``kernels/build.py`` compiles it with ``nvcc`` for ``sm_90a`` at first use
into ``build/kernels/libpaged_attention-<hash>.so`` and loads it with ctypes.
One call launches the split pass and, when a sequence has more than one
split, the merge pass; the wrapper allocates their f32 partials with
``torch.empty`` (the kernel allocates nothing, so the call can be captured
in a CUDA graph).

``launches`` counts the CUDA kernels launched through ``paged_attention``:
each call adds what its C entry reports, 1 for the split pass and 1 more
for the merge pass (launched whenever the table is wide enough for a
sequence to have two splits). A run sets it to 0 and reads it back to show
that a path went through the kernel.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import KernelLibrary

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0


def _bind(lib):
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.paged_attention_launch.argtypes = [ptr] * 8 + [i32] * 8 + [ptr]
    lib.paged_attention_launch.restype = i32
    lib.paged_attention_shape_ok.argtypes = [i32, i32]
    lib.paged_attention_shape_ok.restype = i32
    lib.paged_attention_scratch_floats.argtypes = [i32] * 4
    lib.paged_attention_scratch_floats.restype = ctypes.c_longlong


LIB = KernelLibrary("paged_attention", _bind)
build = LIB.build         # compile the library if this source is not built yet
_library = LIB.load       # built and bound once; later calls return it


def __getattr__(attr):
    # build_seconds: wall time of this process's nvcc run (None: not run)
    if attr == "build_seconds":
        return LIB.build_seconds
    raise AttributeError(f"module {__name__!r} has no attribute {attr!r}")


def _check(q, k_pages, v_pages, block_tables, lengths, starts):
    b, h, d = q.shape
    kheads, _, page, dk = k_pages.shape
    if q.dtype not in _DTYPES:
        raise TypeError(f"paged_attention takes float32 or bfloat16, "
                        f"not {q.dtype}")
    if k_pages.dtype != q.dtype or v_pages.dtype != q.dtype:
        raise TypeError("q, k_pages and v_pages must share one dtype")
    if v_pages.shape != k_pages.shape or dk != d or h % kheads:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, pages "
                         f"{tuple(k_pages.shape)} / {tuple(v_pages.shape)}")
    if d * q.element_size() % 16:
        raise ValueError(f"head_dim {d} is not a whole number of 16-byte "
                         "vectors")
    ints = [block_tables, lengths] + ([starts] if starts is not None else [])
    if any(t.dtype != torch.int32 for t in ints):
        raise TypeError("block_tables, lengths and starts must be int32")
    if block_tables.shape[0] != b or lengths.shape != (b,) or \
            (starts is not None and starts.shape != (b,)):
        raise ValueError("block_tables, lengths and starts need one row per "
                         "sequence")
    tensors = [q, k_pages, v_pages] + ints
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("paged_attention needs contiguous tensors")
    return tensors


def paged_attention(q, k_pages, v_pages, block_tables, lengths, starts=None):
    """q: (B, H, D); k_pages/v_pages: (K, P, page, D); block_tables:
    (B, pages_per_seq) int32; lengths: (B,) int32; starts: optional (B,)
    int32 window lower bound (None = 0). Returns (B, H, D) in q's dtype.
    Launches the CUDA kernel on the current stream; raises on any input the
    kernel does not take and when the launch fails."""
    global launches
    tensors = _check(q, k_pages, v_pages, block_tables, lengths, starts)
    lib = _library()
    if any(t.device.type != "cuda" or t.device != q.device for t in tensors):
        raise ValueError("paged_attention's CUDA kernel needs every tensor "
                         "on one CUDA device")
    if k_pages.data_ptr() % 16 or v_pages.data_ptr() % 16:
        raise ValueError("K/V pools must be 16-byte aligned")
    b, h, d = q.shape
    kheads, n_phys, page, _ = k_pages.shape
    width = block_tables.shape[1]
    if not lib.paged_attention_shape_ok(d, page):
        raise ValueError(f"head_dim {d} not taken: the kernel takes 64, 128 "
                         "or 256")
    out = torch.empty_like(q)
    part = torch.empty(lib.paged_attention_scratch_floats(b, h, d, width),
                       dtype=torch.float32, device=q.device)
    rc = lib.paged_attention_launch(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        block_tables.data_ptr(), lengths.data_ptr(),
        starts.data_ptr() if starts is not None else None, out.data_ptr(),
        part.data_ptr(), b, h, kheads, n_phys, page, d, width,
        _DTYPES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream)
    if rc < 0:
        raise RuntimeError(f"paged_attention launch failed: CUDA error {-rc}")
    launches += rc
    return out
