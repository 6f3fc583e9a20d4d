"""Hopper kernel: decode attention over an int8-quantized block-paged KV pool
(per-token, per-kv-head symmetric scales), and the quantization it reads.

The CUDA source is ``csrc/paged_attention_int8.cu`` (its header comment
gives the design and the bound) with ``csrc/paged_attention_common.cuh``;
``kernels/build.py`` compiles it with ``nvcc`` for ``sm_90a`` at first use
into ``build/kernels/libpaged_attention_int8-<hash>.so`` and loads it with
ctypes. As in ``paged_attention``, one call launches the split and merge
passes, over f32 partials the wrapper allocates.

``quantize_pages`` / ``dequantize_pages`` are plain PyTorch: the reference
computes them outside its kernel too, and the pool, the decode step and the
kernel's plain version all use these two functions, so quantize -> serve ->
replicate -> promote round-trips bit for bit.

``launches`` counts the CUDA kernels launched through
``paged_attention_int8``: each call adds what its C entry reports, 1 for the
split pass and 1 more for the merge pass. A run sets it to 0 and reads it
back to show that a path went through the kernel.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import KernelLibrary

# per-row scale carrier: the pool stores scales in this dtype and the kernel
# and its plain version dequantize with exactly these bytes
SCALE_DTYPE = torch.bfloat16
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0


def quantize_pages(pages):
    """(..., D) float -> (int8 values, scales (..., 1) SCALE_DTYPE).

    Per-row symmetric quantization over the last axis. An all-zero row gets
    scale 1, so it round-trips to exact zeros; values are divided by the
    bf16-rounded scale the pool stores, so dequantizing with the stored
    scale is the inverse the kernel sees. ``torch.round`` rounds half to
    even, as ``jnp.round`` does."""
    x = pages.float()
    amax = x.abs().amax(dim=-1, keepdim=True)
    scales = torch.where(amax > 0, amax / 127.0,
                         torch.ones_like(amax)).to(SCALE_DTYPE)
    q = torch.clamp(torch.round(x / scales.float()), -127, 127)
    return q.to(torch.int8), scales


def dequantize_pages(q, scales):
    """Inverse of ``quantize_pages``: (..., D) int8 * (..., 1) scale -> f32."""
    return q.float() * scales.float()


def _bind(lib):
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.paged_attention_int8_launch.argtypes = [ptr] * 10 + [i32] * 8 + [ptr]
    lib.paged_attention_int8_launch.restype = i32
    lib.paged_attention_int8_shape_ok.argtypes = [i32, i32]
    lib.paged_attention_int8_shape_ok.restype = i32
    lib.paged_attention_int8_scratch_floats.argtypes = [i32] * 4
    lib.paged_attention_int8_scratch_floats.restype = ctypes.c_longlong


LIB = KernelLibrary("paged_attention_int8", _bind)
build = LIB.build         # compile the library if this source is not built yet
_library = LIB.load       # built and bound once; later calls return it


def __getattr__(attr):
    # build_seconds: wall time of this process's nvcc run (None: not run)
    if attr == "build_seconds":
        return LIB.build_seconds
    raise AttributeError(f"module {__name__!r} has no attribute {attr!r}")


def _check(q, k_pages, k_scales, v_pages, v_scales, block_tables, lengths,
           starts):
    b, h, d = q.shape
    kheads, _, page, dk = k_pages.shape
    if q.dtype not in _DTYPES:
        raise TypeError(f"paged_attention_int8 takes a float32 or bfloat16 "
                        f"q, not {q.dtype}")
    if k_pages.dtype != torch.int8 or v_pages.dtype != torch.int8:
        raise TypeError("k_pages and v_pages must be int8")
    if k_scales.dtype != SCALE_DTYPE or v_scales.dtype != SCALE_DTYPE:
        raise TypeError(f"k_scales and v_scales must be {SCALE_DTYPE}")
    scale_shape = k_pages.shape[:-1] + (1,)
    if v_pages.shape != k_pages.shape or dk != d or h % kheads or \
            k_scales.shape != scale_shape or v_scales.shape != scale_shape:
        raise ValueError(
            f"shape mismatch: q {tuple(q.shape)}, pages "
            f"{tuple(k_pages.shape)} / {tuple(v_pages.shape)}, scales "
            f"{tuple(k_scales.shape)} / {tuple(v_scales.shape)}")
    if d % 16:
        raise ValueError(f"head_dim {d} is not a whole number of 16-byte "
                         "int8 vectors")
    ints = [block_tables, lengths] + ([starts] if starts is not None else [])
    if any(t.dtype != torch.int32 for t in ints):
        raise TypeError("block_tables, lengths and starts must be int32")
    if block_tables.shape[0] != b or lengths.shape != (b,) or \
            (starts is not None and starts.shape != (b,)):
        raise ValueError("block_tables, lengths and starts need one row per "
                         "sequence")
    tensors = [q, k_pages, k_scales, v_pages, v_scales] + ints
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("paged_attention_int8 needs contiguous tensors")
    return tensors


def paged_attention_int8(q, k_pages, k_scales, v_pages, v_scales,
                         block_tables, lengths, starts=None):
    """q: (B, H, D) float32 or bfloat16; k_pages/v_pages: (K, P, page, D)
    int8; k_scales/v_scales: (K, P, page, 1) bfloat16; block_tables:
    (B, pages_per_seq) int32; lengths: (B,) int32; starts: optional (B,)
    int32 window lower bound (None = 0). Returns (B, H, D) in q's dtype.
    Launches the CUDA kernel on the current stream; raises on any input the
    kernel does not take and when the launch fails."""
    global launches
    tensors = _check(q, k_pages, k_scales, v_pages, v_scales, block_tables,
                     lengths, starts)
    lib = _library()
    if any(t.device.type != "cuda" or t.device != q.device for t in tensors):
        raise ValueError("paged_attention_int8's CUDA kernel needs every "
                         "tensor on one CUDA device")
    if any(t.data_ptr() % 16 for t in (k_pages, v_pages, k_scales,
                                       v_scales)):
        raise ValueError("int8 K/V pools and their scales must be 16-byte "
                         "aligned")
    b, h, d = q.shape
    kheads, n_phys, page, _ = k_pages.shape
    width = block_tables.shape[1]
    if not lib.paged_attention_int8_shape_ok(d, page):
        raise ValueError(f"head_dim {d} or page size {page} not taken: the "
                         "kernel takes head_dim 64, 128 or 256 and a page "
                         "that is a multiple of 8")
    out = torch.empty_like(q)
    part = torch.empty(
        lib.paged_attention_int8_scratch_floats(b, h, d, width),
        dtype=torch.float32, device=q.device)
    rc = lib.paged_attention_int8_launch(
        q.data_ptr(), k_pages.data_ptr(), k_scales.data_ptr(),
        v_pages.data_ptr(), v_scales.data_ptr(), block_tables.data_ptr(),
        lengths.data_ptr(),
        starts.data_ptr() if starts is not None else None, out.data_ptr(),
        part.data_ptr(), b, h, kheads, n_phys, page, d, width,
        _DTYPES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream)
    if rc < 0:
        raise RuntimeError(f"paged_attention_int8 launch failed: CUDA error "
                           f"{-rc}")
    launches += rc
    return out
