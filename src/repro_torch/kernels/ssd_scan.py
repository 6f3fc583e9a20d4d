"""Hopper kernel: the Mamba-2 SSD chunked scan.

The CUDA source is ``csrc/ssd_scan.cu`` (its header comment gives the design
and the bound); ``kernels/build.py`` compiles it with ``nvcc`` for
``sm_90a`` at first use into ``build/kernels/libssd_scan-<hash>.so`` and
loads it with ctypes.

The kernel reads ``xdt`` and ``a`` in f32 and ``B`` / ``C`` in f32 or bf16
(both kinds reach it: bf16 from a bf16 model, f32 from the tests), widening
them to f32 itself; ``B`` and ``C`` are read through their strides, so the
model's slices of the conv output are not copied.

``launches`` counts kernel launches made through ``ssd_scan``; a run sets it
to 0 and reads it back to show that a path went through the kernel.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import KernelLibrary

_BC_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0


def _bind(lib):
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.ssd_scan_launch.argtypes = [ptr] * 7 + [i32] * 5 + [i64] * 9 + \
        [i32, ptr]
    lib.ssd_scan_launch.restype = i32
    lib.ssd_scan_smem_bytes.argtypes = [i32, i32]
    lib.ssd_scan_smem_bytes.restype = i64
    lib.ssd_scan_max_smem_bytes.argtypes = []
    lib.ssd_scan_max_smem_bytes.restype = i64


LIB = KernelLibrary("ssd_scan", _bind)
build = LIB.build         # compile the library if this source is not built yet
_library = LIB.load       # built and bound once; later calls return it


def __getattr__(attr):
    # build_seconds: wall time of this process's nvcc run (None: not run)
    if attr == "build_seconds":
        return LIB.build_seconds
    raise AttributeError(f"module {__name__!r} has no attribute {attr!r}")


def _check(xdt, a, B, C, h0, chunk):
    if xdt.ndim != 4 or a.ndim != 3 or B.ndim != 3 or C.ndim != 3:
        raise ValueError("ssd_scan takes xdt (b,s,h,p), a (b,s,h), "
                         "B and C (b,s,n)")
    b, s, h, p = xdt.shape
    n = B.shape[-1]
    if xdt.dtype != torch.float32 or a.dtype != torch.float32:
        raise TypeError(f"xdt and a must be float32, not {xdt.dtype} / "
                        f"{a.dtype}")
    if B.dtype not in _BC_DTYPES or C.dtype != B.dtype:
        raise TypeError(f"B and C must share float32 or bfloat16, not "
                        f"{B.dtype} / {C.dtype}")
    if a.shape != (b, s, h) or B.shape != (b, s, n) or C.shape != B.shape:
        raise ValueError(f"shape mismatch: xdt {tuple(xdt.shape)}, a "
                         f"{tuple(a.shape)}, B {tuple(B.shape)}, C "
                         f"{tuple(C.shape)}")
    if h0 is not None and (h0.dtype != torch.float32
                           or h0.shape != (b, h, p, n)):
        raise ValueError(f"h0 must be float32 {(b, h, p, n)}, not "
                         f"{h0.dtype} {tuple(h0.shape)}")
    if s == 0 or chunk <= 0 or s % chunk:
        raise ValueError(f"seq {s} is not a positive multiple of chunk "
                         f"{chunk}")
    tensors = [xdt, a, B, C] + ([h0] if h0 is not None else [])
    if any(t.device.type != "cuda" or t.device != xdt.device
           for t in tensors):
        raise ValueError("ssd_scan's CUDA kernel needs every tensor on one "
                         "CUDA device")


def ssd_scan(xdt, a, B, C, chunk: int = 64, h0=None):
    """xdt: (b, s, h, p) f32 inputs pre-multiplied by dt; a: (b, s, h) f32
    log decays; B, C: (b, s, n) f32 or bf16; h0: optional (b, h, p, n) f32
    initial state (None = 0); ``s`` a multiple of ``chunk`` (the reference
    wrapper's contract; the kernel itself steps over sub-chunks of 32).
    Returns (y (b, s, h, p) f32, h_final (b, h, p, n) f32). Launches the
    CUDA kernel on the current stream; raises on any input the kernel does
    not take and when the launch fails."""
    global launches
    _check(xdt, a, B, C, h0, chunk)
    lib = _library()
    xdt, a = xdt.contiguous(), a.contiguous()
    B = B if B.stride(-1) == 1 else B.contiguous()
    C = C if C.stride(-1) == 1 else C.contiguous()
    h0 = h0.contiguous() if h0 is not None else None
    b, s, h, p = xdt.shape
    n = B.shape[-1]
    smem = lib.ssd_scan_smem_bytes(p, n)
    if smem > lib.ssd_scan_max_smem_bytes():
        raise ValueError(f"head dim {p} x state dim {n} needs {smem} B of "
                         "shared memory, more than a block may hold")
    y = torch.empty((b, s, h, p), dtype=torch.float32, device=xdt.device)
    hf = torch.empty((b, h, p, n), dtype=torch.float32, device=xdt.device)
    rc = lib.ssd_scan_launch(
        xdt.data_ptr(), a.data_ptr(), B.data_ptr(), C.data_ptr(),
        h0.data_ptr() if h0 is not None else None, y.data_ptr(),
        hf.data_ptr(), b, s, h, p, n, xdt.stride(0), xdt.stride(1),
        xdt.stride(2), a.stride(0), a.stride(1), B.stride(0), B.stride(1),
        C.stride(0), C.stride(1), _BC_DTYPES[B.dtype],
        torch.cuda.current_stream(xdt.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"ssd_scan launch failed: CUDA error {rc}")
    launches += 1
    return y, hf
