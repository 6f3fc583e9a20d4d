"""Hopper kernel: the Mamba-2 SSD chunked scan.

The CUDA source is ``csrc/ssd_scan.cu`` (its header comment gives the design
and the bound); ``kernels/build.py`` compiles it with ``nvcc`` for
``sm_90a`` at first use into ``build/kernels/libssd_scan-<hash>.so`` and
loads it with ctypes.

The kernel reads ``xdt`` and ``a`` in f32 and ``B`` / ``C`` in f32 or bf16
(both kinds reach it: bf16 from a bf16 model, f32 from the tests), widening
them to f32 itself; ``B`` and ``C`` are read through their strides, so the
model's slices of the conv output are not copied. The kernels move 16-byte
pieces only: the wrapper pads P to a multiple of 4 and N to a multiple of 8
with zeros (which change neither y nor the live state) and copies an operand
whose base or row stride is not a 16-byte multiple. N is at most 256: the
state lives in registers, 16 rows by N columns per block of 4 warps.

One call launches two kernels: the C Bᵀ pass, once per (batch, sub-chunk)
into an f32 scratch that the wrapper allocates with ``torch.empty``, then
the scan, one block per (P tile, head, batch). Nothing is allocated by the
kernels and nothing waits on the host, so the call can be captured in a
CUDA graph.

``launches`` counts the CUDA kernels launched through ``ssd_scan``
(``KERNELS_PER_CALL`` per call); a run sets it to 0 and reads it back to
show that a path went through the kernels.

The gradient is a second library, ``csrc/ssd_scan_bwd.cu`` (its header
comment gives the design and the bound), built the same way into
``build/kernels/libssd_scan_bwd-<hash>.so``: ``ssd_scan_backward`` launches
its three kernels (a C Bᵀ pass per (batch, sub-chunk); a state pass and
reverse walk per (P tile, head, batch) that keeps each sub-chunk's entering
state and leaving gradient; dB and dC as products over the heads per
(batch, sub-chunk), one cluster of head-group blocks each, with da), takes
what the forward takes, and counts them in ``backward_launches``
(``KERNELS_PER_BACKWARD`` per call).
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels.build import KernelLibrary

_BC_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_STATE = 256           # largest state dim N (csrc: kMaxN)

launches = 0
KERNELS_PER_CALL = 2      # the C Bᵀ pass and the scan
backward_launches = 0
KERNELS_PER_BACKWARD = 3  # the C Bᵀ pass, the walk, dB / dC / da


def _bind(lib):
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.ssd_scan_launch.argtypes = [ptr] * 8 + [i32] * 5 + [i64] * 9 + \
        [i32, ptr]
    lib.ssd_scan_launch.restype = i32
    lib.ssd_scan_scratch_floats.argtypes = [i32, i32]
    lib.ssd_scan_scratch_floats.restype = i64
    lib.ssd_scan_smem_bytes.argtypes = [i32, i32]
    lib.ssd_scan_smem_bytes.restype = i64
    lib.ssd_scan_blocks_per_sm.argtypes = [i32, i32]
    lib.ssd_scan_blocks_per_sm.restype = i32
    for fn in ("ssd_scan_sub_chunk", "ssd_scan_p_tile", "ssd_scan_cb_split"):
        getattr(lib, fn).argtypes = []
        getattr(lib, fn).restype = i32


def _bind_bwd(lib):
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.ssd_scan_bwd_launch.argtypes = [ptr] * 13 + [i32] * 5 + [i64] * 4 + \
        [i32, ptr]
    lib.ssd_scan_bwd_launch.restype = i32
    lib.ssd_scan_bwd_scratch_floats.argtypes = [i32] * 5
    lib.ssd_scan_bwd_scratch_floats.restype = i64
    lib.ssd_scan_bwd_smem_bytes.argtypes = [i32, i32, i32]
    lib.ssd_scan_bwd_smem_bytes.restype = i64
    lib.ssd_scan_bwd_blocks_per_sm.argtypes = [i32, i32, i32]
    lib.ssd_scan_bwd_blocks_per_sm.restype = i32
    for fn in ("ssd_scan_bwd_sub_chunk", "ssd_scan_bwd_p_tile",
               "ssd_scan_bwd_cb_split"):
        getattr(lib, fn).argtypes = []
        getattr(lib, fn).restype = i32
    lib.ssd_scan_bwd_head_groups.argtypes = [i32] * 5
    lib.ssd_scan_bwd_head_groups.restype = i32


LIB = KernelLibrary("ssd_scan", _bind)
LIB_BWD = KernelLibrary("ssd_scan_bwd", _bind_bwd)
build = LIB.build         # compile the library if this source is not built yet
_library = LIB.load       # built and bound once; later calls return it
_library_bwd = LIB_BWD.load


def __getattr__(attr):
    # build_seconds: wall time of this process's nvcc run (None: not run)
    if attr == "build_seconds":
        return LIB.build_seconds
    raise AttributeError(f"module {__name__!r} has no attribute {attr!r}")


def _check(xdt, a, B, C, h0, chunk=None, more=()):
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
    if n > MAX_STATE:
        raise ValueError(f"state dim {n} is over {MAX_STATE}, the most the "
                         "kernel's register-held state takes")
    if s == 0 or chunk is not None and (chunk <= 0 or s % chunk):
        raise ValueError(f"seq {s} is not a positive multiple of chunk "
                         f"{chunk}")
    tensors = [t for t in (xdt, a, B, C, h0, *more) if t is not None]
    if any(t.device.type != "cuda" or t.device != xdt.device
           for t in tensors):
        raise ValueError("ssd_scan's CUDA kernel needs every tensor on one "
                         "CUDA device")


def _rows16(t):
    """``t`` itself where its last dim is contiguous and its base and other
    strides are 16-byte multiples (as the kernels' 16-byte copies need),
    else a contiguous copy in fresh (aligned) memory."""
    es = t.element_size()
    if (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and all(st * es % 16 == 0 for st in t.stride()[:-1])):
        return t
    return t.clone(memory_format=torch.contiguous_format)


def kernel_operands(xdt, a, B, C, h0):
    """The operands as the kernels take them: P padded with zero columns of
    x (and rows of h0) to a multiple of 4, N with zero columns of B, C (and
    h0) to a multiple of 8, x, a and h0 contiguous, and every x, B and C row
    on 16 bytes. A zero column of x gives a zero row of y and of the state;
    a zero column of B or C a zero state column that no output reads."""
    dp, dn = -xdt.shape[-1] % 4, -B.shape[-1] % 8
    if dp:
        xdt = F.pad(xdt, (0, dp))
    if dn:
        B, C = F.pad(B, (0, dn)), F.pad(C, (0, dn))
    if h0 is not None:
        h0 = (F.pad(h0, (0, dn, 0, dp)) if dp or dn else h0).contiguous()
    return (_rows16(xdt.contiguous()), a.contiguous(), _rows16(B),
            _rows16(C), h0)


def ssd_scan(xdt, a, B, C, chunk: int = 64, h0=None):
    """xdt: (b, s, h, p) f32 inputs pre-multiplied by dt; a: (b, s, h) f32
    log decays; B, C: (b, s, n) f32 or bf16; h0: optional (b, h, p, n) f32
    initial state (None = 0); ``s`` a multiple of ``chunk`` (the reference
    wrapper's contract; the kernel itself steps over sub-chunks of 32) and
    ``n`` at most 256. Returns (y (b, s, h, p) f32, h_final
    (b, h, p, n) f32). Launches the CUDA kernels on the current stream;
    raises on any input the kernels do not take and when a launch fails.

    The outputs carry no autograd history, so with grad mode on an input
    that requires grad raises: a gradient goes through
    ``models.ssm.SSDScan``, whose forward calls this under no grad."""
    global launches
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (xdt, a, B, C, h0)):
        raise RuntimeError("ssd_scan's CUDA kernel has no backward: take "
                           "the gradient through models.ssm.SSDScan")
    _check(xdt, a, B, C, h0, chunk)
    lib = _library()
    p, n = xdt.shape[-1], B.shape[-1]
    xdt, a, B, C, h0 = kernel_operands(xdt, a, B, C, h0)
    b, s, h, pk = xdt.shape
    nk = B.shape[-1]
    y = torch.empty((b, s, h, pk), dtype=torch.float32, device=xdt.device)
    hf = torch.empty((b, h, pk, nk), dtype=torch.float32, device=xdt.device)
    cb = torch.empty(lib.ssd_scan_scratch_floats(b, s), dtype=torch.float32,
                     device=xdt.device)
    rc = lib.ssd_scan_launch(
        xdt.data_ptr(), a.data_ptr(), B.data_ptr(), C.data_ptr(),
        h0.data_ptr() if h0 is not None else None, y.data_ptr(),
        hf.data_ptr(), cb.data_ptr(), b, s, h, pk, nk, xdt.stride(0),
        xdt.stride(1), xdt.stride(2), a.stride(0), a.stride(1), B.stride(0),
        B.stride(1), C.stride(0), C.stride(1), _BC_DTYPES[B.dtype],
        torch.cuda.current_stream(xdt.device).cuda_stream)
    if rc < 0:
        raise RuntimeError(f"ssd_scan launch failed: CUDA error {-rc}")
    launches += rc
    if (pk, nk) != (p, n):
        y, hf = y[..., :p].contiguous(), hf[:, :, :p, :n].contiguous()
    return y, hf


def grid_blocks(b: int, s: int, h: int, p: int, n: int,
                bc_dtype=torch.bfloat16) -> dict:
    """Thread blocks of one call: the C Bᵀ pass (a few per batch row and
    sub-chunk) and the scan (one per P tile, head and batch row), with the
    scan's shared memory per block and the blocks one SM holds at once."""
    lib = _library()
    q, pt = lib.ssd_scan_sub_chunk(), lib.ssd_scan_p_tile()
    per_sm = lib.ssd_scan_blocks_per_sm(n, _BC_DTYPES[bc_dtype])
    if per_sm < 0:
        raise RuntimeError(f"ssd_scan occupancy query failed: CUDA error "
                           f"{-per_sm}")
    return {"cb_pass": b * -(-s // q) * lib.ssd_scan_cb_split(),
            "scan": b * h * -(-p // pt),
            "scan_smem_bytes": lib.ssd_scan_smem_bytes(
                n, _BC_DTYPES[bc_dtype]),
            "scan_blocks_per_sm": per_sm}


def ssd_scan_backward(xdt, a, B, C, h0, gy, gh):
    """Gradients of ``ssd_scan`` (any chunk: the result does not depend on
    it) for the inputs xdt, a, B, C, h0 of a call, given gy (b, s, h, p)
    f32 and gh (b, h, p, n) f32 or None (0), the gradients of y and of the
    final state. Returns (dxdt, da, dB, dC, dh0), each in its input's dtype
    (dh0 None when h0 is None). Launches the three CUDA kernels on the
    current stream; raises on any input the kernels do not take (as
    ``ssd_scan`` does) and when a launch fails."""
    global backward_launches
    _check(xdt, a, B, C, h0, more=(gy, gh))
    if gy.dtype != torch.float32 or gy.shape != xdt.shape:
        raise ValueError(f"gy must be float32 {tuple(xdt.shape)}, not "
                         f"{gy.dtype} {tuple(gy.shape)}")
    b, s, h, p = xdt.shape
    n = B.shape[-1]
    if gh is not None and (gh.dtype != torch.float32
                           or gh.shape != (b, h, p, n)):
        raise ValueError(f"gh must be float32 {(b, h, p, n)}, not "
                         f"{gh.dtype} {tuple(gh.shape)}")
    lib = _library_bwd()
    xdt, a, B, C, h0 = kernel_operands(xdt, a, B, C, h0)
    pk, nk = xdt.shape[-1], B.shape[-1]
    gy, gh = backward_operands(gy, gh, pk, nk)
    dev = xdt.device
    dx = torch.empty((b, s, h, pk), dtype=torch.float32, device=dev)
    da = torch.empty((b, s, h), dtype=torch.float32, device=dev)
    dB = torch.empty((b, s, nk), dtype=B.dtype, device=dev)
    dC = torch.empty((b, s, nk), dtype=B.dtype, device=dev)
    dh0 = (torch.empty((b, h, pk, nk), dtype=torch.float32, device=dev)
           if h0 is not None else None)
    scratch = torch.empty(lib.ssd_scan_bwd_scratch_floats(b, s, h, pk, nk),
                          dtype=torch.float32, device=dev)
    ptr = lambda t: t.data_ptr() if t is not None else None  # noqa: E731
    rc = lib.ssd_scan_bwd_launch(
        xdt.data_ptr(), a.data_ptr(), B.data_ptr(), C.data_ptr(), ptr(h0),
        gy.data_ptr(), ptr(gh), dx.data_ptr(), da.data_ptr(), dB.data_ptr(),
        dC.data_ptr(), ptr(dh0), scratch.data_ptr(), b, s, h, pk, nk,
        B.stride(0), B.stride(1), C.stride(0), C.stride(1),
        _BC_DTYPES[B.dtype], torch.cuda.current_stream(dev).cuda_stream)
    if rc < 0:
        raise RuntimeError(f"ssd_scan_backward launch failed: CUDA error "
                           f"{-rc}")
    backward_launches += rc
    if (pk, nk) != (p, n):
        dx, dB, dC = (dx[..., :p].contiguous(), dB[..., :n].contiguous(),
                      dC[..., :n].contiguous())
        if dh0 is not None:
            dh0 = dh0[:, :, :p, :n].contiguous()
    return dx, da, dB, dC, dh0


def backward_operands(gy, gh, pk, nk):
    """gy and gh as the backward kernel takes them: gy padded with zero
    columns to ``pk`` state rows, contiguous, on 16 bytes; gh padded with
    zeros to (pk, nk) and contiguous. Zero gradients on the padded rows and
    columns of the state leave every other gradient as it is."""
    dp = pk - gy.shape[-1]
    if dp:
        gy = F.pad(gy, (0, dp))
    if gh is not None:
        dn = nk - gh.shape[-1]
        gh = (F.pad(gh, (0, dn, 0, dp)) if dp or dn else gh).contiguous()
    return _rows16(gy.contiguous()), gh


def backward_grid(b: int, s: int, h: int, p: int, n: int,
                  bc_dtype=torch.bfloat16) -> dict:
    """Thread blocks of one backward call per kernel — the C Bᵀ pass (a few
    per batch row and sub-chunk), the walk (one per P tile, head and batch
    row), the dB / dC / da kernel (one per head group, sub-chunk and batch
    row; the head groups of a sub-chunk form one cluster) — with each one's
    shared memory per block and the blocks one SM holds at once, and the
    scratch bytes the call allocates."""
    lib = _library_bwd()
    pk, nk = -(-p // 4) * 4, -(-n // 8) * 8
    dt = _BC_DTYPES[bc_dtype]
    n_sub = -(-s // lib.ssd_scan_bwd_sub_chunk())
    blocks = {"cb_pass": b * n_sub * lib.ssd_scan_bwd_cb_split(),
              "walk": b * h * -(-pk // lib.ssd_scan_bwd_p_tile()),
              "dbc": b * n_sub * lib.ssd_scan_bwd_head_groups(b, s, h, nk,
                                                              dt)}
    out = {}
    for k, (name, count) in enumerate(blocks.items()):
        per_sm = lib.ssd_scan_bwd_blocks_per_sm(k, nk, dt)
        if per_sm < 0:
            raise RuntimeError(f"ssd_scan_backward occupancy query failed: "
                               f"CUDA error {-per_sm}")
        out[name] = count
        out[f"{name}_smem_bytes"] = lib.ssd_scan_bwd_smem_bytes(k, nk, dt)
        out[f"{name}_blocks_per_sm"] = per_sm
    out["scratch_bytes"] = 4 * lib.ssd_scan_bwd_scratch_floats(b, s, h, pk,
                                                               nk)
    return out
