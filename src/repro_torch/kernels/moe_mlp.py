"""Hopper kernel: the routed (mixture-of-experts) MLP over the pairs of
(token, expert) that the routing keeps.

The CUDA source is ``csrc/moe_mlp.cu`` (its header comment gives the design,
the bound and the precision); ``kernels/build.py`` compiles it with ``nvcc``
for ``sm_90a`` at first use into ``build/kernels/libmoe_mlp-<hash>.so`` and
loads it with ctypes. One call launches four kernels (dispatch, gate/up,
down, combine) on the current stream; the wrapper
allocates the output and every scratch array with ``torch.empty`` and never
waits for the card. Its plain version is ``models/moe.py`` ``expert_mix``
(every expert over every row, in f32), which the card tests hold it to.

``launches`` counts the calls that went through the kernels, one a call (a
routed MLP of one layer): a run sets it to 0 and reads it back to show that
a path went through the kernel.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import KernelLibrary

launches = 0


def _bind(lib):
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.moe_mlp_launch.argtypes = [ptr] * 15 + [i32] * 6 + [ptr]
    lib.moe_mlp_launch.restype = i32
    lib.moe_mlp_col_multiple.restype = i32
    lib.moe_mlp_max_k.restype = i32


LIB = KernelLibrary("moe_mlp", _bind)
build = LIB.build         # compile the library if this source is not built yet
_library = LIB.load       # built and bound once; later calls return it


def __getattr__(attr):
    # build_seconds: wall time of this process's nvcc run (None: not run)
    if attr == "build_seconds":
        return LIB.build_seconds
    raise AttributeError(f"module {__name__!r} has no attribute {attr!r}")


def _check(x, w_gate, w_up, w_down, topk_i, topk_p, keep):
    t, d = x.shape
    e, _, f = w_gate.shape
    k = topk_i.shape[1]
    if any(w.dtype != torch.bfloat16 for w in (x, w_gate, w_up, w_down)):
        raise TypeError("moe_mlp takes bfloat16 x and expert weights, not "
                        f"{x.dtype} / {w_gate.dtype}")
    if topk_i.dtype != torch.int64 or topk_p.dtype != torch.float32 or \
            (keep is not None and keep.dtype != torch.bool):
        raise TypeError("topk_i must be int64, topk_p float32, keep bool")
    if w_gate.shape != (e, d, f) or w_up.shape != (e, d, f) or \
            w_down.shape != (e, f, d) or topk_i.shape != (t, k) or \
            topk_p.shape != (t, k) or \
            (keep is not None and keep.shape != (t, k)):
        raise ValueError(f"shape mismatch: x {tuple(x.shape)}, experts "
                         f"{tuple(w_gate.shape)} / {tuple(w_up.shape)} / "
                         f"{tuple(w_down.shape)}, top-k {tuple(topk_i.shape)}"
                         f" / {tuple(topk_p.shape)}")
    tensors = [x, w_gate, w_up, w_down, topk_i, topk_p] + \
        ([keep] if keep is not None else [])
    if not all(w.is_contiguous() for w in tensors):
        raise ValueError("moe_mlp needs contiguous tensors")
    return tensors


def routed_mlp(x, w_gate, w_up, w_down, topk_i, topk_p, keep=None,
               tall: bool = False):
    """x: (T, d) bf16; w_gate, w_up: (E, d, f) bf16; w_down: (E, f, d) bf16;
    topk_i: (T, k) int64 experts; topk_p: (T, k) f32 gate weights; keep:
    (T, k) bool or None (every pair kept); tall: 128-row down tiles
    (prompts) instead of 32-row ones (one token a sequence), which changes
    the speed and never a bit of the output. Returns (out (T, d) bf16: each
    token's kept pairs' weighted expert outputs summed in ascending expert
    order, in f32, cast once; rows (E,) int32: the pairs each expert ran,
    on the card). Launches the CUDA kernels on the current stream; raises on
    any input they do not take and when a launch fails."""
    global launches
    tensors = _check(x, w_gate, w_up, w_down, topk_i, topk_p, keep)
    if any(w.device.type != "cuda" or w.device != x.device for w in tensors):
        raise ValueError("moe_mlp's CUDA kernels need every tensor on one "
                         "CUDA device")
    lib = _library()
    if any(w.data_ptr() % 16 for w in (x, w_gate, w_up, w_down)):
        raise ValueError("x and the expert weights must be 16-byte aligned")
    t, d = x.shape
    e, _, f = w_gate.shape
    k = topk_i.shape[1]
    cols = lib.moe_mlp_col_multiple()
    if d % cols or f % cols:
        raise ValueError(f"d {d} and f {f} must be multiples of {cols}")
    if k > lib.moe_mlp_max_k():
        raise ValueError(f"top-{k} routing: the kernel takes at most "
                         f"{lib.moe_mlp_max_k()} experts a token")
    pairs = t * k
    dev = x.device
    out = torch.empty_like(x)
    h = torch.empty((3, pairs, f), dtype=torch.bfloat16, device=dev)
    y = torch.empty((pairs, d), dtype=torch.float32, device=dev)
    rows = torch.empty(e, dtype=torch.int32, device=dev)
    ints = torch.empty(e + 1 + 2 * pairs, dtype=torch.int32, device=dev)
    offsets, tok, slot_of = ints.split([e + 1, pairs, pairs])
    gate = torch.empty(pairs, dtype=torch.float32, device=dev)
    rc = lib.moe_mlp_launch(
        x.data_ptr(), w_gate.data_ptr(), w_up.data_ptr(), w_down.data_ptr(),
        topk_i.data_ptr(), topk_p.data_ptr(),
        keep.data_ptr() if keep is not None else None, out.data_ptr(),
        h.data_ptr(), y.data_ptr(), offsets.data_ptr(), rows.data_ptr(),
        tok.data_ptr(), gate.data_ptr(), slot_of.data_ptr(), t, k, e, d, f,
        int(tall), torch.cuda.current_stream(dev).cuda_stream)
    if rc < 0:
        raise RuntimeError(f"moe_mlp launch failed: CUDA error {-rc}")
    launches += 1
    return out, rows
