"""Llama-style dense decoder in float32, layer by layer over many sequences.

``logits(model, params, seqs, wanted)`` runs every sequence through the whole
model and returns the float32 logits at the positions ``wanted`` asks for.
Projections and MLPs run over all sequences' rows at once; attention runs per
sequence, in blocks of query rows. Each layer's weights are upcast once for
all sequences, so only one layer is ever held in float32.

``precision="fp8"`` is the control: every product with a weight matrix takes
its operands rounded to float8 e4m3 (weights with one scale per matrix,
activations with one per row), the step below the bfloat16 that the
configurations state; attention's own products stay float32.
"""
from __future__ import annotations

import math
from contextlib import contextmanager
from typing import Callable, Dict, List, Sequence

import torch
import torch.nn.functional as F

FP8_MAX = 448.0
Q_ROWS = 1024          # query rows per attention block


@contextmanager
def exact_f32():
    """TF32 off for the duration (matmuls and convolutions)."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def fp8_round(x: torch.Tensor, dim=None) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under an absmax scale (one per tensor,
    or one per slice along ``dim``), back in float32."""
    amax = x.abs().amax() if dim is None else x.abs().amax(dim=dim,
                                                           keepdim=True)
    scale = (amax / FP8_MAX).clamp(min=1e-12)
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


def make_matmul(precision: str) -> Callable:
    if precision == "f32":
        return lambda x, w: x @ w
    if precision == "fp8":
        return lambda x, w: fp8_round(x, -1) @ w
    raise ValueError(f"unknown precision {precision!r}")


def upcast(w: torch.Tensor, precision: str) -> torch.Tensor:
    w = w.float()
    return fp8_round(w) if precision == "fp8" else w


def rms_norm(x, w, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w


def rope(x, positions, theta):
    """Rotate interleaved pairs (x[..., 0::2], x[..., 1::2]) of x (S, H, D)
    by position * theta^(-2i/D)."""
    d = x.shape[-1]
    inv = theta ** (-torch.arange(0, d, 2, dtype=torch.float64,
                                  device=x.device) / d)
    ang = (positions.double()[:, None] * inv).float()[:, None, :]
    x1, x2 = x[..., 0::2], x[..., 1::2]
    out = torch.stack([x1 * ang.cos() - x2 * ang.sin(),
                       x1 * ang.sin() + x2 * ang.cos()], dim=-1)
    return out.reshape(x.shape)


def attention(q, k, v, window: int = 0):
    """Causal softmax attention of one sequence: q (S, H, D), k/v (S, K, D),
    H a multiple of K; keys within ``window`` positions where it is set."""
    s, h, d = q.shape
    rep = h // k.shape[1]
    k = k.repeat_interleave(rep, dim=1).transpose(0, 1)        # (H, S, D)
    v = v.repeat_interleave(rep, dim=1).transpose(0, 1)
    q = q.transpose(0, 1) / math.sqrt(d)
    pos = torch.arange(s, device=q.device)
    out = []
    for r0 in range(0, s, Q_ROWS):
        qp = pos[r0:r0 + Q_ROWS, None]
        allowed = pos[None, :] <= qp
        if window:
            allowed &= pos[None, :] > qp - window
        sc = q[:, r0:r0 + Q_ROWS] @ k.transpose(1, 2)
        sc = sc.masked_fill(~allowed, float("-inf"))
        out.append(torch.softmax(sc, dim=-1) @ v)
    return torch.cat(out, dim=1).transpose(0, 1)               # (S, H, D)


def swiglu(x, w_gate, w_up, w_down, mm):
    return mm(F.silu(mm(x, w_gate)) * mm(x, w_up), w_down)


def dense_mlp(model, lp, x, mm, precision):
    m = lp["mlp"]
    return swiglu(x, *(upcast(m[n], precision)
                       for n in ("w_gate", "w_up", "w_down")), mm)


def logits(model: dict, params: Dict, seqs: Sequence[List[int]],
           wanted: Sequence[Sequence[int]], *, precision: str = "f32",
           mlp: Callable = dense_mlp) -> List[torch.Tensor]:
    """Float32 logits (len(wanted[j]), vocab) of every sequence j at the
    positions wanted[j]. ``params`` is the benchmark's weight tree;
    ``mlp(model, layer_params, x, mm, precision)`` is the layer's MLP."""
    mm = make_matmul(precision)
    dev = params["embed"]["tok"].device
    h, k, hd = model["n_heads"], model["n_kv_heads"], model["head_dim"]
    eps, theta = model["norm_eps"], model["rope_theta"]
    window = model.get("sliding_window", 0)
    lens = [len(s) for s in seqs]
    offs = [0]
    for n in lens:
        offs.append(offs[-1] + n)
    tokens = torch.tensor([t for s in seqs for t in s], device=dev)
    positions = torch.cat([torch.arange(n, device=dev) for n in lens])
    layers = params["layers"]
    with exact_f32(), torch.no_grad():
        x = params["embed"]["tok"][tokens].float()
        for i in range(model["n_layers"]):
            lp = {key: ({n: t[i] for n, t in val.items()}
                        if isinstance(val, dict) else val[i])
                  for key, val in layers.items()}
            a = lp["attn"]
            hx = rms_norm(x, lp["norm_attn"].float(), eps)
            q = mm(hx, upcast(a["wq"], precision)).view(-1, h, hd)
            kk = mm(hx, upcast(a["wk"], precision)).view(-1, k, hd)
            vv = mm(hx, upcast(a["wv"], precision)).view(-1, k, hd)
            q, kk = rope(q, positions, theta), rope(kk, positions, theta)
            o = torch.cat([attention(q[s:e], kk[s:e], vv[s:e], window)
                           for s, e in zip(offs[:-1], offs[1:])])
            x = x + mm(o.reshape(-1, h * hd), upcast(a["wo"], precision))
            hx = rms_norm(x, lp["norm_mlp"].float(), eps)
            x = x + mlp(model, lp, hx, mm, precision)
        rows = torch.cat([torch.as_tensor(list(w), device=dev, dtype=torch.long)
                          + s for w, s in zip(wanted, offs[:-1])])
        xf = rms_norm(x[rows], params["embed"]["norm_f"].float(), eps)
        out = mm(xf, upcast(params["embed"]["unembed"], precision))
    return list(out.split([len(w) for w in wanted]))
