"""Mamba-2: attention-free SSM blocks using the SSD (state-space duality)
chunked algorithm [arXiv:2405.21060].

Forward and prefill run the chunked SSD scan: on the card through the
hand-written CUDA kernels (``kernels/ssd_scan.py``, one call per layer), on
the CPU through the plain chunked form in torch ops. Decode runs the O(1)
recurrent form. The recurrent state, not a KV cache, is this family's
decode state. Params keep the reference's layer-stacked layout.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models.transformer import layer_params

# the decode cache keeps the conv state in bf16 whatever the params' dtype,
# as the reference does; a comparison may set it to float32 to take that
# rounding out of a forward-vs-decode check
CONV_STATE_DTYPE = torch.bfloat16


# --------------------------------------------------------------------------
# params
# --------------------------------------------------------------------------

def conv_dim(cfg) -> int:
    return cfg.d_inner + 2 * cfg.ssm_state


def init_layer(generator, cfg, dtype=torch.bfloat16, device="cuda"):
    """One Mamba-2 block. Same scales as the reference: 1/sqrt(fan_in) for
    the projections, 0.5 for the conv taps, log(linspace(1, 16, h)) for
    A_log (f32), ones for D (f32) and the norms, zeros for dt_bias (f32)
    and the conv bias."""
    d, di, n, h = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_n_heads
    proj_out = 2 * di + 2 * n + h          # z, x, B, C, dt
    f32 = torch.float32
    return {
        "in_proj": L.dense_init(generator, (d, proj_out), dtype=dtype,
                                device=device),
        "conv_w": L.dense_init(generator, (cfg.ssm_conv, conv_dim(cfg)),
                               scale=0.5, dtype=dtype, device=device),
        "conv_b": torch.zeros((conv_dim(cfg),), dtype=dtype, device=device),
        "A_log": torch.log(torch.linspace(1.0, 16.0, h, dtype=f32,
                                          device=device)),
        "D": torch.ones((h,), dtype=f32, device=device),
        "dt_bias": torch.zeros((h,), dtype=f32, device=device),
        "norm_gate": torch.ones((di,), dtype=dtype, device=device),
        "out_proj": L.dense_init(generator, (di, d), dtype=dtype,
                                 device=device),
        "norm_in": torch.ones((d,), dtype=dtype, device=device),
    }


def init_params(cfg, generator: torch.Generator, device="cuda", dtype=None):
    """Random Mamba-2 params from ``generator`` (which must live on
    ``device``), every leaf under ``layers`` stacked on a leading n_layers
    axis."""
    dtype = dtype or L.torch_dtype(cfg.dtype)
    blocks = [init_layer(generator, cfg, dtype, device)
              for _ in range(cfg.n_layers)]
    return {"embed": L.init_embed(generator, cfg, dtype, device),
            "layers": {k: torch.stack([blk[k] for blk in blocks])
                       for k in blocks[0]}}


# --------------------------------------------------------------------------
# SSD chunked scan
# --------------------------------------------------------------------------

def _segsum(a):
    """a: (..., q) log-decays -> (..., q, q) lower-tri cumulative sums.
    T[i, j] = sum_{k=j+1..i} a_k for i >= j; -inf above the diagonal."""
    q = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]          # sum_{j+1..i}
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=a.device))
    return torch.where(mask, diff, -math.inf)


def _pad_to_chunk(xdt, a, B, C, chunk):
    """chunk = min(chunk, s), then pad the sequence to a multiple of it.
    Padded steps have a = 0 (no decay) and x = B = C = 0: they leave the
    state unchanged, and their outputs are sliced off by the caller."""
    s = xdt.shape[1]
    chunk = min(chunk, s)
    pad = (-s) % chunk
    if pad:
        xdt = F.pad(xdt, (0, 0, 0, 0, 0, pad))
        a = F.pad(a, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, pad))
    return xdt, a, B, C, chunk


def ssd_chunked_plain(xdt, a, B, C, h0=None, chunk: int = 256):
    """The chunked SSD scan in plain torch ops, on any device: the reference
    ``ssd_chunked`` line for line. The CPU path of ``ssd_chunked``; on the
    card only the comparisons with the kernel use it."""
    s_orig = xdt.shape[1]
    xdt, a, B, C, chunk = _pad_to_chunk(xdt, a, B, C, chunk)
    b, s, h, p = xdt.shape
    n = B.shape[-1]
    c = s // chunk
    xc = xdt.reshape(b, c, chunk, h, p).float()
    ac = a.reshape(b, c, chunk, h).permute(0, 3, 1, 2)     # (b,h,c,q)
    Bc = B.reshape(b, c, chunk, n).float()
    Cc = C.reshape(b, c, chunk, n).float()

    a_cum = torch.cumsum(ac, dim=-1)                        # (b,h,c,q)
    Lmat = torch.exp(_segsum(ac))                           # (b,h,c,q,q)

    # intra-chunk (quadratic, attention-like) term
    y_diag = torch.einsum("bcqn,bckn,bhcqk,bckhp->bcqhp", Cc, Bc, Lmat, xc)

    # per-chunk end states
    decay_states = torch.exp(a_cum[..., -1:] - a_cum)       # (b,h,c,q)
    states = torch.einsum("bckn,bhck,bckhp->bchpn", Bc, decay_states, xc)

    # inter-chunk recurrence; keep the state ENTERING each chunk
    chunk_decay = torch.exp(a_cum[..., -1])                 # (b,h,c)
    state = torch.zeros((b, h, p, n), dtype=torch.float32,
                        device=xdt.device) if h0 is None else h0.float()
    states_in = []
    for ci in range(c):
        states_in.append(state)
        state = state * chunk_decay[:, :, ci, None, None] + states[:, ci]
    states_in = torch.stack(states_in, dim=1)               # (b,c,h,p,n)

    # contribution of the entering state to each position
    state_decay = torch.exp(a_cum)                          # (b,h,c,q)
    y_off = torch.einsum("bcqn,bchpn,bhcq->bcqhp", Cc, states_in,
                         state_decay)

    y = (y_diag + y_off).reshape(b, s, h, p)[:, :s_orig]
    return y, state


def ssd_chunked(xdt, a, B, C, h0=None, chunk: int = 256):
    """Chunked SSD scan.

    xdt: (b, s, h, p)  inputs pre-multiplied by dt
    a:   (b, s, h)     log decay per step (= dt * A, negative)
    B,C: (b, s, n)     input/output projections (single group)
    h0:  (b, h, p, n)  initial state (decode continuation) or None
    Returns (y (b,s,h,p) f32, h_final (b,h,p,n) f32).

    A CPU tensor runs ``ssd_chunked_plain``; any other goes to the
    ``ssd_scan`` kernel through ``ops.ssd_scan`` (which launches or raises),
    on the same padded sequence.
    """
    if xdt.device.type == "cpu":
        return ssd_chunked_plain(xdt, a, B, C, h0, chunk)
    s = xdt.shape[1]
    xdt, a, B, C, chunk = _pad_to_chunk(xdt, a, B, C, chunk)
    y, h_final = ops.ssd_scan(xdt, a, B, C, chunk=chunk, h0=h0)
    return y[:, :s], h_final


def _causal_conv(x, w, b, state=None):
    """Depthwise causal conv. x: (B,S,C); w: (K,C). state: (B,K-1,C) or None.
    Returns (y (B,S,C), new_state (B,K-1,C))."""
    k = w.shape[0]
    if state is None:
        state = torch.zeros((x.shape[0], k - 1, x.shape[2]), dtype=x.dtype,
                            device=x.device)
    xp = torch.cat([state, x], dim=1)
    y = sum(xp[:, i:i + x.shape[1]] * w[i][None, None] for i in range(k))
    new_state = xp[:, -(k - 1):] if k > 1 else state
    return y + b[None, None], new_state


# --------------------------------------------------------------------------
# block
# --------------------------------------------------------------------------

def _split_proj(cfg, zxbcdt):
    di, n = cfg.d_inner, cfg.ssm_state
    z = zxbcdt[..., :di]
    xbc = zxbcdt[..., di:di + di + 2 * n]
    dt = zxbcdt[..., di + di + 2 * n:]
    return z, xbc, dt


def ssd_block(cfg, p, x, conv_state=None, ssm_state=None, chunk=None):
    """One Mamba-2 block. x: (B,S,d).
    Returns (out, new_conv_state, new_ssm_state)."""
    b, s, d = x.shape
    di, n, h = cfg.d_inner, cfg.ssm_state, cfg.ssm_n_heads
    pdim = cfg.ssm_head_dim
    res = x
    x = L.rms_norm(x, p["norm_in"], cfg.norm_eps)
    z, xbc, dt = _split_proj(cfg, x @ p["in_proj"])
    xbc, new_conv = _causal_conv(xbc, p["conv_w"], p["conv_b"], conv_state)
    xbc = F.silu(xbc)
    xs = xbc[..., :di].reshape(b, s, h, pdim)
    Bmat = xbc[..., di:di + n]
    Cmat = xbc[..., di + n:]
    dt = F.softplus(dt.float() + p["dt_bias"])                     # (B,S,H)
    A = -torch.exp(p["A_log"])                                     # (H,)
    a_log = dt * A[None, None]                                     # (B,S,H)
    xdt = xs.float() * dt[..., None]
    y, h_final = ssd_chunked(xdt, a_log, Bmat, Cmat, h0=ssm_state,
                             chunk=chunk or cfg.ssm_chunk)
    y = y + xs.float() * p["D"][None, None, :, None]
    y = y.reshape(b, s, di)
    y = L.rms_norm(y.to(res.dtype) * F.silu(z), p["norm_gate"],
                   cfg.norm_eps)
    return res + (y @ p["out_proj"]), new_conv, h_final


def ssd_decode_block(cfg, p, x, conv_state, ssm_state):
    """One-token recurrent step. x: (B,1,d); states threaded."""
    b = x.shape[0]
    di, n, h = cfg.d_inner, cfg.ssm_state, cfg.ssm_n_heads
    pdim = cfg.ssm_head_dim
    res = x
    x = L.rms_norm(x, p["norm_in"], cfg.norm_eps)
    z, xbc, dt = _split_proj(cfg, x @ p["in_proj"])
    xbc, new_conv = _causal_conv(xbc, p["conv_w"], p["conv_b"], conv_state)
    xbc = F.silu(xbc)
    xs = xbc[:, 0, :di].reshape(b, h, pdim).float()
    Bv = xbc[:, 0, di:di + n].float()
    Cv = xbc[:, 0, di + n:].float()
    dt = F.softplus(dt[:, 0].float() + p["dt_bias"])              # (B,H)
    A = -torch.exp(p["A_log"])
    decay = torch.exp(dt * A[None])                                # (B,H)
    upd = (xs * dt[..., None])[..., None] * Bv[:, None, None, :]  # (B,H,P,N)
    new_state = ssm_state * decay[..., None, None] + upd
    y = torch.einsum("bhpn,bn->bhp", new_state, Cv)
    y = y + xs * p["D"][None, :, None]
    y = y.reshape(b, 1, di)
    y = L.rms_norm(y.to(res.dtype) * F.silu(z), p["norm_gate"],
                   cfg.norm_eps)
    return res + (y @ p["out_proj"]), new_conv, new_state


# --------------------------------------------------------------------------
# model-level API
# --------------------------------------------------------------------------

def forward(cfg, params, tokens, *, chunk=None, **_):
    """Logits (B, S, vocab) in the params' dtype."""
    x = L.embed(params["embed"], tokens)
    for i in range(cfg.n_layers):
        x, _, _ = ssd_block(cfg, layer_params(params["layers"], i), x,
                            chunk=chunk)
    x = L.rms_norm(x, params["embed"]["norm_f"], cfg.norm_eps)
    return L.unembed(params["embed"], cfg, x)


def init_cache(cfg, batch: int, capacity: int = 0, dtype=torch.float32,
               device="cuda"):
    """Recurrent state 'cache': O(1) in sequence length (``capacity`` and
    ``dtype`` are unused, as in the reference: conv state in
    ``CONV_STATE_DTYPE``, SSM state f32)."""
    h, pdim, n = cfg.ssm_n_heads, cfg.ssm_head_dim, cfg.ssm_state
    return {
        "conv": torch.zeros((cfg.n_layers, batch, cfg.ssm_conv - 1,
                             conv_dim(cfg)), dtype=CONV_STATE_DTYPE,
                            device=device),
        "ssm": torch.zeros((cfg.n_layers, batch, h, pdim, n),
                           dtype=torch.float32, device=device),
    }


def prefill(cfg, params, tokens, *, chunk=None, **_):
    """Returns (last-token logits (B, vocab), cache, pos). The conv state is
    stored in ``CONV_STATE_DTYPE``."""
    x = L.embed(params["embed"], tokens)
    conv, ssm = [], []
    for i in range(cfg.n_layers):
        x, c, s = ssd_block(cfg, layer_params(params["layers"], i), x,
                            chunk=chunk)
        conv.append(c.to(CONV_STATE_DTYPE))
        ssm.append(s)
    x = L.rms_norm(x, params["embed"]["norm_f"], cfg.norm_eps)
    logits = L.unembed(params["embed"], cfg, x[:, -1:])
    cache = {"conv": torch.stack(conv), "ssm": torch.stack(ssm)}
    return logits[:, 0], cache, tokens.shape[1]


def decode_step(cfg, params, token, cache, pos=None, **_):
    """One token per sequence through the recurrent form. Returns (logits
    (B, vocab), new cache); the cache passed in is not modified."""
    x = L.embed(params["embed"], token[:, None])
    conv, ssm = [], []
    for i in range(cfg.n_layers):
        x, c, s = ssd_decode_block(cfg, layer_params(params["layers"], i), x,
                                   cache["conv"][i].to(x.dtype),
                                   cache["ssm"][i])
        conv.append(c.to(CONV_STATE_DTYPE))
        ssm.append(s)
    x = L.rms_norm(x, params["embed"]["norm_f"], cfg.norm_eps)
    logits = L.unembed(params["embed"], cfg, x)
    return logits[:, 0], {"conv": torch.stack(conv), "ssm": torch.stack(ssm)}
