"""RecurrentGemma / Griffin hybrid: RG-LRU recurrent blocks + local (MQA,
windowed) attention in a 2:1 pattern [arXiv:2402.19427].

The linear recurrence h_t = a_t * h_{t-1} + b_t runs SEQUENTIALLY over the
positions at prefill (one ``addcmul`` per position) and as an O(1) step at
decode. The reference evaluates it with an associative scan, whose
reduction tree depends on the length; the sequential order gives every
position the same bits whatever the chunking of the prompt, so a chunked
prefill equals a monolithic one bit for bit (with carried conv state that
round-trips losslessly, i.e. in a bf16 model).

Params keep the reference's layout: ``params["layers"]`` is a LIST of
per-layer dicts of two kinds (rglru and attention layers differ, so
nothing is layer-stacked). The gates are f32 products over f32 copies of
``wa`` and ``wx_gate``; ``f32_gates`` makes those copies (and
softplus(lambda)) once, for callers that keep them across calls (the
serving engine); without them each call upcasts, as the reference does.

Replicated transient state = RG-LRU hidden + conv state (packed into one
f32 state blob per request, ``pack_state_blob``) + the bounded
local-attention KV window.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.distributed import layout as ML
from repro_torch.models import layers as L

LRU_C = 8.0     # temperature constant from the Griffin paper
CONV_WIDTH = 4  # causal depthwise conv taps; decode carries CONV_WIDTH - 1


# --------------------------------------------------------------------------
# params
# --------------------------------------------------------------------------

def _mlp_init(generator, d, f, dtype, device):
    def w(*shape):
        return L.dense_init(generator, shape, dtype=dtype, device=device)
    return {"w_gate": w(d, f), "w_up": w(d, f), "w_down": w(f, d)}


def init_rglru_layer(generator, cfg, dtype, device):
    d, w = cfg.d_model, cfg.lru_width

    def dense(shape, scale=None):
        return L.dense_init(generator, shape, scale, dtype, device=device)

    return {
        "w_x": dense((d, w)),                  # recurrence branch
        "w_gate_in": dense((d, w)),            # gelu gate branch
        "conv_w": dense((CONV_WIDTH, w), 0.5),
        "conv_b": torch.zeros((w,), dtype=dtype, device=device),
        "wa": dense((w, w), 0.02),
        "wx_gate": dense((w, w), 0.02),
        "lambda_p": torch.linspace(2.0, 6.0, w, dtype=torch.float32,
                                   device=device),
        "w_out": dense((w, d)),
        "norm_t": torch.ones((d,), dtype=dtype, device=device),
        "mlp": _mlp_init(generator, d, cfg.d_ff, dtype, device),
        "norm_mlp": torch.ones((d,), dtype=dtype, device=device),
    }


def init_attn_layer(generator, cfg, dtype, device):
    d, h, k, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim

    def dense(*shape):
        return L.dense_init(generator, shape, dtype=dtype, device=device)

    attn = {"wq": dense(d, h * hd), "wk": dense(d, k * hd),
            "wv": dense(d, k * hd), "wo": dense(h * hd, d)}
    if cfg.qkv_bias:
        for name, width in (("bq", h * hd), ("bk", k * hd), ("bv", k * hd)):
            attn[name] = torch.zeros((width,), dtype=dtype, device=device)
    return {
        "attn": attn,
        "norm_t": torch.ones((d,), dtype=dtype, device=device),
        "mlp": _mlp_init(generator, d, cfg.d_ff, dtype, device),
        "norm_mlp": torch.ones((d,), dtype=dtype, device=device),
    }


def init_params(cfg, generator: torch.Generator, device="cuda", dtype=None):
    """Random hybrid params from ``generator`` (which must live on
    ``device``): the reference's tree and scales, one dict per layer."""
    dtype = dtype or L.torch_dtype(cfg.dtype)
    layers = [init_rglru_layer(generator, cfg, dtype, device)
              if kind == "rglru"
              else init_attn_layer(generator, cfg, dtype, device)
              for kind in cfg.layer_kinds()]
    return {"embed": L.init_embed(generator, cfg, dtype, device),
            "layers": layers}


# --------------------------------------------------------------------------
# RG-LRU
# --------------------------------------------------------------------------

def softplus(x):
    """``jax.nn.softplus``: logaddexp(x, 0), with no threshold (torch's
    ``softplus`` returns x itself above 20)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def f32_gates(p):
    """The f32 operands of one rglru layer's gates: ``wa`` and ``wx_gate``
    upcast (exact) and softplus(lambda_p). Made once and kept, they spare
    every call the upcast of two (w, w) matrices."""
    return {"wa": p["wa"].float(), "wx_gate": p["wx_gate"].float(),
            "softplus_lambda": softplus(p["lambda_p"].float())}


def gate_tables(cfg, params):
    """``f32_gates`` of every rglru layer, in depth order."""
    return [f32_gates(p) for p, kind in zip(params["layers"],
                                            cfg.layer_kinds())
            if kind == "rglru"]


def _rglru_gates(p, x, g=None, rows: int = 0):
    """x: (..., w) conv output. Returns (log_a, gated_input) f32. ``g``:
    the layer's ``f32_gates`` (made here when None); ``rows``: the gate
    products' row blocks (``layers.row_matmul``)."""
    g = g if g is not None else f32_gates(p)
    xf = x.float()
    r = torch.sigmoid(L.row_matmul(xf, g["wa"], rows))
    i = torch.sigmoid(L.row_matmul(xf, g["wx_gate"], rows))
    log_a = -LRU_C * r * g["softplus_lambda"]               # <= 0
    a_sq = torch.exp(2.0 * log_a)
    gated = torch.sqrt(torch.clamp(1.0 - a_sq, min=1e-6)) * (i * xf)
    return log_a, gated


def rglru_scan(p, x, h0=None, g=None, rows: int = 0):
    """Full-sequence RG-LRU, position by position. x: (B, S, w); h0: the
    carried (B, w) hidden (None = zeros). Returns (h (B, S, w) f32, the
    last h). Position 0 takes h0 exactly as every later position takes
    its predecessor (b + a * h), so a resumed chunk continues the bits of
    an unchunked run."""
    log_a, b = _rglru_gates(p, x, g, rows)
    a = torch.exp(log_a)
    h0 = torch.zeros_like(b[:, 0]) if h0 is None else h0.float()
    if ML.is_dtensor(b):
        # elementwise over batch and width: each shard's recurrence runs
        # on its local tensors
        mesh = b.device_mesh
        seq = ML.mesh_placements(mesh, 3, data=(0, b.shape[0]),
                                model=(2, b.shape[2]))
        last = ML.mesh_placements(mesh, 2, data=(0, b.shape[0]),
                                 model=(1, b.shape[2]))
        return ML.on_shards(_sequential, mesh, (seq, last),
                           (seq, seq, last))(a, b, h0)
    return _sequential(a, b, h0)


def _sequential(a, b, cur):
    """h_t = b_t + a_t * h_{t-1} over dim 1, from h_{-1} = ``cur``."""
    steps = []
    for bt, at in zip(b.unbind(1), a.unbind(1)):
        cur = torch.addcmul(bt, at, cur)
        steps.append(cur)
    return torch.stack(steps, dim=1), cur


def rglru_step(p, x, h, g=None):
    """One-token step. x: (B, w); h: (B, w). Returns (new_h, new_h)."""
    log_a, b = _rglru_gates(p, x, g)
    new_h = torch.addcmul(b, torch.exp(log_a), h.float())
    return new_h, new_h


# --------------------------------------------------------------------------
# blocks
# --------------------------------------------------------------------------

def _conv1d(x, w, b, state=None):
    """Causal depthwise conv: taps summed in order i = 0..3 in x's dtype.
    Returns (y, the last CONV_WIDTH - 1 input rows)."""
    k = w.shape[0]
    if state is None:
        state = torch.zeros((x.shape[0], k - 1, x.shape[2]), dtype=x.dtype,
                            device=x.device)
    xp = torch.cat([state, x], dim=1)
    s = x.shape[1]
    y = xp[:, 0:s] * w[0][None, None]
    for i in range(1, k):
        y = y + xp[:, i:i + s] * w[i][None, None]
    return y + b[None, None], xp[:, -(k - 1):]


def _recurrent_core(cfg, p, x, state=None, g=None, rows: int = 0):
    """Shared RG-LRU block body (norm -> branch/gate -> conv -> recurrence
    -> gated output -> MLP). state: None | {"h": (B, w), "conv": (B, 3, w)};
    x: (B, S, d); ``g`` as in ``_rglru_gates``; the products in ``rows``-row
    blocks. Returns the block output, the end-of-sequence state, the
    pre-conv branch and the full recurrence output (so the bucketed prefill
    can take the state at an interior position)."""
    res = x
    xn = L.rms_norm(x, p["norm_t"], cfg.norm_eps)
    branch = L.row_matmul(xn, p["w_x"], rows)
    gate = F.gelu(L.row_matmul(xn, p["w_gate_in"], rows), approximate="tanh")
    conv_state = state["conv"].to(branch.dtype) if state else None
    conv_out, new_conv = _conv1d(branch, p["conv_w"], p["conv_b"],
                                 conv_state)
    if x.shape[1] == 1 and state is not None:
        new_h, out = rglru_step(p, conv_out[:, 0], state["h"], g)
        out = out[:, None]
    else:
        out, new_h = rglru_scan(p, conv_out, state["h"] if state else None,
                                g, rows)
    y = L.row_matmul(out.to(gate.dtype) * gate, p["w_out"], rows)
    x = res + y
    h2 = L.rms_norm(x, p["norm_mlp"], cfg.norm_eps)
    x = x + L.mlp(p["mlp"], h2, rows)
    return x, {"h": new_h, "conv": new_conv.to(torch.bfloat16)}, branch, out


def _recurrent_block(cfg, p, x, state=None, g=None):
    """state: None | {"h": (B, w), "conv": (B, 3, w)}. x: (B, S, d)."""
    x, new_state, _, _ = _recurrent_core(cfg, p, x, state, g)
    return x, new_state


def recurrent_prefill(cfg, p, x, true_len: int, g=None, rows: int = 0):
    """``_recurrent_block`` over a bucket-padded prompt, returning the
    decode state at position ``true_len`` instead of at the padded end.

    The recurrence is causal, so outputs below true_len ignore the tail
    padding; the decode state is h after token true_len - 1 and the last
    CONV_WIDTH - 1 pre-conv branch rows before true_len (zero-padded on the
    left for short prompts). Returns (x_out (B, S, d), h (B, w) f32,
    conv (B, CONV_WIDTH - 1, w) bf16)."""
    x, _, branch, out = _recurrent_core(cfg, p, x, None, g, rows)
    h = out[:, true_len - 1]
    k = p["conv_w"].shape[0]
    zeros = torch.zeros((branch.shape[0], k - 1, branch.shape[-1]),
                        dtype=branch.dtype, device=branch.device)
    # x row j sits at xp row j + k - 1, so rows [true_len, true_len + k - 2]
    # of xp are the conv state a decode at position true_len sees
    xp = torch.cat([zeros, branch], dim=1)
    return x, h, xp[:, true_len:true_len + k - 1].to(torch.bfloat16)


def recurrent_prefill_resume(cfg, p, x, take: int, state, g=None,
                             rows: int = 0):
    """``recurrent_prefill`` for ONE CHUNK of a chunked prompt: resume from
    the carried state (all zeros before the first chunk) and return the
    next carried state at row ``take`` of the chunk (rows >= take are
    padding). Returns (x_out, h, conv) like ``recurrent_prefill``."""
    x, _, branch, out = _recurrent_core(cfg, p, x, state, g, rows)
    h = out[:, take - 1]
    k = p["conv_w"].shape[0]
    # the conv input this chunk saw: carried rows, then the chunk's branch
    xp = torch.cat([state["conv"].to(branch.dtype), branch], dim=1)
    return x, h, xp[:, take:take + k - 1].to(torch.bfloat16)


# --------------------------------------------------------------------------
# state blob codec (paged serving: the RG-LRU state as one opaque
# replication unit per request)
# --------------------------------------------------------------------------

def recurrent_layer_indices(cfg):
    return tuple(i for i, k in enumerate(cfg.layer_kinds()) if k == "rglru")


def state_blob_words(cfg) -> int:
    """f32 words of one request's packed recurrent state: per rglru layer,
    h (w,) + conv (CONV_WIDTH - 1, w). The bf16 conv state round-trips
    losslessly through the f32 carrier."""
    w = cfg.lru_width
    return len(recurrent_layer_indices(cfg)) * (w + (CONV_WIDTH - 1) * w)


def pack_state_blob(cfg, states):
    """states: list (per rglru layer, depth order) of {"h": (B, w) f32,
    "conv": (B, 3, w) bf16} -> (B, state_blob_words) f32."""
    parts = []
    for st in states:
        b = st["h"].shape[0]
        parts.append(st["h"].float())
        parts.append(st["conv"].float().reshape(b, -1))
    return torch.cat(parts, dim=-1)


def unpack_state_blob(cfg, blob):
    """(B, state_blob_words) f32 -> list of per-rglru-layer state dicts."""
    w = cfg.lru_width
    rows = CONV_WIDTH - 1
    states = []
    off = 0
    for _ in recurrent_layer_indices(cfg):
        h = blob[:, off:off + w]
        off += w
        conv = blob[:, off:off + rows * w].reshape(-1, rows, w).to(
            torch.bfloat16)
        off += rows * w
        states.append({"h": h, "conv": conv})
    return states


# --------------------------------------------------------------------------
# local attention block
# --------------------------------------------------------------------------

def _attn_block(cfg, p, x, positions, *, q_chunk=1024, cache=None,
                pos=None, kv_len=None):
    res = x
    h = L.rms_norm(x, p["norm_t"], cfg.norm_eps)
    q, k, v = L.qkv_proj(p["attn"], cfg, h, positions)
    if cache is None:
        o = L.attention(q, k, v, causal=True, window=cfg.sliding_window,
                        q_chunk=min(q_chunk, x.shape[1]))
        new_cache = (k, v)
    else:
        slot = pos % cache["k"].shape[1]
        ck = L.kv_cache_update(cache["k"], k, slot)
        cv = L.kv_cache_update(cache["v"], v, slot)
        o = L.attention(q, ck, cv, causal=False, kv_len=kv_len)
        new_cache = {"k": ck, "v": cv}
    x = res + L.attn_out(p["attn"], o)
    h2 = L.rms_norm(x, p["norm_mlp"], cfg.norm_eps)
    x = x + L.mlp(p["mlp"], h2)
    return x, new_cache


# --------------------------------------------------------------------------
# model-level API
# --------------------------------------------------------------------------

def _positions(b: int, s: int, device):
    return torch.arange(s, dtype=torch.int32, device=device)[None].expand(
        b, s)


def forward(cfg, params, tokens, *, q_chunk: int = 1024, **_):
    """Full-sequence forward -> logits (B, S, V) in the activation dtype."""
    x = L.embed(params["embed"], tokens)
    b, s, _ = x.shape
    positions = _positions(b, s, x.device)
    for p, kind in zip(params["layers"], cfg.layer_kinds()):
        if kind == "rglru":
            x, _ = _recurrent_block(cfg, p, x)
        else:
            x, _ = _attn_block(cfg, p, x, positions, q_chunk=q_chunk)
    x = L.rms_norm(x, params["embed"]["norm_f"], cfg.norm_eps)
    return L.unembed(params["embed"], cfg, x)


def init_cache(cfg, batch: int, capacity: int = 0, dtype=torch.bfloat16,
               device="cuda"):
    """Per-layer decode state, keyed "layer_i": the RG-LRU hidden and conv
    state, or a ring-buffer k/v of ``capacity`` rows (default: the local
    attention window)."""
    cap = capacity or cfg.sliding_window
    w = cfg.lru_width
    cache = {}
    for i, kind in enumerate(cfg.layer_kinds()):
        if kind == "rglru":
            cache[f"layer_{i}"] = {
                "h": torch.zeros((batch, w), dtype=torch.float32,
                                 device=device),
                "conv": torch.zeros((batch, CONV_WIDTH - 1, w),
                                    dtype=torch.bfloat16, device=device)}
        else:
            shape = (batch, cap, cfg.n_kv_heads, cfg.head_dim)
            cache[f"layer_{i}"] = {
                "k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device)}
    return cache


def _pad(x, pad: int):
    if pad == 0:
        return x
    return F.pad(x, (0, 0, 0, 0, 0, pad))


def prefill(cfg, params, tokens, *, capacity: int = 0, q_chunk: int = 1024,
            **_):
    """Run the prompt; returns (last-position logits (B, V), the per-layer
    cache — attention layers keep their last ``capacity`` rows, padded —
    and pos = S)."""
    x = L.embed(params["embed"], tokens)
    b, s, _ = x.shape
    cap = capacity or cfg.sliding_window
    positions = _positions(b, s, x.device)
    # the config's KV storage dtype (f32 comparisons rely on the cache not
    # rounding to bf16)
    kdt = L.kv_cache_dtype(cfg)
    cache = {}
    for i, (p, kind) in enumerate(zip(params["layers"], cfg.layer_kinds())):
        if kind == "rglru":
            x, st = _recurrent_block(cfg, p, x)
            cache[f"layer_{i}"] = st
        else:
            x, (k, v) = _attn_block(cfg, p, x, positions, q_chunk=q_chunk)
            keep = min(cap, s)
            cache[f"layer_{i}"] = {
                "k": _pad(k[:, s - keep:].to(kdt), cap - keep),
                "v": _pad(v[:, s - keep:].to(kdt), cap - keep)}
    x = L.rms_norm(x, params["embed"]["norm_f"], cfg.norm_eps)
    logits = L.unembed(params["embed"], cfg, x[:, -1:])
    return logits[:, 0], cache, s


def decode_step(cfg, params, token, cache, pos, **_):
    """One decode step for a batch at one position ``pos`` (an int or a 0-d
    tensor). Returns (logits (B, V), the new cache)."""
    x = L.embed(params["embed"], token[:, None])
    b = x.shape[0]
    pos = torch.as_tensor(pos, dtype=torch.int32, device=x.device)
    positions = pos.expand(b, 1)
    new_cache = {}
    for i, (p, kind) in enumerate(zip(params["layers"], cfg.layer_kinds())):
        key = f"layer_{i}"
        if kind == "rglru":
            x, new_cache[key] = _recurrent_block(cfg, p, x,
                                                 state=cache[key])
        else:
            cap = cache[key]["k"].shape[1]
            kv_len = torch.clamp(pos + 1, max=cap)
            x, new_cache[key] = _attn_block(cfg, p, x, positions,
                                            cache=cache[key], pos=pos,
                                            kv_len=kv_len)
    x = L.rms_norm(x, params["embed"]["norm_f"], cfg.norm_eps)
    logits = L.unembed(params["embed"], cfg, x)
    return logits[:, 0], new_cache
