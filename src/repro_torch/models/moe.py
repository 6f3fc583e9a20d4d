"""Mixture-of-Experts decoder (Mixtral 8x top-2, DBRX 16x top-4).

Routing is the reference's GShard-style capacity routing over fixed-size
token groups (``GROUP_SIZE`` tokens): f32 router logits, softmax, top-k
(ties to the lower expert index), renormalised gates, and per-group
expert capacity C = max(k, g*k/E*cf) — a token keeps its choice of expert
e only while its rank among the group's (token, choice) pairs routed to e,
counted token-major, is below C.

The reference dispatches and combines through one-hot einsums. Here every
expert runs over the group's tokens and its output is weighted by the
token's combine weight for it — exactly zero for an expert the token did
not pick or was dropped from — and the experts are summed in ascending
index order. That is the same function, and its matrix products have a
fixed shape per step (the token count), never "how many tokens picked this
expert": a token's result depends on its own row only, so decode and
serving prefill are batch-invariant, which failover, chunked prefill, the
prefix cache and disaggregation all rely on bit for bit. It costs E/k times
the expert FLOPs of a dispatch; the weight bytes read are the same.

The expert math is f32 on upcast operands, as in the reference: each
expert's three matrices are upcast one expert at a time into one f32
buffer per shape, the SwiGLU and down projection stay in f32, and the
output is cast to the activation dtype once, at the end.

On the card, bf16 experts outside autograd go to the routed-MLP kernel
(``kernels/moe_mlp.py``): each token through its own top-k experts only,
the bf16 weights straight into the tensor cores, every product exact, the
sums in a fixed order that never depends on the row count — the same
function, and the same batch invariance, at the cost of reading the
weights once. ``expert_mix`` stays the plain version: for CPU tensors,
under autograd (training), for f32 experts (nothing to upcast) and on the
mesh and dry-run path.

Attention reuses the dense stack (incl. SWA). Params keep the reference's
layer-stacked layout: ``experts.w_*`` (L, E, d, f) / (L, E, f, d),
``router`` (L, d, E) in f32.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch import tracing
from repro_torch.distributed import layout as ML
from repro_torch.kernels import moe_mlp as MOE
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.transformer import layer_params

GROUP_SIZE = 512

# decode-time capacity factor. None -> cf = n_experts (drop-free: a token's
# experts never depend on the other tokens of the decode batch). A finite
# cf bounds the experts' rows at the cost of rare batch-dependent drops.
DECODE_CAPACITY_FACTOR: Optional[float] = None


# --------------------------------------------------------------------------
# params
# --------------------------------------------------------------------------

def _empty_tree(cfg, dtype, device):
    """Uninitialised layer-stacked tensors for every layer leaf."""
    n, d, h, k, hd = (cfg.n_layers, cfg.d_model, cfg.n_heads,
                      cfg.n_kv_heads, cfg.head_dim)
    e, f = cfg.n_experts, cfg.d_ff

    def empty(*shape, dt=dtype):
        return torch.empty((n, *shape), dtype=dt, device=device)

    attn = {"wq": empty(d, h * hd), "wk": empty(d, k * hd),
            "wv": empty(d, k * hd), "wo": empty(h * hd, d)}
    if cfg.qkv_bias:
        for name, width in (("bq", h * hd), ("bk", k * hd), ("bv", k * hd)):
            attn[name] = torch.zeros((n, width), dtype=dtype, device=device)
    return {
        "attn": attn,
        "router": empty(d, e, dt=torch.float32),
        "experts": {"w_gate": empty(e, d, f), "w_up": empty(e, d, f),
                    "w_down": empty(e, f, d)},
        "norm_attn": torch.ones((n, d), dtype=dtype, device=device),
        "norm_mlp": torch.ones((n, d), dtype=dtype, device=device),
    }


def init_layer(generator, cfg, layers, i: int):
    """Draw layer ``i`` of the stacked tree ``layers`` in place, one
    matrix at a time (one expert of one projection), so the f32 draw never
    holds more than one (d, f) matrix. Same scales as the reference:
    1/sqrt(fan_in) for projections and experts, 0.02 for the f32 router;
    the norms stay ones and the biases zeros."""
    dev = layers["router"].device

    def draw(out, scale=None):
        out.copy_(L.dense_init(generator, tuple(out.shape), scale, out.dtype,
                               device=dev))

    for name in ("wq", "wk", "wv", "wo"):
        draw(layers["attn"][name][i])
    draw(layers["router"][i], 0.02)
    for name in ("w_gate", "w_up", "w_down"):
        stack = layers["experts"][name][i]
        for e in range(cfg.n_experts):
            draw(stack[e])


def init_params(cfg, generator: torch.Generator, device="cuda", dtype=None):
    """Random MoE params from ``generator`` (which must live on
    ``device``), layer-stacked as in the reference."""
    dtype = dtype or L.torch_dtype(cfg.dtype)
    layers = _empty_tree(cfg, dtype, device)
    for i in range(cfg.n_layers):
        init_layer(generator, cfg, layers, i)
    return {"embed": L.init_embed(generator, cfg, dtype, device),
            "layers": layers}


# --------------------------------------------------------------------------
# routing + expert compute
# --------------------------------------------------------------------------

def top_k(probs, k: int):
    """(values, indices) of the k largest entries of the last dim, ties to
    the lower index first (``jax.lax.top_k``'s order; ``torch.topk``
    promises no order for ties): a stable descending sort, cut at k."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def gates(cfg, router, xg, rows: int = 0):
    """``route``'s probabilities, top-k experts and renormalised gates,
    without the capacity mask (every choice kept when the capacity is at
    least the group's pairs)."""
    probs = torch.softmax(L.row_matmul(xg.float(), router, rows), dim=-1)
    topk_p, topk_i = top_k(probs, cfg.top_k)
    return probs, topk_i, topk_p / (topk_p.sum(dim=-1, keepdim=True) + 1e-9)


def route(cfg, router, xg, capacity: int, rows: int = 0):
    """Routing of token groups ``xg`` (G, g, d) through ``router`` (d, E),
    the logits in products of ``rows`` tokens (``L.row_matmul``).

    Returns (probs (G, g, E) f32, topk_i (G, g, k) int64, topk_p (G, g, k)
    f32 renormalised gates, keep (G, g, k) bool, onehot (G, g, k, E) f32):
    ``keep`` is whether the choice's rank among the group's (token,
    choice) pairs routed to its expert, counted in token-major,
    choice-minor order, is below ``capacity``."""
    n_groups, g, _ = xg.shape
    e, k = cfg.n_experts, cfg.top_k
    probs, topk_i, topk_p = gates(cfg, router, xg, rows)
    experts = torch.arange(e, device=xg.device)
    onehot = (topk_i[..., None] == experts).float()          # (G,g,k,E)
    flat = onehot.reshape(n_groups, g * k, e)
    before = torch.cumsum(flat, dim=1) - flat                 # exclusive
    rank = (before.reshape(n_groups, g, k, e) * onehot).sum(dim=-1)
    return probs, topk_i, topk_p, rank < capacity, onehot


def expert_mix(experts, x32, weights, rows: int = 0):
    """sum_e weights[:, e] * expert_e(x32), experts in ascending order.

    x32: (T, d) f32; weights: (T, E) f32 combine weights. Every expert
    runs over all T rows (fixed shapes), in products of ``rows`` rows
    (``L.row_matmul``); bf16 expert matrices are upcast one expert at a
    time into one f32 buffer per shape (under autograd, which needs each
    upcast kept for the backward, into one fresh f32 copy per expert: the
    same values)."""
    w_gate, w_up, w_down = (experts["w_gate"], experts["w_up"],
                            experts["w_down"])
    upcast = w_gate.dtype != torch.float32 and not (
        torch.is_grad_enabled() and w_gate.requires_grad)
    if upcast:
        bufs = [torch.empty(w.shape[1:], dtype=torch.float32,
                            device=w.device) for w in (w_gate, w_up, w_down)]
    out = torch.zeros_like(x32)
    for e in range(w_gate.shape[0]):
        if upcast:
            wg, wu, wd = (buf.copy_(w[e]) for buf, w in
                          zip(bufs, (w_gate, w_up, w_down)))
        else:
            wg, wu, wd = (w[e].float() for w in (w_gate, w_up, w_down))
        h = F.silu(L.row_matmul(x32, wg, rows)) \
            * L.row_matmul(x32, wu, rows)
        out += weights[:, e:e + 1] * L.row_matmul(h, wd, rows)
    return out


def on_kernel(x, experts) -> bool:
    """Whether the routed MLP of ``x`` runs on the CUDA kernel: a real
    (not fake, not mesh) CUDA tensor, bf16 activations and experts, and no
    gradient to keep."""
    w = experts["w_gate"]
    return (type(x) is torch.Tensor and x.is_cuda
            and x.dtype == w.dtype == torch.bfloat16
            and not (torch.is_grad_enabled()
                     and (x.requires_grad or w.requires_grad)))


def _mesh_moe_mlp(cfg, p, x, capacity_factor, group_size, rows):
    """``moe_mlp`` on DTensors, run on each device's local tensors: its
    rows (the batch over the data axes, where they divide it) routed in
    groups of its own, and over the model axis its share of the experts
    (an expert axis the axis divides and the layout splits:
    ``expert_parallel``) or of each expert's ``d_ff`` (gate and up columns,
    down rows: a tensor-parallel MLP). The output sums the model axis's
    shares; the aux loss averages the data shards' (equal token counts).
    The gradients' layouts are chosen for the collectives they cost (the
    dry run reads no values): each weight's gradient sums over the data
    shards, and the router's and the input's over the model shares too."""
    from torch.distributed.tensor import Partial, Replicate
    mesh = x.device_mesh
    names = mesh.mesh_dim_names
    ex = p["experts"]
    e, f = ex["w_gate"].shape[0], ex["w_gate"].shape[2]
    model = names.index("model") if "model" in names else None
    x_pl = ML.mesh_placements(mesh, 3, data=(0, x.shape[0]))
    whole = [Replicate()] * mesh.ndim
    if model is not None and e % mesh.size(model) == 0 and \
            ex["w_gate"].placements[model].is_shard(0):
        gate_pl = down_pl = ML.mesh_placements(mesh, 3, model=(0, e))
    else:
        gate_pl = ML.mesh_placements(mesh, 3, model=(2, f))
        down_pl = ML.mesh_placements(mesh, 3, model=(1, f))
    split = model is not None and not gate_pl[model].is_replicate()
    y_pl = ML.partial_on_model(mesh, x_pl) if split else x_pl
    aux_pl = [Partial("avg") if pl.is_shard() else Replicate()
              for pl in x_pl]
    # a weight's gradient sums the data shards' (and, for the router and
    # the input, the model shares') contributions
    data_sum = [Partial() if pl.is_shard() else Replicate() for pl in x_pl]
    router_grad = ML.partial_on_model(mesh, data_sum) if split else data_sum

    def summed(pls):
        return [Partial() if d.is_partial() and pl.is_replicate() else pl
                for pl, d in zip(pls, data_sum)]

    def local(xl, router, wg, wu, wd):
        lp = {"router": router,
              "experts": {"w_gate": wg, "w_up": wu, "w_down": wd}}
        return moe_mlp(cfg, lp, xl, capacity_factor=capacity_factor,
                       group_size=group_size, rows=rows, kernel=False)

    return ML.on_shards(
        local, mesh, (y_pl, aux_pl),
        (x_pl, whole, gate_pl, gate_pl, down_pl),
        (y_pl, router_grad, summed(gate_pl), summed(gate_pl),
         summed(down_pl)))(
        x, ML.use_weight(p["router"]), ML.use_weight(ex["w_gate"]),
        ML.use_weight(ex["w_up"]), ML.use_weight(ex["w_down"]))


def moe_mlp(cfg, p, x, *, capacity_factor: float = 1.25,
            group_size: int = GROUP_SIZE, rows: int = 0,
            kernel: Optional[bool] = None, aux: bool = True):
    """Routed expert MLP of one layer (params ``p``). x: (B, S, d) ->
    ((B, S, d) in x's dtype, f32 load-balance aux loss, None without
    ``aux``). ``rows``: the router's (and the plain version's) row blocks
    (``L.row_matmul``). ``kernel``: None runs the CUDA kernel where
    ``on_kernel`` holds, False the plain version (``expert_mix``); the
    kernel's tiles follow S (1: decode, more: a prompt), which never
    changes a bit. On the kernel the span open around the call
    (``moe.routed_mlp`` when serving) gets ``pairs`` (dispatched pairs,
    when no capacity drops any) and ``expert_rows`` (pairs per expert, a
    device tensor read at the trace's export)."""
    if ML.is_dtensor(x):
        return _mesh_moe_mlp(cfg, p, x, capacity_factor, group_size, rows)
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    g = min(group_size, b * s)
    if (b * s) % g:
        raise ValueError(f"tokens {b * s} not divisible by group {g}")
    xg = x.reshape((b * s) // g, g, d)
    cap = int(max(k, g * k / e * capacity_factor))
    # a pair's rank is below g * k: that capacity drops none
    drop_free = cap >= g * k
    ex = p["experts"]
    if kernel is None:
        kernel = on_kernel(x, ex)
    if kernel and drop_free and not aux:
        # the kernel needs no mask where it is all true, nor one-hots
        _, topk_i, topk_p = gates(cfg, p["router"], xg, rows)
    else:
        probs, topk_i, topk_p, keep, onehot = route(cfg, p["router"], xg,
                                                    cap, rows)
    if kernel:
        out, expert_rows = MOE.routed_mlp(
            x.reshape(b * s, d).contiguous(), ex["w_gate"], ex["w_up"],
            ex["w_down"], topk_i.reshape(b * s, k).contiguous(),
            topk_p.reshape(b * s, k),
            None if drop_free else keep.reshape(b * s, k), tall=s > 1)
        tracing.annotate(expert_rows=expert_rows,
                         **({"pairs": b * s * k} if drop_free else {}))
    else:
        combine = (onehot * (topk_p * keep)[..., None]).sum(dim=2)
        out = expert_mix(ex, xg.reshape(b * s, d).float(),
                         combine.reshape(b * s, e), rows)
    out = out.reshape(b, s, d).to(x.dtype)
    if not aux:
        return out, None
    # Switch-style load-balance auxiliary loss
    me = probs.mean(dim=(0, 1))
    ce = (onehot[..., 0, :] if k == 1 else onehot.mean(dim=2)).mean(
        dim=(0, 1))
    return out, cfg.router_aux_coef * e * (me * ce).sum()


def decode_mlp(cfg, p, x):
    """Routed MLP for the paged decode hot loop. x: (B, 1, d) — one token
    per engine slot, one routing group. Drop-free by default (cf =
    n_experts), so each token's experts depend only on the token, and the
    products have the fixed shape of the slot count (the kernel's rows are
    independent of each other by construction): a slot's output is the
    same bits whatever the other slots hold. No host sync."""
    cf = DECODE_CAPACITY_FACTOR or float(cfg.n_experts)
    y, _ = moe_mlp(cfg, p, x, group_size=x.shape[0] * x.shape[1],
                   capacity_factor=cf, aux=False)
    return y


def serving_prefill_mlp(cfg, p, x, rows: int = 0):
    """Routed MLP for bucket-padded serving prefill: drop-free capacity
    makes every real token's output independent of the tail padding (a
    finite capacity factor would let padding tokens take real tokens'
    expert slots) and of the other tokens; ``rows`` as in ``moe_mlp``."""
    y, _ = moe_mlp(cfg, p, x, capacity_factor=float(cfg.n_experts),
                   rows=rows, aux=False)
    return y


# --------------------------------------------------------------------------
# forward / prefill / decode
# --------------------------------------------------------------------------

def _block(cfg, p, x, positions, *, window, q_chunk, capacity_factor=1.25):
    h = L.rms_norm(x, p["norm_attn"], cfg.norm_eps)
    q, k, v = L.qkv_proj(p["attn"], cfg, h, positions)
    o = L.attention(q, k, v, causal=True, window=window, q_chunk=q_chunk)
    x = x + L.attn_out(p["attn"], o)
    h = L.rms_norm(x, p["norm_mlp"], cfg.norm_eps)
    y, aux = moe_mlp(cfg, p, h, capacity_factor=capacity_factor)
    return x + y, aux, (k, v)


def _positions(b: int, s: int, device):
    return torch.arange(s, dtype=torch.int32, device=device)[None].expand(
        b, s)


def forward(cfg, params, tokens, *, window_override: Optional[int] = None,
            q_chunk: int = 1024, return_aux: bool = False,
            capacity_factor: float = 1.25):
    """Full-sequence forward -> logits (B, S, V) in the activation dtype
    (and the summed aux loss with ``return_aux``)."""
    x = L.embed(params["embed"], tokens)
    b, s, _ = x.shape
    positions = _positions(b, s, x.device)
    window = window_override if window_override is not None \
        else cfg.sliding_window
    q_chunk = min(q_chunk, s)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for p in T.unstacked(params["layers"]):
        x, a, _ = _block(cfg, p, x, positions, window=window,
                         q_chunk=q_chunk, capacity_factor=capacity_factor)
        aux = aux + a
    x = L.rms_norm(x, params["embed"]["norm_f"], cfg.norm_eps)
    logits = L.unembed(params["embed"], cfg, x)
    if return_aux:
        return logits, aux
    return logits


init_cache = T.init_cache   # same dense KV layout as the transformer


def prefill(cfg, params, tokens, *, capacity: Optional[int] = None,
            window_override: Optional[int] = None, q_chunk: int = 1024,
            capacity_factor: float = 1.25):
    """Run the prompt; returns (last-position logits (B, V), the dense
    cache of the last ``capacity`` positions, padded, and pos = S)."""
    x = L.embed(params["embed"], tokens)
    b, s, _ = x.shape
    capacity = capacity or (cfg.sliding_window or s)
    positions = _positions(b, s, x.device)
    window = window_override if window_override is not None \
        else cfg.sliding_window
    q_chunk = min(q_chunk, s)
    keep = min(capacity, s)
    # the config's KV storage dtype (f32 comparisons rely on the cache
    # not rounding to bf16)
    kdt = L.kv_cache_dtype(cfg)
    ks, vs = [], []
    for i in range(cfg.n_layers):
        x, _, (k, v) = _block(cfg, layer_params(params["layers"], i), x,
                              positions, window=window, q_chunk=q_chunk,
                              capacity_factor=capacity_factor)
        ks.append(T._pad_seq(k[:, s - keep:].to(kdt), capacity - keep))
        vs.append(T._pad_seq(v[:, s - keep:].to(kdt), capacity - keep))
    x = L.rms_norm(x, params["embed"]["norm_f"], cfg.norm_eps)
    logits = L.unembed(params["embed"], cfg, x[:, -1:])
    return logits[:, 0], {"k": torch.stack(ks), "v": torch.stack(vs)}, s


def decode_step(cfg, params, token, cache, pos, *, window: int = 0):
    """One decode step for a batch at one position ``pos`` (an int or a
    0-d tensor); a ring-buffer cache when ``window`` > 0 (mixtral's SWA).
    Returns (logits (B, V), the new cache)."""
    x = L.embed(params["embed"], token[:, None])
    b = x.shape[0]
    cap = cache["k"].shape[2]
    pos = torch.as_tensor(pos, dtype=torch.int32, device=x.device)
    slot = pos % cap if window else pos
    kv_len = torch.clamp(pos + 1, max=cap)
    positions = pos.expand(b, 1)
    new = {"k": [], "v": []}
    for i in range(cfg.n_layers):
        p = layer_params(params["layers"], i)
        h = L.rms_norm(x, p["norm_attn"], cfg.norm_eps)
        q, k, v = L.qkv_proj(p["attn"], cfg, h, positions)
        ck = L.kv_cache_update(cache["k"][i], k, slot)
        cv = L.kv_cache_update(cache["v"][i], v, slot)
        o = L.attention(q, ck, cv, causal=False, kv_len=kv_len)
        x = x + L.attn_out(p["attn"], o)
        h = L.rms_norm(x, p["norm_mlp"], cfg.norm_eps)
        # the paged serving loop's routing: drop-free by default
        x = x + decode_mlp(cfg, p, h)
        new["k"].append(ck)
        new["v"].append(cv)
    x = L.rms_norm(x, params["embed"]["norm_f"], cfg.norm_eps)
    logits = L.unembed(params["embed"], cfg, x)
    return logits[:, 0], {name: torch.stack(rows)
                          for name, rows in new.items()}
