"""Divisibility-aware sharding rules for params and decode caches, and the
degraded layout a shard loss leaves — in plain Python over shapes.

A mesh is a dict from axis name to size (``{"data": 1, "model": 4}``); a
spec is a tuple with one entry per tensor dim: an axis name, a tuple of
axis names, or ``None`` (replicated along that dim). A tree is nested dicts
whose leaves carry ``.shape`` and ``.dtype`` (torch tensors, meta tensors
included, or ``Leaf``); a path is the tuple of dict keys down to a leaf.

The rules are the reference package's, so a summary computed here equals
its summary for the same shapes:

  * weights (2D+): last dim -> "model" when divisible; under the
    ``baseline`` profile also a leading non-layer dim -> "data". The
    stacked layer axis (every leaf under ``"layers"``) is never sharded.
    Fallback = replicate the offending dim.
  * decode caches: dense k/v (L, B, C, K, D) and int8 scales (L, B, C, K,
    1) -> (None, data, model@C, None, None); ssm and hybrid states by
    width.

A shard-granularity fault removes one slice of the model axis. The serving
layer re-lays every tensor over the SURVIVING model-axis size: specs are
recomputed against a mesh whose model axis shrank, and a dim the smaller
axis no longer divides falls back to replication.
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.models import api
from repro_torch.models import layers as L

PROFILES = ("baseline", "serve_model_only", "expert_parallel", "pure_dp")

Mesh = Dict[str, int]
Spec = Tuple


class Leaf(NamedTuple):
    """A tensor's shape and dtype, for trees that are never allocated."""
    shape: Tuple[int, ...]
    dtype: torch.dtype


def mesh(n_shards: int, n_data: int = 1) -> Mesh:
    """The one-instance serving mesh: ``n_shards`` model shards."""
    return {"data": n_data, "model": n_shards}


def data_axes(m: Mesh) -> Tuple[str, ...]:
    return tuple(a for a in m if a in ("pod", "data"))


def _norm_axes(axes):
    """Collapse 1-tuples to the bare axis name (canonical spec entries)."""
    if not axes:
        return None
    if isinstance(axes, tuple) and len(axes) == 1:
        return axes[0]
    return axes


def axis_size(m: Mesh, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    return math.prod(m[a] for a in axes)


def _div(dim: int, m: Mesh, axes) -> bool:
    return dim % axis_size(m, axes) == 0


# --------------------------------------------------------------------------
# parameter specs
# --------------------------------------------------------------------------

def param_spec(path: Tuple[str, ...], shape: Tuple[int, ...], m: Mesh,
               stacked_layers: bool, profile: str = "baseline") -> Spec:
    """Spec for one parameter tensor. ``stacked_layers``: the leading dim
    is the layer axis (never sharded).

    Profiles:
      baseline         — last dim -> model, an earlier dim -> data.
      serve_model_only — weights sharded over model only (the engine's).
      expert_parallel  — MoE expert stacks (L, E, d, f): E -> model; other
                         weights follow serve_model_only, with the
                         baseline rules when E does not divide.
      pure_dp          — everything replicated.
    """
    nd = len(shape)
    start = 1 if stacked_layers and nd >= 2 else 0
    dims = list(range(start, nd))
    spec: list = [None] * nd
    if not dims:
        return ()
    if profile == "pure_dp":
        return tuple(spec)
    if profile == "expert_parallel" and "experts" in path and \
            nd - start == 3:
        e_dim, d_dim = dims[0], dims[1]
        if _div(shape[e_dim], m, "model"):
            spec[e_dim] = "model"
            if _div(shape[d_dim], m, "data") and \
                    shape[d_dim] >= axis_size(m, "data"):
                spec[d_dim] = "data"
            return tuple(spec)
    last = dims[-1]
    if _div(shape[last], m, "model") and shape[last] >= axis_size(m, "model"):
        spec[last] = "model"
    if profile in ("serve_model_only", "expert_parallel"):
        return tuple(spec)
    for d in dims[:-1]:
        if spec[d] is None and _div(shape[d], m, "data") and \
                shape[d] >= axis_size(m, "data") and shape[d] > 8:
            spec[d] = "data"
            break
    # 1-D leftover: model on the last dim if unassigned, else replicate
    if spec[last] is None and nd - start == 1 and \
            _div(shape[last], m, "model") and \
            shape[last] >= 4 * axis_size(m, "model"):
        spec[last] = "model"
    return tuple(spec)


def _leaves(tree, path=()):
    """(path, leaf) over a nested dict, keys in sorted order."""
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _leaves(tree[key], path + (str(key),))
    else:
        yield path, tree


def params_specs(params_shape, m: Mesh, profile: str = "baseline"):
    """One spec per param leaf, in ``_leaves`` order."""
    return [param_spec(path, tuple(leaf.shape), m, "layers" in path, profile)
            for path, leaf in _leaves(params_shape)]


# --------------------------------------------------------------------------
# decode-cache specs
# --------------------------------------------------------------------------

def cache_spec(path: Tuple[str, ...], shape: Tuple[int, ...], m: Mesh,
               arch_type: str) -> Spec:
    """Spec for one decode-state leaf, per family:

      dense/moe/vlm: k/v (L,B,C,K,D), scales (L,B,C,K,1)
                       -> (None, data, model@C, None, None)
      ssm:           conv (L,B,W-1,Cdim) -> (None, data, None, model@Cdim)
                     ssm  (L,B,H,P,N)    -> (None, data, None, None, model@N)
      hybrid:        h (B,w) -> (data, model@w); conv (B,3,w) ->
                     (data, None, model@w); k/v (B,cap,K,D) ->
                     (data, model@cap, None, None)
    """
    dp = data_axes(m)

    def mdl(dim: int) -> Optional[str]:
        n = axis_size(m, "model")
        return "model" if dim % n == 0 and dim >= n else None

    name = path[-1] if path else ""
    if arch_type in ("dense", "moe", "vlm"):
        bspec = _norm_axes(dp) if _div(shape[1], m, dp) else None
        return (None, bspec, mdl(shape[2]), None, None)
    if arch_type == "ssm":
        bspec = _norm_axes(dp) if _div(shape[1], m, dp) else None
        if name == "conv":
            return (None, bspec, None, mdl(shape[3]))
        return (None, bspec, None, None, mdl(shape[4]))
    if arch_type == "hybrid":
        bspec = _norm_axes(dp) if _div(shape[0], m, dp) else None
        if name == "h":
            return (bspec, mdl(shape[1]))
        if name == "conv":
            return (bspec, None, mdl(shape[2]))
        return (bspec, mdl(shape[1]), None, None)
    return ()


def cache_specs(cache_shape, m: Mesh, arch_type: str):
    """One spec per cache leaf, in ``_leaves`` order."""
    return [cache_spec(path, tuple(leaf.shape), m, arch_type)
            for path, leaf in _leaves(cache_shape)]


def decode_cache_shape(cfg, batch: int, seq_len: int) -> Dict[str, Leaf]:
    """The dense decode cache's leaves for ``batch`` sequences of up to
    ``seq_len`` tokens: k/v (L, B, C, K, D) in the stored dtype (int8 on an
    int8-cache config), plus (L, B, C, K, 1) bf16 scales there. Shapes
    only: nothing is allocated."""
    cap = api.decode_capacity(cfg, seq_len)
    shape = (cfg.n_layers, batch, cap, cfg.n_kv_heads, cfg.head_dim)
    quant = cfg.kv_dtype == "int8"
    dtype = torch.int8 if quant else L.torch_dtype(cfg.kv_dtype)
    out = {"k": Leaf(shape, dtype), "v": Leaf(shape, dtype)}
    if quant:
        sshape = shape[:-1] + (1,)
        out["k_scale"] = Leaf(sshape, torch.bfloat16)
        out["v_scale"] = Leaf(sshape, torch.bfloat16)
    return out


# --------------------------------------------------------------------------
# degraded (shard-loss) specs
# --------------------------------------------------------------------------

def degraded_mesh(m: Mesh, lost_shards) -> Mesh:
    """``m`` with its model axis shrunk by the lost shard count. Raises if
    every shard is lost — that is instance death, not degradation."""
    size = m["model"] - len(set(lost_shards))
    if size < 1:
        raise ValueError(f"all {m['model']} model shards lost — no "
                         "surviving slice to degrade onto")
    return {**m, "model": size}


def degraded_spec(path: Tuple[str, ...], shape: Tuple[int, ...], m: Mesh,
                  lost_shards, stacked_layers: bool,
                  profile: str = "baseline") -> Spec:
    """``param_spec`` re-evaluated over the surviving model-axis slice."""
    return param_spec(path, shape, degraded_mesh(m, lost_shards),
                      stacked_layers, profile)


def _spec_uses_model(spec: Spec) -> bool:
    return any(axes == "model" or (isinstance(axes, tuple) and "model" in axes)
               for axes in spec)


def _shard_ways(spec: Spec, m: Mesh) -> int:
    ways = 1
    for axes in spec:
        if axes is not None:
            ways *= axis_size(m, axes)
    return ways


def degradation_summary(params_shape, m: Mesh, lost_shards,
                        profile: str = "serve_model_only",
                        cache_shape=None, arch_type: str = "") -> dict:
    """What degrading onto the surviving slice costs, as data: how many
    param / cache tensors stay model-sharded vs fall back to replication,
    and the per-shard bytes before and after (floor division per leaf).
    The engine computes this once per degrade and ``/health`` reports it
    as the instance's ``layout``."""
    surviving = degraded_mesh(m, lost_shards)

    def census(tree_shape, specs_fn, *args):
        full = specs_fn(tree_shape, m, *args)
        deg = specs_fn(tree_shape, surviving, *args)
        kept = dropped = bytes_full = bytes_deg = 0
        for (_, leaf), fsp, dsp in zip(_leaves(tree_shape), full, deg):
            nbytes = math.prod(leaf.shape) * leaf.dtype.itemsize
            if _spec_uses_model(dsp):
                kept += 1
            elif _spec_uses_model(fsp):
                dropped += 1
            bytes_full += nbytes // max(_shard_ways(fsp, m), 1)
            bytes_deg += nbytes // max(_shard_ways(dsp, surviving), 1)
        return kept, dropped, bytes_full, bytes_deg

    pk, pd, pbf, pbd = census(params_shape, params_specs, profile)
    out = {
        "n_shards": m["model"], "surviving": surviving["model"],
        "lost_shards": sorted(set(lost_shards)),
        "capacity_frac": surviving["model"] / m["model"],
        "params_model_sharded": pk,
        "params_replicate_fallback": pd,
        "param_bytes_per_shard_full": pbf,
        "param_bytes_per_shard_degraded": pbd,
    }
    if cache_shape is not None and arch_type:
        ck, cd, cbf, cbd = census(cache_shape, cache_specs, arch_type)
        out.update({
            "kv_model_sharded": ck, "kv_replicate_fallback": cd,
            "kv_bytes_per_shard_full": cbf,
            "kv_bytes_per_shard_degraded": cbd,
        })
    return out
