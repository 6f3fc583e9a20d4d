"""Per-device cost of one step, counted at the local ops as they run: the
counterpart of the reference's ``hlo_cost`` (which parses XLA's optimized
HLO), under the same keys as its ``aggregate``.

``CostMode`` is a dispatch mode. An op on DTensors is handed on to DTensor
(the mode returns ``NotImplemented`` for it), which runs it as ops on each
rank's local tensors, with the collectives its redistributions need; those
local ops come back through the mode and are the ones counted, so every
count is one device's. Ops that DTensor's sharding propagation runs to
infer global shapes are not the step's and are skipped: while the mode is
entered it wraps the propagator's shape-inference method to mark that
span. Plain tensors (a one-device run, real or fake) are counted as they
are.

  * ``flops``: 2 x output elements x contracted size for every matmul-family
    op (mm, addmm, bmm, baddbmm, mv, addmv, dot; ``linear``, ``matmul`` and
    ``einsum`` reach the mode as these), as ``hlo_cost`` counts ``dot``s.
    The add of addmm / baddbmm and every elementwise op count nothing.
  * ``bytes``: the eager model of HBM traffic. Every local op that moves
    data is charged the bytes of its tensor inputs plus its outputs (each
    at its element count, so an expanded input counts its full logical
    size); views, metadata ops, ``empty`` and collectives are free.
    ``hlo_cost`` charges traffic at fusion boundaries instead (a fusion's
    interior stays on chip, and a scan body's slice of a stacked buffer is
    charged the slice): eager PyTorch fuses nothing, so the same step moves
    more bytes here, by design.
  * ``coll_<kind>`` and ``coll_bytes``: the result bytes of each functional
    collective, per device, under the reference's kind names
    (``all_gather``, ``all_reduce``, ``reduce_scatter``, ``all_to_all``,
    ``collective_permute``).

There is no HLO and no trip count: Python loops over layers unroll, so each
layer's ops run, and count, once per layer.

The mode also tracks memory: the bytes of every storage that an op
allocates during the step, live until its last tensor dies, and their peak
(``peak_bytes``). Storages that existed before the step (params, optimizer
state, inputs) are not counted.
"""
from __future__ import annotations

import weakref
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

aten = torch.ops.aten

_MATMULS = {aten.mm.default, aten.addmm.default, aten.bmm.default,
            aten.baddbmm.default, aten.mv.default, aten.addmv.default,
            aten.dot.default, aten.vdot.default}

# ops that move no data: metadata, allocation without a fill, aliasing
_FREE = {"empty", "empty_like", "empty_strided", "new_empty",
         "new_empty_strided", "detach", "alias", "lift_fresh", "set_",
         "_local_scalar_dense", "resize_"}

# functional collective op name (substring) -> the reference's kind
_COLLECTIVE_KINDS = (("all_gather", "all_gather"),
                     ("reduce_scatter", "reduce_scatter"),
                     ("all_reduce", "all_reduce"),
                     ("all_to_all", "all_to_all"),
                     ("alltoall", "all_to_all"),
                     ("permute", "collective_permute"),
                     ("broadcast", "broadcast"))


def tensor_bytes(t) -> int:
    return t.numel() * t.element_size()


def _tensors(tree):
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def matmul_flops(func, args) -> int:
    """2 x output elements x contracted size of one matmul-family op."""
    if func in (aten.addmm.default, aten.baddbmm.default,
                aten.addmv.default):
        args = args[1:]
    a, b = args[0], args[1]
    if func in (aten.dot.default, aten.vdot.default):
        return 2 * a.shape[0]
    k = a.shape[-1]
    if func in (aten.mv.default, aten.addmv.default):
        return 2 * a.shape[0] * k
    return 2 * a.shape[:-1].numel() * k * b.shape[-1]


def collective_kind(func):
    """The reference's kind name of a functional collective, else None."""
    ns = func.namespace
    if not ns.startswith(("_c10d_functional", "c10d_functional",
                          "_dtensor")):
        return None
    name = func._opname
    if name == "wait_tensor":
        return None
    for part, kind in _COLLECTIVE_KINDS:
        if part in name:
            return kind
    return name


class _ShapeInference:
    """Marks DTensor's global-shape inference: wraps the sharding
    propagator's method that runs it (``_propagate_tensor_meta_non_cached``,
    or ``_propagate_tensor_meta`` in a torch without it) for as long as the
    mode is entered, and counts how deep inside it the thread is."""

    def __init__(self):
        self.depth = 0
        prop = _propagator()
        self.name = next(n for n in ("_propagate_tensor_meta_non_cached",
                                     "_propagate_tensor_meta")
                         if hasattr(prop, n))
        self.orig = getattr(prop, self.name)
        hook = self

        def wrapped(*args, **kwargs):
            hook.depth += 1
            try:
                return hook.orig(*args, **kwargs)
            finally:
                hook.depth -= 1
        setattr(prop, self.name, wrapped)

    def remove(self):
        setattr(_propagator(), self.name, self.orig)


def _dtensor_type():
    from torch.distributed.tensor import DTensor
    return DTensor


def _propagator():
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    return ShardingPropagator


class CostMode(TorchDispatchMode):
    """Counts one step's per-device flops, bytes and collective bytes, and
    tracks the peak of the bytes it allocates."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.coll: Dict[str, int] = {}
        self.live = 0
        self.peak_bytes = 0
        self._storages: Dict[int, int] = {}

    def __enter__(self):
        self._hook = _ShapeInference()
        return super().__enter__()

    def __exit__(self, *exc):
        self._hook.remove()
        return super().__exit__(*exc)

    def totals(self) -> Dict[str, float]:
        """``hlo_cost.aggregate``'s keys: flops, bytes, coll_bytes and one
        ``coll_<kind>`` per collective kind seen."""
        out = {"flops": float(self.flops), "bytes": float(self.bytes),
               "coll_bytes": float(sum(self.coll.values()))}
        out.update({f"coll_{k}": float(v) for k, v in self.coll.items()})
        return out

    def _release(self, key: int, nbytes: int):
        if self._storages.pop(key, None) is not None:
            self.live -= nbytes

    def _track(self, outs, ins):
        seen = {t.untyped_storage()._cdata for t in ins}
        for t in outs:
            st = t.untyped_storage()
            key = st._cdata
            if key in seen or key in self._storages:
                continue
            nbytes = st.nbytes()
            self._storages[key] = nbytes
            self.live += nbytes
            weakref.finalize(st, self._release, key, nbytes)
        self.peak_bytes = max(self.peak_bytes, self.live)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(t is _dtensor_type() for t in types):
            return NotImplemented
        ins = _tensors((args, kwargs))
        out = func(*args, **kwargs)
        outs = _tensors(out)
        if self._hook.depth:
            return out
        kind = collective_kind(func)
        if kind is not None:
            self.coll[kind] = self.coll.get(kind, 0) + sum(
                tensor_bytes(t) for t in outs)
        elif func in _MATMULS:
            self.flops += matmul_flops(func, args)
        if kind is None and outs and not func.is_view and \
                func._opname not in _FREE and \
                func.namespace not in ("prim", "_c10d_functional"):
            self.bytes += sum(tensor_bytes(t) for t in ins + outs)
        self._track(outs, ins)
        return out
