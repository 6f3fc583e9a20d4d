"""DTensor layout helpers for the model's mesh paths (the dry run lays
params and inputs out as DTensors on a production mesh; ``launch/dryrun.py``).

They make explicit the redistributions that GSPMD makes by itself in the
reference: ``use_weight`` gathers a weight's data-axes split where a product
uses it (the FSDP half of the baseline layout), ``contract_ready`` brings
the activation to the batch-over-data layout a product takes,
``split_ready`` replicates a dim that is about to be split into a leading
factor its mesh axes do not divide (40 heads over a 16-way model axis), and
``on_shards`` runs a computation that is independent along its split dims
on each device's local tensors. ``shard_hints`` sets the dry run's knobs.
On plain tensors every helper returns its input.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

# the dry run's knobs (set through ``shard_hints``): the mesh axis that the
# decode K/V's sequence dim and the scores over it stay split on (without
# it the redistribution that the heads-sharded q asks for gathers the whole
# cache on every layer), and the mesh axes that split the batch (every axis
# under the ``pure_dp`` profile: the model axis holds no weights there)
SEQ_SHARD_AXIS: Optional[str] = None
BATCH_AXES: tuple = ("pod", "data")


class shard_hints:
    """Context manager: ``with shard_hints("model"): ...`` pins attention's
    K/V sequence dim to the model axis (``None``: no hint);
    ``batch_axes``: the axes the batch splits over."""

    def __init__(self, seq_axis: Optional[str],
                 batch_axes: tuple = ("pod", "data")):
        self.knobs = (seq_axis, tuple(batch_axes))

    def __enter__(self):
        global SEQ_SHARD_AXIS, BATCH_AXES
        self._old = (SEQ_SHARD_AXIS, BATCH_AXES)
        SEQ_SHARD_AXIS, BATCH_AXES = self.knobs

    def __exit__(self, *exc):
        global SEQ_SHARD_AXIS, BATCH_AXES
        SEQ_SHARD_AXIS, BATCH_AXES = self._old


def is_dtensor(x) -> bool:
    if type(x) is torch.Tensor:
        return False
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def shard_ways(x, dim: int) -> int:
    """How many ways DTensor ``x``'s dim ``dim`` is split (1: whole)."""
    ways = 1
    for i, pl in enumerate(x.placements):
        if pl.is_shard(dim % x.ndim):
            ways *= x.device_mesh.size(i)
    return ways


def replicate_dim(x, dim: int):
    """DTensor ``x`` with dim ``dim`` whole on every mesh axis (an
    all-gather where it was split)."""
    from torch.distributed.tensor import Replicate
    pls = [Replicate() if pl.is_shard(dim % x.ndim) else pl
           for pl in x.placements]
    return x.redistribute(x.device_mesh, pls)


def use_weight(w):
    """A weight as a product uses it: on a DTensor, its split over the data
    axes ("pod", "data") gathered and its model-axis split kept."""
    if not is_dtensor(w):
        return w
    from torch.distributed.tensor import Replicate
    names = w.device_mesh.mesh_dim_names
    pls = tuple(Replicate() if names[i] in ("pod", "data") else pl
                for i, pl in enumerate(w.placements))
    return w if pls == tuple(w.placements) else w.redistribute(
        w.device_mesh, pls)


def contract_ready(x, w):
    """``x`` and weight ``w`` as ``x @ w`` takes them: on DTensors, ``w`` as
    ``use_weight`` gives it and ``x`` with its leading (batch) dim over the
    data axes where they divide it and every other dim whole, so the
    product's output splits as ``w``'s columns do (every weight's last dim
    is its model-axis split: the activations are gathered, not the
    weights). Plain tensors are returned as they are."""
    if not is_dtensor(w):
        return x, w
    pls = mesh_placements(x.device_mesh, x.ndim, data=(0, x.shape[0]))
    if tuple(pls) != tuple(x.placements):
        x = x.redistribute(x.device_mesh, pls)
    return local_contiguous(x), use_weight(w)


def local_contiguous(x):
    """DTensor ``x`` with a contiguous local shard (``contiguous()`` reads
    the global strides and can leave a strided shard as it is: an uneven
    split's padding sliced off). A product's flattening views it."""
    from torch.distributed.tensor import DTensor
    local = x.to_local()
    if local.is_contiguous():
        return x
    return DTensor.from_local(local.contiguous(), x.device_mesh,
                              x.placements, run_check=False, shape=x.shape,
                              stride=x.stride())


class _KeepGradLayout(torch.autograd.Function):
    """Identity whose backward lays the gradient out as the tensor is."""

    @staticmethod
    def forward(ctx, x):
        from torch.distributed.tensor import Replicate
        # a partial sum's gradient is whole on that axis
        ctx.placements = tuple(Replicate() if pl.is_partial() else pl
                               for pl in x.placements)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        if tuple(grad.placements) != ctx.placements:
            grad = grad.redistribute(grad.device_mesh, ctx.placements)
        return local_contiguous(grad)     # the backward's products view it


def keep_grad_layout(x):
    """``x``; on a DTensor, its gradient arrives in ``x``'s own layout (the
    backward's products then see the layout the forward's did). A plain
    tensor is returned as it is."""
    return _KeepGradLayout.apply(x) if is_dtensor(x) else x


def split_ready(x, dim: int, lead: int):
    """``x`` before its dim ``dim`` is reshaped into (``lead``, ...): on a
    DTensor whose mesh axes split that dim more ways than divide ``lead``,
    the dim is replicated first (a dim its axes do not divide is
    replicated: the spec rules' own fallback). A plain tensor is returned
    as it is."""
    if is_dtensor(x) and lead % shard_ways(x, dim):
        return replicate_dim(x, dim)
    return x


def mesh_placements(mesh, ndim: int, data=None, model=None) -> list:
    """Placements on ``mesh`` of a tensor whose ``data`` = (dim, size) is
    split over the batch axes (``BATCH_AXES``) when together they divide
    its size, and whose ``model`` = (dim, size) over the model axis likewise
    (unless the batch takes it); every other axis replicates."""
    from torch.distributed.tensor import Replicate, Shard
    names = mesh.mesh_dim_names
    out = [Replicate()] * mesh.ndim
    dp = [i for i, n in enumerate(names) if n in BATCH_AXES]
    if data and data[1] % math.prod(mesh.size(i) for i in dp) == 0:
        for i in dp:
            out[i] = Shard(data[0] % ndim)
    if model and "model" in names and "model" not in BATCH_AXES:
        i = names.index("model")
        if model[1] % mesh.size(i) == 0:
            out[i] = Shard(model[0] % ndim)
    return out


def on_shards(fn, mesh, out_placements, in_placements, grad_placements=None):
    """``fn`` run on each rank's local tensors of DTensor arguments laid out
    (redistributed first where they are not) as ``in_placements``; its
    outputs become DTensors of ``out_placements`` (a list of placements for
    one output, a tuple of such lists for several). For computations that
    are independent along the split dims (batch, heads, channels).
    ``grad_placements``: the layout of each argument's gradient, where it
    is not the argument's own (a replicated input that feeds split work
    gets partial gradients)."""
    from torch.distributed.tensor.experimental import local_map
    return local_map(fn, out_placements, in_placements, grad_placements,
                     device_mesh=mesh, redistribute_inputs=True)


def partial_on_model(mesh, placements) -> list:
    """``placements`` with the model axis ``Partial`` (sum), when the mesh
    has one."""
    from torch.distributed.tensor import Partial
    names = mesh.mesh_dim_names
    out = list(placements)
    if "model" in names:
        out[names.index("model")] = Partial()
    return out


def local_value(x):
    """A replicated DTensor's local tensor (a plain input as it is)."""
    return x.to_local() if is_dtensor(x) else x


class _SplitReadyGrad(torch.autograd.Function):
    """Identity whose backward applies ``split_ready`` to the gradient."""

    @staticmethod
    def forward(ctx, x, dim, lead):
        ctx.dim, ctx.lead = dim, lead
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        # the reshape's backward views the gradient
        return local_contiguous(split_ready(grad, ctx.dim, ctx.lead)), None, \
            None


def grad_split_ready(x, dim: int, lead: int):
    """``x``, the result of merging dims into its dim ``dim``, whose
    gradient the backward splits back into (``lead``, ...): on a DTensor
    that gradient gets ``split_ready`` first. A plain tensor is returned as
    it is."""
    if not is_dtensor(x):
        return x
    return _SplitReadyGrad.apply(x, dim, lead)
