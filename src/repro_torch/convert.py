"""Reference params -> torch params, bit for bit.

``from_jax_numpy`` takes the reference's param pytree as nested dicts (and
lists or tuples: the hybrid family keeps one dict per layer in a list) of
NUMPY arrays (the caller runs ``np.asarray`` on each leaf on the JAX side)
and returns the same structure as torch tensors. A bfloat16 leaf arrives as
an ``ml_dtypes.bfloat16`` array, which ``torch.from_numpy`` rejects; its
bits are reinterpreted through int16 instead, so no value is rounded.
"""
from __future__ import annotations

import numpy as np
import torch


def _leaf(arr, device) -> torch.Tensor:
    arr = np.array(arr, order="C", copy=True)   # owned, writable, contiguous
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(device)


def from_jax_numpy(tree, device="cuda"):
    """Nested dicts, lists and tuples of numpy arrays -> the same structure
    of torch tensors on ``device``, bit-exact (layer-stacked leaves keep
    their leading L axis; a list or tuple keeps its order and its type)."""
    if isinstance(tree, dict):
        return {k: from_jax_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(from_jax_numpy(v, device) for v in tree)
    return _leaf(tree, device)
