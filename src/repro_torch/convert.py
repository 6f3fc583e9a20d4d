"""Reference params -> torch params, bit for bit.

``from_jax_numpy`` takes the reference's param pytree as nested dicts of
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
    """Nested dicts of numpy arrays -> nested dicts of torch tensors on
    ``device``, bit-exact (layer-stacked leaves keep their leading L axis)."""
    if isinstance(tree, dict):
        return {k: from_jax_numpy(v, device) for k, v in tree.items()}
    return _leaf(tree, device)
