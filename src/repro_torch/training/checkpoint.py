"""Checkpoint save / restore in the reference's on-disk format: a
``manifest.json`` and one ``.npy`` per leaf, under the flat key
``'/'.join(path)`` (list indices as "0", "1", ...; a NamedTuple field as
".name"). A bfloat16 leaf is stored as a uint16 view and named "bfloat16"
in the manifest; its bits are reinterpreted through int16 on the way back,
so no value is rounded. Checkpoints cross between the two packages both
ways."""
from __future__ import annotations

import json
import os
from typing import Any, Tuple

import numpy as np
import torch

from repro_torch.training.tree import leaves_with_paths, unflatten


def _to_numpy(t: torch.Tensor):
    """(array to save, manifest dtype name)."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    arr = t.numpy()
    return arr, str(arr.dtype)


def save(path: str, tree, step: int = 0):
    os.makedirs(path, exist_ok=True)
    manifest = {"step": int(step), "arrays": {}}
    for key_path, leaf in leaves_with_paths(tree):
        key = "/".join(key_path)
        arr, dtype = _to_numpy(leaf)
        fname = key.replace("/", "__") + ".npy"
        np.save(os.path.join(path, fname), arr)
        manifest["arrays"][key] = {"file": fname, "shape": list(arr.shape),
                                   "dtype": dtype}
    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)


def _load(path: str, meta) -> torch.Tensor:
    arr = np.load(os.path.join(path, meta["file"]))
    if meta["dtype"] == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def restore(path: str, like) -> Tuple[Any, int]:
    """Restore into the structure of ``like``: every leaf's shape is
    checked, and it comes back on ``like``'s device, in its dtype. Returns
    (tree, step)."""
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    out = []
    for key_path, leaf in leaves_with_paths(like):
        key = "/".join(key_path)
        t = _load(path, manifest["arrays"][key])
        assert tuple(t.shape) == tuple(leaf.shape), \
            f"{key}: ckpt {tuple(t.shape)} != model {tuple(leaf.shape)}"
        out.append(t.to(device=leaf.device, dtype=leaf.dtype))
    return unflatten(like, out), manifest["step"]
