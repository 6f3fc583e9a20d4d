"""Meta-tensor stand-ins for every model input and state: the dry run lays
these out on a mesh and runs the step on fake tensors of their per-device
shapes, allocating nothing. Shapes and dtypes are the reference's."""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.models import api, vlm
from repro_torch.training.optimizer import OptState
from repro_torch.training.tree import leaves, unflatten

META = "meta"


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device=META)


def params_struct(cfg: ModelConfig):
    """The family's params tree, as meta tensors."""
    return api.init_params(cfg, None, device=META)


def opt_state_struct(params_shape) -> OptState:
    """AdamW's state for ``params_shape``: an int32 step and f32 m, v."""
    def f32():
        return unflatten(params_shape, [_meta(p.shape, torch.float32)
                                        for p in leaves(params_shape)])
    return OptState(_meta((), torch.int32), f32(), f32())


def input_specs(cfg: ModelConfig, shape: InputShape) -> Dict[str, Any]:
    """Model inputs for one canonical shape (train batch | prefill prompt |
    decode token + state). The frontend stubs deliver precomputed
    embeddings."""
    B, S = shape.global_batch, shape.seq_len
    if shape.kind in ("train", "prefill") and cfg.arch_type == "audio":
        batch = {"frame_embeds": _meta((B, S, cfg.d_model), torch.bfloat16)}
        if shape.kind == "train":
            batch["targets"] = _meta((B, S), torch.int32)
            batch["mask"] = _meta((B, S), torch.bool)
        return batch
    if shape.kind in ("train", "prefill"):
        n = S + 1 if shape.kind == "train" else S
        batch = {"tokens": _meta((B, n), torch.int32)}
        if cfg.arch_type == "vlm":
            batch["patch_embeds"] = _meta((B, vlm.N_PATCHES, cfg.d_model),
                                          torch.bfloat16)
        return batch
    # decode: ONE new token against a cache of seq_len context
    return {"token": _meta((B,), torch.int32),
            "cache": api.init_cache(cfg, B, S, device=META),
            "pos": _meta((), torch.int32)}
