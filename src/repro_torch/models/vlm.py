"""InternVL2-style VLM backbone [arXiv:2404.16821].

The InternViT vision encoder and MLP projector are stubbed, as in the
reference: the caller hands in projected patch embeddings (B, n_patches,
d_model). The language decoder takes [patch embeds ; token embeds] and is
the dense GQA transformer, so decode is the dense family's (the image
lives in the KV cache after prefill).
"""
from __future__ import annotations

import torch

from repro_torch.models import layers as L
from repro_torch.models import transformer as T

N_PATCHES = 256   # one 448x448 tile through the stubbed projector


def init_params(cfg, generator: torch.Generator, device="cuda", dtype=None):
    return T.init_params(cfg, generator, device=device, dtype=dtype)


def _inputs(params, tokens, patch_embeds):
    tok_embeds = L.embed(params["embed"], tokens)
    if patch_embeds is None:
        return tok_embeds
    return torch.cat([patch_embeds.to(tok_embeds.dtype), tok_embeds], dim=1)


def forward(cfg, params, tokens, patch_embeds=None, *, window_override=None,
            q_chunk: int = 1024, **_):
    """tokens: (B, S_txt); patch_embeds: (B, P, d) or None. Returns logits
    over the FULL (patch + text) sequence."""
    return T.forward(cfg, params, tokens=None,
                     inputs_embeds=_inputs(params, tokens, patch_embeds),
                     window_override=window_override, q_chunk=q_chunk)


init_cache = T.init_cache


def prefill(cfg, params, tokens, patch_embeds=None, *, capacity=None,
            window_override=None, q_chunk: int = 1024, **_):
    return T.prefill(cfg, params,
                     inputs_embeds=_inputs(params, tokens, patch_embeds),
                     capacity=capacity, window_override=window_override,
                     q_chunk=q_chunk)


decode_step = T.decode_step
