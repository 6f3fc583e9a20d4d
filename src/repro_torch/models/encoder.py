"""HuBERT-style encoder-only audio transformer [arXiv:2106.07447].

The conv feature extractor is stubbed, as in the reference: the caller
hands in precomputed frame embeddings (B, S, d). The backbone is the
transformer stack run bidirectionally (no causal mask, no KV cache, no
decode step).
"""
from __future__ import annotations

import torch

from repro_torch.models import layers as L
from repro_torch.models import transformer as T


def init_params(cfg, generator: torch.Generator, device="cuda", dtype=None):
    assert cfg.is_encoder_only
    return T.init_params(cfg, generator, device=device, dtype=dtype)


def forward(cfg, params, frame_embeds, *, q_chunk: int = 1024, **_):
    """frame_embeds: (B, S, d) frontend output -> unit logits (B, S, V)."""
    return T.forward(cfg, params, tokens=None, inputs_embeds=frame_embeds,
                     q_chunk=q_chunk)


def masked_unit_loss(cfg, params, frame_embeds, targets, mask):
    """HuBERT objective: predict hidden units at masked frames.

    targets: (B, S) integer unit ids; mask: (B, S) bool (True = masked
    frame, where the loss is taken, as in the paper)."""
    logits = forward(cfg, params, frame_embeds)
    nll = L.token_nll(logits, targets)
    denom = torch.clamp(mask.sum(), min=1)
    return (nll * mask).sum() / denom
