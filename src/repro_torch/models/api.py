"""Unified model API: dispatch by ``cfg.arch_type``.

Every family exposes:
  init_params(cfg, generator, device)  -> params (layer-stacked)
  forward(cfg, params, **inputs)       -> logits (the train path)
  init_cache(cfg, batch, capacity)     -> decode state (KV / recurrent / None)
  prefill(cfg, params, **inputs)       -> (last logits, cache, pos)
  decode_step(cfg, params, token, cache, pos) -> (logits, cache)
and ``loss(cfg, params, batch)`` is the scalar train loss of any family.

The families: dense (Llama, Qwen, Yi, DeepSeek), MoE (Mixtral, DBRX), SSM
(Mamba-2), hybrid (RecurrentGemma; its params keep one dict per layer in a
list, not layer-stacked), VLM (InternVL2) and audio (HuBERT, encoder-only:
no cache and no decode).

``decode_capacity(cfg, seq_len)`` centralizes the long-context policy:
ring-buffer window for SWA / long-context dense variants, full-length cache
otherwise.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

from repro_torch.configs.base import ModelConfig
from repro_torch.models import encoder, hybrid, moe, ssm, transformer, vlm
from repro_torch.models import layers as L

_FAMILIES = {
    "dense": transformer,
    "moe": moe,
    "ssm": ssm,
    "hybrid": hybrid,
    "vlm": vlm,
    "audio": encoder,
}


def family(cfg: ModelConfig):
    return _FAMILIES[cfg.arch_type]


def init_params(cfg: ModelConfig, generator, device="cuda", dtype=None):
    """Random params of any family from ``generator`` (which must live on
    ``device``)."""
    return family(cfg).init_params(cfg, generator, device=device,
                                   dtype=dtype)


def forward(cfg: ModelConfig, params, tokens, **kw):
    return family(cfg).forward(cfg, params, tokens, **kw)


# --------------------------------------------------------------------------
# decode window / capacity policy
# --------------------------------------------------------------------------

def decode_window(cfg: ModelConfig, seq_len: int) -> int:
    """Effective ring-buffer window for decode at this context length.
    0 = full cache (no ring)."""
    if cfg.arch_type == "ssm":
        return 0                      # recurrent state; no KV at all
    if cfg.sliding_window:
        return cfg.sliding_window     # native SWA (mixtral, rg local attn)
    if cfg.long_context_window and seq_len > 65_536:
        return cfg.long_context_window  # dense long-context variant
    return 0


def decode_capacity(cfg: ModelConfig, seq_len: int) -> int:
    w = decode_window(cfg, seq_len)
    return w if w else seq_len


def init_cache(cfg: ModelConfig, batch: int, seq_len: int, device="cuda"):
    if not cfg.has_decode:
        return None
    return family(cfg).init_cache(cfg, batch, decode_capacity(cfg, seq_len),
                                  device=device)


# --------------------------------------------------------------------------
# train loss
# --------------------------------------------------------------------------

def next_token_loss(cfg, params, tokens, q_chunk: int = 1024):
    """Causal LM loss over (B, S) tokens (inputs = tokens[:, :-1]); the MoE
    family adds its load-balance aux loss."""
    mod = family(cfg)
    if cfg.arch_type == "moe":
        logits, aux = mod.forward(cfg, params, tokens[:, :-1],
                                  q_chunk=q_chunk, return_aux=True)
    else:
        logits = mod.forward(cfg, params, tokens[:, :-1], q_chunk=q_chunk)
        aux = 0.0
    return L.token_nll(logits, tokens[:, 1:]).mean() + aux


def loss(cfg: ModelConfig, params, batch: Dict[str, Any],
         q_chunk: int = 1024):
    """batch keys by family:
      dense/moe/ssm/hybrid: tokens (B,S)
      vlm:   tokens (B,S_txt), patch_embeds (B,P,d)
      audio: frame_embeds (B,S,d), targets (B,S), mask (B,S)
    """
    if cfg.arch_type == "audio":
        return encoder.masked_unit_loss(cfg, params, batch["frame_embeds"],
                                        batch["targets"], batch["mask"])
    if cfg.arch_type == "vlm":
        patches = batch.get("patch_embeds")
        logits = vlm.forward(cfg, params, batch["tokens"], patches,
                             q_chunk=q_chunk)
        npatch = 0 if patches is None else patches.shape[1]
        # predict text tokens only (shift within the text segment)
        text_logits = logits[:, npatch:-1] if npatch else logits[:, :-1]
        return L.token_nll(text_logits, batch["tokens"][:, 1:]).mean()
    return next_token_loss(cfg, params, batch["tokens"], q_chunk=q_chunk)


# --------------------------------------------------------------------------
# prefill / decode
# --------------------------------------------------------------------------

def prefill(cfg: ModelConfig, params, batch: Dict[str, Any],
            seq_budget: Optional[int] = None, q_chunk: int = 1024):
    """Returns (last-token logits, cache, pos). ``batch["tokens"]``: (B, S)
    integer tensor (and ``patch_embeds`` for the VLM)."""
    mod = family(cfg)
    if cfg.arch_type == "audio":
        raise ValueError("encoder-only arch has no prefill/decode")
    if cfg.arch_type == "ssm":
        return mod.prefill(cfg, params, batch["tokens"], chunk=cfg.ssm_chunk)
    s = batch["tokens"].shape[1]
    total = seq_budget or s
    window = decode_window(cfg, total)
    cap = window if window else total
    if cfg.arch_type == "vlm":
        return mod.prefill(cfg, params, batch["tokens"],
                           batch.get("patch_embeds"), capacity=cap,
                           q_chunk=q_chunk)
    if cfg.arch_type == "hybrid":
        return mod.prefill(cfg, params, batch["tokens"],
                           capacity=cap if cfg.sliding_window else 0,
                           q_chunk=q_chunk)
    # dense / moe: a long-context window overrides full attention; a
    # native sliding window is the model's own
    wo = window if (window and not cfg.sliding_window) else None
    return mod.prefill(cfg, params, batch["tokens"], capacity=cap,
                       window_override=wo, q_chunk=q_chunk)


def decode_step(cfg: ModelConfig, params, token, cache, pos, seq_len: int):
    mod = family(cfg)
    if cfg.arch_type in ("ssm", "hybrid"):
        return mod.decode_step(cfg, params, token, cache, pos)
    return mod.decode_step(cfg, params, token, cache, pos,
                           window=decode_window(cfg, seq_len))
