"""Unified model API: dispatch by ``cfg.arch_type``.

Every family the port brings exposes:
  init_params(cfg, generator, device)  -> params (layer-stacked)
  forward(cfg, params, tokens)         -> logits
  init_cache(cfg, batch, capacity)     -> decode state
  prefill(cfg, params, tokens)         -> (last logits, cache, pos)
  decode_step(cfg, params, token, cache, pos) -> (logits, cache)

So far those are the MoE family (Mixtral, DBRX), the SSM family (Mamba-2)
and the hybrid family (RecurrentGemma; its params keep one dict per layer
in a list, not layer-stacked). The dense family is served through the
paged engine (``serving/engine.py``) and ``init_params`` initialises it;
its non-paged model API, like the other families', is still to port and
raises
``NotImplementedError`` naming its ROADMAP.md item. ``loss`` and
``next_token_loss`` come with training.

``decode_capacity(cfg, seq_len)`` centralizes the long-context policy:
ring-buffer window for SWA / long-context dense variants, full-length cache
otherwise.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

from repro_torch.configs.base import ModelConfig
from repro_torch.models import hybrid, moe, ssm, transformer

_FAMILIES = {"moe": moe, "ssm": ssm, "hybrid": hybrid}

# families whose model API is still to port -> the ROADMAP.md item
_TO_PORT = {
    "dense": "Queue 1 item 13 (the non-paged dense model API)",
    "vlm": "Queue 1 item 13 (models/vlm.py)",
    "audio": "Queue 1 item 13 (models/encoder.py)",
}


def family(cfg: ModelConfig):
    if cfg.arch_type in _FAMILIES:
        return _FAMILIES[cfg.arch_type]
    raise NotImplementedError(
        f"the port's model API does not run the {cfg.arch_type!r} family "
        f"yet: ROADMAP.md {_TO_PORT[cfg.arch_type]}")


def init_params(cfg: ModelConfig, generator, device="cuda", dtype=None):
    """Random params of any family the port serves or runs (the dense
    family's init comes before its model API)."""
    mod = transformer if cfg.arch_type == "dense" else family(cfg)
    return mod.init_params(cfg, generator, device=device, dtype=dtype)


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
# prefill / decode
# --------------------------------------------------------------------------

def prefill(cfg: ModelConfig, params, batch: Dict[str, Any],
            seq_budget: Optional[int] = None, q_chunk: int = 1024):
    """Returns (last-token logits, cache, pos). ``batch["tokens"]``: (B, S)
    integer tensor."""
    mod = family(cfg)
    if cfg.arch_type == "ssm":
        return mod.prefill(cfg, params, batch["tokens"], chunk=cfg.ssm_chunk)
    s = batch["tokens"].shape[1]
    total = seq_budget or s
    window = decode_window(cfg, total)
    cap = window if window else total
    # dense / moe: a long-context window overrides full attention; a
    # native sliding window is the model's own
    wo = window if (window and not cfg.sliding_window) else None
    return mod.prefill(cfg, params, batch["tokens"], capacity=cap,
                       window_override=wo, q_chunk=q_chunk)


def decode_step(cfg: ModelConfig, params, token, cache, pos, seq_len: int):
    mod = family(cfg)
    if cfg.arch_type == "ssm":
        return mod.decode_step(cfg, params, token, cache, pos)
    return mod.decode_step(cfg, params, token, cache, pos,
                           window=decode_window(cfg, seq_len))
