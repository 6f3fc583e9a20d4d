"""Unified model API: dispatch by ``cfg.arch_type``.

Every family the port brings exposes:
  init_params(cfg, generator, device)  -> params (layer-stacked)
  forward(cfg, params, tokens)         -> logits
  init_cache(cfg, batch, capacity)     -> decode state
  prefill(cfg, params, tokens)         -> (last logits, cache, pos)
  decode_step(cfg, params, token, cache, pos) -> (logits, cache)

So far that is the SSM family (Mamba-2). The dense family is served through
the paged engine (``serving/engine.py``); its non-paged model API, like the
other families', is still to port and raises ``NotImplementedError`` naming
its ROADMAP.md item. ``loss`` and ``next_token_loss`` come with training.

``decode_capacity(cfg, seq_len)`` centralizes the long-context policy:
ring-buffer window for SWA / long-context dense variants, full-length cache
otherwise.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

from repro_torch.configs.base import ModelConfig
from repro_torch.models import ssm

_FAMILIES = {"ssm": ssm}

# families whose model API is still to port -> the ROADMAP.md item
_TO_PORT = {
    "dense": "Queue 1 item 13 (the non-paged dense model API)",
    "moe": "Queue 1 item 10 (models/moe.py)",
    "hybrid": "Queue 1 item 11 (models/hybrid.py)",
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
# prefill / decode
# --------------------------------------------------------------------------

def prefill(cfg: ModelConfig, params, batch: Dict[str, Any],
            seq_budget: Optional[int] = None, q_chunk: int = 1024):
    """Returns (last-token logits, cache, pos). ``batch["tokens"]``: (B, S)
    integer tensor."""
    mod = family(cfg)                   # the ssm family, so far
    return mod.prefill(cfg, params, batch["tokens"], chunk=cfg.ssm_chunk)


def decode_step(cfg: ModelConfig, params, token, cache, pos, seq_len: int):
    mod = family(cfg)                   # the ssm family, so far
    return mod.decode_step(cfg, params, token, cache, pos)
