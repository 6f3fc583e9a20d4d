"""Model architecture config: ``ModelConfig`` with its derived sizes and the
``reduced()`` variant the CPU tests run, and the canonical benchmark input
shapes with the policy of which (config, shape) pairs run.

Framework-free (a copy of the reference package's config dataclass), so the
same field values describe the same model in both packages.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

ARCH_TYPES = ("dense", "moe", "ssm", "hybrid", "vlm", "audio")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture hyper-parameters for every model family in the zoo."""

    name: str
    arch_type: str                      # one of ARCH_TYPES
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                   # 0 -> d_model // n_heads
    qkv_bias: bool = False              # Qwen-style QKV bias

    # --- MoE -------------------------------------------------------------
    n_experts: int = 0
    top_k: int = 0
    router_aux_coef: float = 0.01       # load-balance loss coefficient

    # --- SSM (Mamba-2 / SSD) ----------------------------------------------
    ssm_state: int = 0                  # N: state dim per head
    ssm_head_dim: int = 64              # P: channels per SSD head
    ssm_expand: int = 2                 # d_inner = expand * d_model
    ssm_conv: int = 4                   # depthwise conv width
    ssm_chunk: int = 256                # SSD chunk length

    # --- hybrid (RecurrentGemma) -------------------------------------------
    # pattern of block kinds repeated over depth, e.g. ("rglru","rglru","attn")
    block_pattern: Tuple[str, ...] = ()
    lru_width: int = 0                  # RG-LRU recurrence width (0 -> d_model)

    # --- attention windows ---------------------------------------------------
    sliding_window: int = 0             # native SWA (mixtral / rg local attn)
    long_context_window: int = 0        # window enabled only for long_500k runs
                                        # on otherwise-full-attention archs

    # --- serving ---------------------------------------------------------
    kv_dtype: str = "bfloat16"          # "bfloat16" | "int8" (quantized cache)
    page_size: int = 16                 # paged-KV block size (tokens/block)

    # --- modality frontends (STUBBED per assignment) ----------------------
    frontend: Optional[str] = None      # None | "vision" | "audio"
    frontend_dim: int = 0               # embedding dim delivered by the stub
    is_encoder_only: bool = False

    # --- misc -------------------------------------------------------------
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    source: str = ""                    # citation for the config

    def __post_init__(self):
        if self.arch_type not in ARCH_TYPES:
            raise ValueError(f"unknown arch_type {self.arch_type!r}")
        if self.head_dim == 0 and self.n_heads:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        if self.arch_type == "hybrid" and self.lru_width == 0:
            object.__setattr__(self, "lru_width", self.d_model)

    # -- derived -----------------------------------------------------------
    @property
    def q_per_kv(self) -> int:
        return self.n_heads // max(self.n_kv_heads, 1)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_n_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def has_kv_cache(self) -> bool:
        """Does decode carry a paged KV cache (vs recurrent state / nothing)?"""
        return self.arch_type in ("dense", "moe", "vlm", "hybrid") and not self.is_encoder_only

    @property
    def has_decode(self) -> bool:
        return not self.is_encoder_only

    def layer_kinds(self) -> Tuple[str, ...]:
        """Per-layer block kind across depth."""
        if self.arch_type == "hybrid" and self.block_pattern:
            pat = self.block_pattern
            return tuple(pat[i % len(pat)] for i in range(self.n_layers))
        if self.arch_type == "ssm":
            return ("ssd",) * self.n_layers
        if self.arch_type == "moe":
            return ("moe",) * self.n_layers
        return ("attn",) * self.n_layers

    def n_params(self) -> int:
        """Approximate parameter count (embeddings + blocks), for roofline."""
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        hd = self.head_dim
        emb = v * d * (1 if self.tie_embeddings else 2)
        total = emb
        for kind in self.layer_kinds():
            if kind in ("attn", "moe"):
                attn = d * (self.n_heads * hd) + 2 * d * (self.n_kv_heads * hd) \
                       + (self.n_heads * hd) * d
                if kind == "moe":
                    mlp = self.n_experts * 3 * d * f + d * self.n_experts
                else:
                    mlp = 3 * d * f
                total += attn + mlp + 2 * d
            elif kind == "ssd":
                di = self.d_inner
                nh = self.ssm_n_heads
                total += d * (2 * di + 2 * self.ssm_state + nh) + di * d + 2 * d
            elif kind == "rglru":
                w = self.lru_width
                total += 2 * d * w + w * d + 4 * w + 2 * d
        return total

    def n_active_params(self) -> int:
        """Params touched per token (MoE uses top_k of n_experts)."""
        if self.arch_type != "moe":
            return self.n_params()
        d, f = self.d_model, self.d_ff
        dense_share = self.n_params() - self.n_layers * self.n_experts * 3 * d * f
        return dense_share + self.n_layers * self.top_k * 3 * d * f

    # -- reduced variant for CPU smoke tests -------------------------------
    def reduced(self) -> "ModelConfig":
        """Same family, toy size: <=2 layers, d_model<=512, <=4 experts."""
        d_model = min(self.d_model, 256)
        n_heads = min(self.n_heads, 4)
        head_dim = d_model // n_heads if n_heads else 0
        n_kv = max(1, min(self.n_kv_heads, n_heads))
        # keep GQA ratio roughly: MQA stays MQA, MHA stays MHA
        if self.n_kv_heads == self.n_heads:
            n_kv = n_heads
        elif self.n_kv_heads == 1:
            n_kv = 1
        else:
            n_kv = max(1, n_heads // 2)
        pattern = self.block_pattern
        n_layers = 2 if not pattern else max(2, len(pattern))
        return dataclasses.replace(
            self,
            name=self.name + "-reduced",
            n_layers=n_layers,
            d_model=d_model,
            n_heads=n_heads,
            n_kv_heads=n_kv,
            head_dim=head_dim,
            d_ff=min(self.d_ff, 512) or self.d_ff,
            vocab_size=min(self.vocab_size, 1024),
            n_experts=min(self.n_experts, 4) if self.n_experts else 0,
            top_k=min(self.top_k, 2) if self.top_k else 0,
            ssm_state=min(self.ssm_state, 32) if self.ssm_state else 0,
            ssm_head_dim=32 if self.ssm_state else self.ssm_head_dim,
            ssm_chunk=32 if self.ssm_state else self.ssm_chunk,
            lru_width=min(self.lru_width, d_model) if self.lru_width else 0,
            sliding_window=min(self.sliding_window, 64) if self.sliding_window else 0,
            long_context_window=min(self.long_context_window, 64)
            if self.long_context_window else 0,
            frontend_dim=min(self.frontend_dim, 256) if self.frontend_dim else 0,
            page_size=8,
        )


@dataclasses.dataclass(frozen=True)
class InputShape:
    """Canonical benchmark input shape."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


INPUT_SHAPES: Dict[str, InputShape] = {
    "train_4k":    InputShape("train_4k",    4_096,   256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768,  32,  "prefill"),
    "decode_32k":  InputShape("decode_32k",  32_768,  128, "decode"),
    "long_500k":   InputShape("long_500k",   524_288, 1,   "decode"),
}


def shape_applicable(cfg: ModelConfig, shape: InputShape) -> Tuple[bool, str]:
    """Which (config x shape) pairs run: no decode shape for an encoder,
    and 500k-token decode only with a window or a recurrent state."""
    if cfg.is_encoder_only and shape.kind == "decode":
        return False, "encoder-only: no decode step"
    if shape.name == "long_500k" and cfg.has_kv_cache:
        if not (cfg.sliding_window or cfg.long_context_window
                or cfg.arch_type in ("ssm", "hybrid")):
            return False, "full attention at 500k context: needs window variant"
    return True, ""
