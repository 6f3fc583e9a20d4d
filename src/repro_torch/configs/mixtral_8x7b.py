"""Mixtral-8x7B — MoE 8 experts top-2, sliding-window attention. [arXiv:2401.04088]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b", arch_type="moe",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=14_336, vocab_size=32_000,
    n_experts=8, top_k=2, sliding_window=4096,
    source="arXiv:2401.04088",
)
