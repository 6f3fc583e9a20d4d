"""RecurrentGemma-9B — RG-LRU + local attention, 1 attn : 2 recurrent. [arXiv:2402.19427]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b", arch_type="hybrid",
    n_layers=38, d_model=4096, n_heads=16, n_kv_heads=1,  # MQA local attention
    head_dim=256, d_ff=12_288, vocab_size=256_000,
    block_pattern=("rglru", "rglru", "attn"),   # 2 recurrent : 1 local-attn
    lru_width=4096, sliding_window=2048,
    source="arXiv:2402.19427",
)
