"""InternVL2-76B — VLM; InternLM2-style LM backbone, ViT frontend STUBBED. [arXiv:2404.16821]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-76b", arch_type="vlm",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=28_672, vocab_size=128_256,
    frontend="vision", frontend_dim=8192,   # projected patch embeddings arrive precomputed
    long_context_window=8_192,
    source="arXiv:2404.16821",
)
