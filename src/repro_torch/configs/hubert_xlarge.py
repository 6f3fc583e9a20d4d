"""HuBERT-XLarge — encoder-only audio transformer; conv codec STUBBED. [arXiv:2106.07447]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge", arch_type="audio",
    n_layers=48, d_model=1280, n_heads=16, n_kv_heads=16,
    d_ff=5120, vocab_size=504,
    is_encoder_only=True,
    frontend="audio", frontend_dim=1280,   # precomputed frame embeddings
    source="arXiv:2106.07447",
)
