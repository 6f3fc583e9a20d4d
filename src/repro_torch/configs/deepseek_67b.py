"""DeepSeek-67B — llama-architecture dense GQA. [arXiv:2401.02954]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-67b", arch_type="dense",
    n_layers=95, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=22_016, vocab_size=102_400,
    long_context_window=8_192,
    source="arXiv:2401.02954",
)
