"""Yi-9B — llama-architecture dense GQA. [arXiv:2403.04652]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="yi-9b", arch_type="dense",
    n_layers=48, d_model=4096, n_heads=32, n_kv_heads=4,
    d_ff=11_008, vocab_size=64_000,
    long_context_window=8_192,
    source="arXiv:2403.04652",
)
