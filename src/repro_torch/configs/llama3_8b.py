"""Llama-3.1-8B — the paper's own evaluation model (4-stage PP serving). [Meta 2024]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama3-8b", arch_type="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=14_336, vocab_size=128_256,
    rope_theta=500_000.0,
    long_context_window=8_192,
    source="hf:meta-llama/Llama-3.1-8B-Instruct (paper Sec 4)",
)
