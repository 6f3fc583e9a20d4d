"""Qwen1.5-0.5B — dense GQA with QKV bias. [hf:Qwen/Qwen1.5-0.5B]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-0.5b", arch_type="dense",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=2816, vocab_size=151_936, qkv_bias=True,
    long_context_window=8_192,  # enables long_500k via sliding window
    source="hf:Qwen/Qwen1.5-0.5B",
)
