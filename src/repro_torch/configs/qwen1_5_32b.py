"""Qwen1.5-32B — dense with QKV bias; kv=40 (MHA-like). [hf:Qwen/Qwen1.5-0.5B]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-32b", arch_type="dense",
    n_layers=64, d_model=5120, n_heads=40, n_kv_heads=40,
    d_ff=27_392, vocab_size=152_064, qkv_bias=True,
    # MHA KV at decode_32k x batch 128 is too large in bf16 -> quantize cache
    kv_dtype="int8",
    long_context_window=8_192,
    source="hf:Qwen/Qwen1.5-0.5B",
)
