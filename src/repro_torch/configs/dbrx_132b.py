"""DBRX-132B — fine-grained MoE, 16 experts top-4. [hf:databricks/dbrx-base]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="dbrx-132b", arch_type="moe",
    n_layers=40, d_model=6144, n_heads=48, n_kv_heads=8,
    d_ff=10_752, vocab_size=100_352,
    n_experts=16, top_k=4,
    long_context_window=8_192,
    source="hf:databricks/dbrx-base",
)
