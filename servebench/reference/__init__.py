"""Plain PyTorch references of the served models, in float32 with TF32 off.

They import nothing of the port or of JAX and take only the weights and
token ids the benchmark drew; everything else (RoPE tables, masks, routing)
they work out themselves. ``dense`` is a Llama-style decoder (RMSNorm,
interleaved-pair RoPE, grouped-query attention, SwiGLU); ``moe`` swaps the
MLP for Mixtral's routed experts (softmax over the router's logits, top-k,
renormalised gates) and adds its sliding window.
"""
