"""Operations and bytes that the served work needs, from the configuration.

These count what the inputs need, whatever implements them: a prompt token
is counted once however often it was prefilled, padding is not counted, and
an MoE token counts its top-k experts only. ``model`` is the ``model`` block
of a configuration file.

The formulas here count attention and an MLP on every layer and no other
state. Every function that takes the model block first is the model's
family's own where ``families/<arch_type>.py`` defines one of that name
(a hybrid counts attention on its attention layers only, and its scan's
work and state); the formula here stays reachable as ``<name>.default``.
"""
from __future__ import annotations

import functools
import json
from pathlib import Path

from servebench import families

PEAKS = Path(__file__).resolve().parent / "peaks.json"


def peaks(device_name: str) -> dict:
    """The published peaks of the card named ``device_name``."""
    table = json.loads(PEAKS.read_text())
    if device_name not in table:
        raise KeyError(f"no peaks for {device_name!r}; known: {sorted(table)}")
    return table[device_name]


def _family_may_override(fn):
    @functools.wraps(fn)
    def call(model: dict, *args):
        return (families.function(model, fn.__name__) or fn)(model, *args)
    call.default = fn
    return call


@_family_may_override
def attention_matmul_params(model: dict) -> int:
    """One layer's attention projections: Q, K, V and the output."""
    d, h, k = model["d_model"], model["n_heads"], model["n_kv_heads"]
    hd = model["head_dim"]
    return d * h * hd + 2 * d * k * hd + h * hd * d


@_family_may_override
def active_matmul_params(model: dict) -> int:
    """Weights one token multiplies by: attention projections, the MLP (an
    MoE family's: its router and its top-k experts), and the unembedding.
    The embedding lookup does no arithmetic."""
    d, f = model["d_model"], model["d_ff"]
    return (model["n_layers"] * (attention_matmul_params(model) + 3 * d * f)
            + d * model["vocab_size"])


@_family_may_override
def attended(model: dict, position: int) -> int:
    """Keys a query at ``position`` (0-based) attends to: causal, within the
    window where the model has one."""
    n = position + 1
    w = model.get("sliding_window", 0)
    return min(n, w) if w else n


@_family_may_override
def attention_flops(model: dict, position: int) -> int:
    """QK^T and PV of one token at ``position`` over all layers."""
    return (4 * model["n_heads"] * model["head_dim"] * attended(model, position)
            * model["n_layers"])


@_family_may_override
def token_flops(model: dict, position: int) -> int:
    return 2 * active_matmul_params(model) + attention_flops(model, position)


@_family_may_override
def prompt_flops(model: dict, prompt_len: int) -> int:
    """A whole prompt, each token at its own position; only its last token
    needs the unembedding (its logits give the first output token)."""
    unembed = model["d_model"] * model["vocab_size"]
    base = 2 * (active_matmul_params(model) - unembed) * prompt_len \
        + 2 * unembed
    return base + sum(attention_flops(model, p) for p in range(prompt_len))


@_family_may_override
def decode_flops(model: dict, prompt_len: int, g_from: int, g_to: int) -> int:
    """Decode steps that took a request from ``g_from`` to ``g_to``
    generated tokens. Token g (1-based) is produced at position
    prompt_len + g - 2 (the first comes from the prefill and is not a decode
    step)."""
    return sum(token_flops(model, prompt_len + g - 2)
               for g in range(max(g_from, 1) + 1, g_to + 1))


@_family_may_override
def kv_bytes_per_token_layer(model: dict) -> int:
    """K and V of one token in one attention layer, in the pool's dtype."""
    itemsize = {"bfloat16": 2, "float16": 2, "float32": 4, "int8": 1}[
        model.get("kv_dtype", "bfloat16")]
    return 2 * model["n_kv_heads"] * model["head_dim"] * itemsize


@_family_may_override
def kv_bytes_per_token(model: dict) -> int:
    return kv_bytes_per_token_layer(model) * model["n_layers"]


@_family_may_override
def decode_kv_bytes(model: dict, prompt_len: int, g_from: int,
                    g_to: int) -> int:
    """KV bytes the attention of those decode steps has to read: each step
    reads every key and value its query attends to, once per layer."""
    per = kv_bytes_per_token(model)
    return sum(attended(model, prompt_len + g - 2) * per
               for g in range(max(g_from, 1) + 1, g_to + 1))


@_family_may_override
def replication_bytes_per_token(model: dict, prompt_len: float,
                                output_len: float) -> float:
    """What delta replication should ship per output token when every
    request's pages cross to its ring peer once: (prompt + output) tokens of
    KV over the output tokens. Pages are whole, so the real figure rounds
    each request up to its last page."""
    return (prompt_len + output_len) / output_len * kv_bytes_per_token(model)
