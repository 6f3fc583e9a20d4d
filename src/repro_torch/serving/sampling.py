"""Token sampling."""
from __future__ import annotations

import torch


def sample(logits, generator=None, temperature: float = 0.0, top_k: int = 0):
    """logits: (B, V) -> (B,) int32. Greedy (argmax, first index on ties)
    at temperature 0; otherwise a categorical draw from ``generator``."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    logits = logits.float() / temperature
    if top_k:
        cutoff = torch.topk(logits, top_k, dim=-1).values[:, -1:]
        logits = torch.where(logits < cutoff,
                             torch.full_like(logits, -float("inf")), logits)
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(
        torch.int32)
