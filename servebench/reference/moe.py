"""Mixtral-style decoder in float32: the dense reference with each MLP
replaced by routed experts.

Routing: float32 router logits, softmax over all experts, the top-k
probabilities renormalised to sum to one; every token goes to its k experts
(no capacity limit: serving drops no token). Each expert is a SwiGLU. The
sliding window comes from the model block.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import torch

from servebench.reference import dense


def routed_mlp(model, lp, x, mm, precision):
    """sum over the top-k experts e of gate_e(x) * SwiGLU_e(x)."""
    router = lp["router"].float()
    if precision == "fp8":
        router = dense.fp8_round(router)
    probs = torch.softmax(mm(x, router), dim=-1)
    top_p, top_i = probs.topk(model["top_k"], dim=-1)
    top_p = top_p / top_p.sum(dim=-1, keepdim=True)
    out = torch.zeros_like(x)
    ex = lp["experts"]
    for e in range(model["n_experts"]):
        rows, slot = (top_i == e).nonzero(as_tuple=True)
        if rows.numel() == 0:
            continue
        w = [dense.upcast(ex[n][e], precision)
             for n in ("w_gate", "w_up", "w_down")]
        y = dense.swiglu(x[rows], *w, mm)
        out.index_add_(0, rows, y * top_p[rows, slot, None])
    return out


def logits(model: dict, params: Dict, seqs: Sequence[List[int]],
           wanted: Sequence[Sequence[int]], *, precision: str = "f32"
           ) -> List[torch.Tensor]:
    return dense.logits(model, params, seqs, wanted, precision=precision,
                        mlp=routed_mlp)
