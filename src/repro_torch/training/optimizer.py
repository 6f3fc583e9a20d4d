"""AdamW with a cosine schedule and global-norm clipping, as plain functions
over the nested param tree (not ``torch.optim``: the reference's semantics
are per leaf of the layer-stacked tree). m and v are f32; each step is
computed in f32 and cast back to the param's dtype; decoupled weight decay
applies to every leaf with ndim >= 2 — with layer-stacked params that
includes the stacked norm weights (L, d) and Mamba's A_log, D and dt_bias
(L, h), as in the reference."""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch

from repro_torch.training.tree import leaves, unflatten


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


class OptState(NamedTuple):
    step: torch.Tensor      # 0-d int32
    m: Any
    v: Any


def init(params) -> OptState:
    """Zero f32 moments shaped like ``params``, on the params' devices."""
    flat = leaves(params)
    zeros = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
             for p in flat]
    return OptState(torch.zeros((), dtype=torch.int32,
                                device=flat[0].device),
                    unflatten(params, zeros),
                    unflatten(params, [z.clone() for z in zeros]))


def schedule(cfg: OptimizerConfig, step):
    """Learning rate at ``step`` (an int or integer tensor): linear warmup,
    then cosine decay to 0 at ``total_steps``, in f32."""
    step = torch.as_tensor(step).float()
    warm = step / max(cfg.warmup_steps, 1)
    frac = (step - cfg.warmup_steps) / max(
        cfg.total_steps - cfg.warmup_steps, 1)
    frac = torch.clamp(frac, 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * frac))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def global_norm(tree):
    """sqrt of the sum of squares of every leaf, in f32 (leaves in the
    reference's order)."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in leaves(tree)))


@torch.no_grad()
def update(cfg: OptimizerConfig, params, grads, state: OptState):
    """Returns (new_params, new_state, metrics); the inputs are not
    modified."""
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    step = state.step + 1
    lr = schedule(cfg, step)
    b1c = 1 - torch.pow(cfg.b1, step.float())
    b2c = 1 - torch.pow(cfg.b2, step.float())

    def upd(p, g, m, v):
        g = g.float() * scale
        m_new = cfg.b1 * m + (1 - cfg.b1) * g
        v_new = cfg.b2 * v + (1 - cfg.b2) * torch.square(g)
        mhat = m_new / b1c
        vhat = v_new / b2c
        delta = mhat / (torch.sqrt(vhat) + cfg.eps)
        if p.ndim >= 2:                       # decoupled decay
            delta = delta + cfg.weight_decay * p.float()
        return (p.float() - lr * delta).to(p.dtype), m_new, v_new

    out = [upd(p, g, m, v) for p, g, m, v in zip(
        leaves(params), leaves(grads), leaves(state.m), leaves(state.v))]
    new_p = unflatten(params, [o[0] for o in out])
    new_m = unflatten(state.m, [o[1] for o in out])
    new_v = unflatten(state.v, [o[2] for o in out])
    return new_p, OptState(step, new_m, new_v), {"grad_norm": gnorm,
                                                 "lr": lr}
