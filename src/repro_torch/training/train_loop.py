"""Training loop: the train step (loss, gradient, AdamW), rematerialised
like the reference's, and the driver that feeds it the token stream."""
from __future__ import annotations

import dataclasses
import functools
import os
import tempfile
import time
from typing import Any, Dict

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import api
from repro_torch.training import checkpoint as ckpt_lib
from repro_torch.training.data import DataConfig, TokenStream
from repro_torch.training.optimizer import (OptimizerConfig, OptState,
                                            init as opt_init, update)
from repro_torch.training.tree import leaves, unflatten


def make_train_step(cfg: ModelConfig, ocfg: OptimizerConfig,
                    q_chunk: int = 1024, remat: bool = True):
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics {loss, grad_norm, lr}). With ``remat`` the loss keeps no
    activation for the backward and recomputes the forward there
    (``torch.utils.checkpoint``, the counterpart of the reference's
    ``jax.checkpoint(nothing_saveable)``). ``batch``: the family's inputs
    as tensors on the params' device. The params passed in are not
    modified."""
    loss_fn = functools.partial(api.loss, cfg, q_chunk=q_chunk)

    def train_step(params, opt_state: OptState, batch):
        flat = [p.detach().requires_grad_() for p in leaves(params)]
        tracked = unflatten(params, flat)
        if remat:
            loss = checkpoint(loss_fn, tracked, batch, use_reentrant=False)
        else:
            loss = loss_fn(tracked, batch)
        grads = torch.autograd.grad(loss, flat, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(flat, grads)]
        params, opt_state, om = update(ocfg, params,
                                       unflatten(params, grads), opt_state)
        return params, opt_state, {"loss": loss.detach(), **om}

    return train_step


@dataclasses.dataclass
class TrainerConfig:
    steps: int = 100
    log_every: int = 10
    ckpt_every: int = 0
    ckpt_dir: str = os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")


def train(cfg: ModelConfig, dcfg: DataConfig, ocfg: OptimizerConfig,
          tcfg: TrainerConfig, seed: int = 0, params=None, on_metrics=None,
          device="cuda") -> Dict[str, Any]:
    """End-to-end training driver. Without ``params`` the init draws from
    ``torch.Generator(device).manual_seed(seed)``. History records (the
    first step and every ``log_every``-th): loss, grad_norm, lr, step and
    tok_per_s."""
    if params is None:
        gen = torch.Generator(device=device).manual_seed(seed)
        params = api.init_params(cfg, gen, device=device)
    opt_state = opt_init(params)
    step_fn = make_train_step(cfg, ocfg, q_chunk=min(dcfg.seq_len, 512))
    stream = iter(TokenStream(cfg, dcfg))
    history = []
    t0 = time.time()
    for step in range(1, tcfg.steps + 1):
        batch = {k: torch.as_tensor(v, device=device)
                 for k, v in next(stream).items()}
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        if step % tcfg.log_every == 0 or step == 1:
            m = {k: float(v) for k, v in metrics.items()}
            m["step"] = step
            m["tok_per_s"] = dcfg.batch_size * dcfg.seq_len * step / (
                time.time() - t0)
            history.append(m)
            if on_metrics:
                on_metrics(m)
        if tcfg.ckpt_every and step % tcfg.ckpt_every == 0:
            ckpt_lib.save(tcfg.ckpt_dir, {"params": params}, step)
    return {"params": params, "opt_state": opt_state, "history": history}
