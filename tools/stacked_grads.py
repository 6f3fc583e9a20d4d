#!/usr/bin/env python3
"""What the layer-stacked params cost a train step's backward, on one card.

  python3 tools/stacked_grads.py

Params keep the reference's layer-stacked layout, so the forward takes
each layer's params as views of the stacked leaves. A per-layer index view
(``transformer.layer_params``) has a backward that writes a zero-filled
gradient of the WHOLE stack and adds it to the others: O(L^2) bytes. One
``unbind`` per leaf (``transformer.unstacked``, what the forward uses) has
a backward that stacks the layers' gradients once. This script times the
loss and its gradient (``api.loss``, no remat) of full-width hubert-xlarge
(48 layers) and mamba2-130m (24), bf16, random weights, batch 4 x 256,
with each form of view in turns (index, unbind, unbind, index; 3 calls a
turn after one warm-up), and prints per form: wall ms (synchronised host
clock), device-busy ms and kernel launches (torch.profiler), and the
gradients' largest difference between the two forms (relative to each
leaf's scale; over 1e-6 fails).
It needs a CUDA card.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import api, ssm, transformer as T  # noqa: E402
from repro_torch.training import tree  # noqa: E402
from repro_torch.training.data import make_batch  # noqa: E402

CONFIGS = ("hubert-xlarge", "mamba2-130m")
B, S, REPS = 4, 256, 3


def by_index(layers) -> list:
    """One ``layer_params`` index view per layer (the O(L^2) backward)."""
    n = len(tree.leaves(layers)[0])
    return [T.layer_params(layers, i) for i in range(n)]


FORMS = {"index": by_index, "unbind": T.unstacked}


def grads(cfg, params, batch, form):
    """(loss, gradients) with the forward's per-layer views made by
    ``form``."""
    ssm.unstacked = T.unstacked = FORMS[form]
    try:
        flat = [p.detach().requires_grad_() for p in tree.leaves(params)]
        loss = api.loss(cfg, tree.unflatten(params, flat), batch)
        # (the encoder never reads its token embedding: no gradient)
        got = torch.autograd.grad(loss, flat, allow_unused=True)
        return loss, [g for g in got if g is not None]
    finally:
        ssm.unstacked = T.unstacked = FORMS["unbind"]


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    print(card)
    for name in CONFIGS:
        cfg = get_config(name)
        params = api.init_params(cfg, torch.Generator(device="cuda")
                                 .manual_seed(0), device="cuda")
        batch = {k: torch.as_tensor(v, device="cuda")
                 for k, v in make_batch(cfg, B, S).items()}
        walls = {form: [] for form in FORMS}
        for form in ("index", "unbind", "unbind", "index"):
            grads(cfg, params, batch, form)
            torch.cuda.synchronize()
            for _ in range(REPS):
                t0 = time.perf_counter()
                grads(cfg, params, batch, form)
                torch.cuda.synchronize()
                walls[form].append((time.perf_counter() - t0) * 1e3)
        out = {}
        for form in FORMS:
            acts = [torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA]
            with torch.profiler.profile(activities=acts) as prof:
                grads(cfg, params, batch, form)
                torch.cuda.synchronize()
            kernels = [e for e in prof.key_averages()
                       if e.device_type == torch.autograd.DeviceType.CUDA]
            out[form] = {
                "wall_ms_median": statistics.median(walls[form]),
                "wall_ms": walls[form],
                "device_busy_ms": sum(e.self_device_time_total
                                      for e in kernels) / 1e3,
                "kernel_launches": sum(e.count for e in kernels)}
        (la, ga), (lb, gb) = (grads(cfg, params, batch, f) for f in FORMS)
        # relative to each leaf's largest magnitude (the embedding's
        # scatter-add may sum in another order from call to call)
        diff = max(float((a.float() - b.float()).abs().max())
                   / max(float(b.float().abs().max()), 1e-30)
                   for a, b in zip(ga, gb))
        print(f"{name} loss + gradient, batch {B} x {S}, {cfg.n_layers} "
              f"layers [{card}]: " + json.dumps(out)
              + f"; gradients' largest relative difference {diff:.3e}, "
              f"losses {float(la.detach())} / {float(lb.detach())}")
        if diff > 1e-6:
            print("the two forms' gradients differ", file=sys.stderr)
            return 1
        del params, batch, ga, gb
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
