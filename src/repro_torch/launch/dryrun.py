"""Dry run: one step of every (architecture x input shape) on the
production meshes, costed and sized per device without allocating anything.

The reference lowers and compiles each step for a 512-device TPU mesh and
reads XLA's analyses. The port keeps the tool's function and drops XLA:
params, optimizer state and inputs are DTensors laid out by the spec rules
(``distributed/sharding.py``) on a ``DeviceMesh`` over a fake process group
(``launch/mesh.py``), under ``FakeTensorMode``; the step runs op by op at
rank 0's per-device shapes, its redistributions issuing their collectives,
and ``launch/op_cost.py`` counts each local op. On a one-device mesh the
same step runs on plain fake tensors.

A record has the reference's keys, each with its value here:
  * ``lower_s``: seconds to build and lay out the arguments; ``compile_s``:
    seconds of the traced step (op by op, nothing compiles);
  * ``flops``, ``hlo_bytes``, ``collective_bytes``, ``coll_total``: one
    device's counts (``op_cost``);
  * ``argument_bytes``: one device's bytes of params, optimizer state and
    inputs; ``output_bytes``: of the step's outputs;
  * ``temp_bytes``: the peak of the bytes the step allocates, live at once,
    above the arguments (outputs alive at the peak included);
  * ``n_devices``.
The reference's ``xla_flops`` / ``xla_bytes`` (XLA's raw cost analysis,
loop bodies counted once) have no counterpart and are not in the record.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-9b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes \\
      --device cpu --out artifacts/torch_dryrun.json
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import sys
import time
import traceback
from typing import Any, Dict, Optional

import torch

from repro_torch.configs import (ASSIGNED, INPUT_SHAPES, get_config,
                                 shape_applicable)
from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.distributed import sharding as sh
from repro_torch.launch import specs as sp
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.op_cost import CostMode, tensor_bytes
from repro_torch.models import api
from repro_torch.models import layers as L
from repro_torch.training.optimizer import OptimizerConfig, OptState
from repro_torch.training.train_loop import make_train_step
from repro_torch.training.tree import _children as children
from repro_torch.training.tree import leaves, unflatten


# --------------------------------------------------------------------------
# step builders
# --------------------------------------------------------------------------

def build_lowerable(cfg: ModelConfig, shape: InputShape, mesh,
                    profile: str = "baseline"):
    """Returns (fn, args, shardings): the step, its arguments as meta
    tensors of the global shapes, and a ``Sharding`` per argument leaf in
    the same structure. ``profile`` selects the params' layout
    (``sharding.PROFILES``)."""
    q_chunk = 512 if shape.seq_len >= 4096 else 256
    pshape = sp.params_struct(cfg)
    pshard = sh.params_shardings(pshape, mesh, profile)
    if shape.kind == "train":
        step = make_train_step(cfg, OptimizerConfig(), q_chunk=q_chunk,
                               remat=True)
        oshape = sp.opt_state_struct(pshape)
        # m and v shard exactly like their param; the step count replicates
        oshard = OptState(sh.replicated(mesh), pshard, pshard)
        bshape = sp.input_specs(cfg, shape)
        bshard = sh.batch_shardings(bshape, mesh, profile)
        return step, (pshape, oshape, bshape), (pshard, oshard, bshard)

    if shape.kind == "prefill":
        bshape = sp.input_specs(cfg, shape)
        bshard = sh.batch_shardings(bshape, mesh, profile)
        if cfg.arch_type == "audio":
            from repro_torch.models import encoder

            def fn(p, b):
                return encoder.forward(cfg, p, b["frame_embeds"],
                                       q_chunk=q_chunk)
        else:
            def fn(p, b):
                logits, cache, _ = api.prefill(cfg, p, b, q_chunk=q_chunk)
                return logits, cache
        return fn, (pshape, bshape), (pshard, bshard)

    # decode
    ins = sp.input_specs(cfg, shape)
    cshard = sh.cache_shardings(ins["cache"], mesh, cfg.arch_type)
    m = sh.mesh_sizes(mesh)
    # the token over the data axes where they divide the batch
    tshard = sh.sharding(sh.batch_spec(tuple(ins["token"].shape), m), m)
    seq_len = shape.seq_len

    def fn(p, token, cache, pos):
        return api.decode_step(cfg, p, token, cache, pos, seq_len=seq_len)

    return fn, (pshape, ins["token"], ins["cache"], ins["pos"]), \
        (pshard, tshard, cshard, sh.replicated(mesh))


def local_shape(shape, sharding: sh.Sharding, mesh) -> tuple:
    """One device's shape of a tensor of ``shape`` laid out as
    ``sharding`` (the spec rules split only dims their axes divide)."""
    m = sh.mesh_sizes(mesh)
    out = list(shape)
    for dim, axes in enumerate(sharding.spec):
        out[dim] //= sh.axis_size(m, axes)
    return tuple(out)


def lay_out(args, shardings, mesh, device):
    """Fake tensors for ``args`` (meta tensors) on ``device``, under the
    caller's ``FakeTensorMode``: DTensors of one device's shapes on a
    ``DeviceMesh``, plain tensors of the whole shapes on a dict mesh."""
    from torch.distributed.tensor import DTensor
    flat = leaves(args)
    flat_sh = sharding_leaves(shardings)
    assert len(flat) == len(flat_sh), (len(flat), len(flat_sh))
    out = []
    for leaf, shd in zip(flat, flat_sh):
        if isinstance(mesh, dict):
            out.append(torch.empty(leaf.shape, dtype=leaf.dtype,
                                   device=device))
            continue
        local = torch.empty(local_shape(leaf.shape, shd, mesh),
                            dtype=leaf.dtype, device=device)
        out.append(DTensor.from_local(local, mesh, shd.placements,
                                      run_check=False, shape=leaf.shape,
                                      stride=leaf.stride()))
    return unflatten(args, out)


def sharding_leaves(tree) -> list:
    """The ``Sharding``s of a tree of them, in ``tree.leaves`` order."""
    if isinstance(tree, sh.Sharding):
        return [tree]
    return [s for _, child in children(tree) for s in sharding_leaves(child)]


def local_bytes(tree) -> int:
    """One device's bytes of every tensor leaf of ``tree``."""
    from torch.distributed.tensor import DTensor
    return sum(tensor_bytes(t.to_local() if isinstance(t, DTensor) else t)
               for t in leaves(tree) if isinstance(t, torch.Tensor))


@contextlib.contextmanager
def implicit_replication():
    """Plain tensors made inside the model (RoPE tables, masks, zero
    states) meet DTensor operands as replicated DTensors. Uses the C++
    switch where this torch has it, else DTensor's context manager."""
    setter = getattr(torch._C, "_set_dtensor_allow_implicit_replication",
                     None)
    if setter is None:
        from torch.distributed.tensor.experimental import \
            implicit_replication as cm
        with cm():
            yield
        return
    old = torch._C._get_dtensor_allow_implicit_replication()
    setter(True)
    try:
        yield
    finally:
        setter(old)


@contextlib.contextmanager
def fake_alltoall(mesh):
    """On a cpu-typed mesh DTensor turns each all-to-all into an all-gather
    and a chunk, because gloo has no all-to-all; the fake process group has
    one. On such a mesh this issues DTensor's own all-to-all op instead, as
    a cuda mesh does, so the record counts the collective and the buffer
    that the card's run would."""
    import torch.distributed._functional_collectives as funcol
    import torch.distributed.tensor.placement_types as pt
    orig = getattr(pt, "shard_dim_alltoall", None)
    if isinstance(mesh, dict) or mesh.device_type != "cpu" or orig is None:
        yield
        return

    def alltoall(input, gather_dim, shard_dim, mesh, mesh_dim):
        group = funcol._resolve_group((mesh, mesh_dim))
        return torch.ops._dtensor.shard_dim_alltoall(
            input, gather_dim, shard_dim, funcol._group_or_group_name(group))
    pt.shard_dim_alltoall = alltoall
    try:
        yield
    finally:
        pt.shard_dim_alltoall = orig


# --------------------------------------------------------------------------
# one dry-run
# --------------------------------------------------------------------------

def dry_run(cfg: ModelConfig, shape: InputShape, mesh,
            profile: str = "baseline", seq_hint: bool = False,
            device: str = "cuda") -> Dict[str, Any]:
    """One step of ``cfg`` at ``shape`` on ``mesh`` (a ``DeviceMesh`` or a
    dict mesh), on fake tensors of ``device``. Returns the record's
    measured keys; raises on failure."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    t0 = time.perf_counter()
    fn, args, shardings = build_lowerable(cfg, shape, mesh, profile)
    with FakeTensorMode(allow_non_fake_inputs=True):
        local = lay_out(args, shardings, mesh, device)
        t_lower = time.perf_counter() - t0
        cost = CostMode()
        batch_axes = tuple(sh.mesh_sizes(mesh)) if profile == "pure_dp" \
            else ("pod", "data")
        with implicit_replication(), fake_alltoall(mesh), \
                L.shard_hints("model" if seq_hint else None, batch_axes), \
                cost:
            out = fn(*local)
        t_step = time.perf_counter() - t0 - t_lower
        agg = cost.totals()
        rec = dict(
            lower_s=round(t_lower, 1), compile_s=round(t_step, 1),
            flops=agg["flops"], hlo_bytes=agg["bytes"],
            collective_bytes={k[5:]: v for k, v in agg.items()
                              if k.startswith("coll_")
                              and k != "coll_bytes"},
            coll_total=agg["coll_bytes"],
            argument_bytes=local_bytes(local),
            output_bytes=local_bytes(out),
            temp_bytes=cost.peak_bytes,
            n_devices=math.prod(sh.mesh_sizes(mesh).values()))
    return rec


def dry_run_one(arch: str, shape_name: str, multi_pod: bool = False,
                verbose: bool = True, profile: str = "baseline",
                kv_dtype: Optional[str] = None, seq_hint: bool = False,
                device: str = "cuda") -> Dict[str, Any]:
    """The record of ``arch`` x ``shape_name`` on the production mesh:
    ``ok`` with the measured keys, ``skipped`` with ``shape_applicable``'s
    reason, or ``error`` with the trace."""
    cfg = get_config(arch)
    if kv_dtype:
        cfg = dataclasses.replace(cfg, kv_dtype=kv_dtype)
    shape = INPUT_SHAPES[shape_name]
    ok, why = shape_applicable(cfg, shape)
    rec: Dict[str, Any] = {"arch": arch, "shape": shape_name,
                           "mesh": "2x16x16" if multi_pod else "16x16",
                           "profile": profile,
                           "kv_dtype": kv_dtype or cfg.kv_dtype}
    if not ok:
        rec.update(status="skipped", reason=why)
        return rec
    rec["seq_hint"] = seq_hint
    try:
        mesh = make_production_mesh(multi_pod=multi_pod, device=device)
        rec.update(status="ok", **dry_run(cfg, shape, mesh, profile,
                                          seq_hint, device))
        if verbose:
            print(f"[ok] {arch} x {shape_name} x {rec['mesh']}: "
                  f"flops/dev={rec['flops']:.3g} "
                  f"bytes/dev={rec['hlo_bytes']:.3g} "
                  f"coll/dev={rec['coll_total']:.3g} "
                  f"args={rec['argument_bytes'] / 2**30:.2f}GiB/dev "
                  f"temp={rec['temp_bytes'] / 2**30:.2f}GiB "
                  f"layout={rec['lower_s']:.0f}s step={rec['compile_s']:.0f}s",
                  flush=True)
    except Exception as e:  # noqa: BLE001 — report, don't crash the sweep
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   trace=traceback.format_exc()[-2000:])
        if verbose:
            print(f"[ERR] {arch} x {shape_name} x {rec['mesh']}: {e}",
                  flush=True)
    return rec


def write_json(path: str, obj):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(obj, f, indent=1)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--archs", default=None, help="comma-separated subset")
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--profile", default="baseline")
    ap.add_argument("--kv-dtype", default=None)
    ap.add_argument("--device", default="cuda",
                    help="the fake tensors' device: cuda (the default) or "
                         "cpu")
    args = ap.parse_args(argv)

    if args.all:
        archs = ASSIGNED
        shapes = list(INPUT_SHAPES)
    elif args.archs:
        archs = args.archs.split(",")
        shapes = [args.shape] if args.shape else list(INPUT_SHAPES)
    else:
        archs = [args.arch]
        shapes = [args.shape] if args.shape else list(INPUT_SHAPES)
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    records = []
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                records.append(dry_run_one(arch, shape, multi_pod=mp,
                                           profile=args.profile,
                                           kv_dtype=args.kv_dtype,
                                           device=args.device))
                if args.out:
                    write_json(args.out, records)
    n_ok = sum(r["status"] == "ok" for r in records)
    n_skip = sum(r["status"] == "skipped" for r in records)
    n_err = sum(r["status"] == "error" for r in records)
    print(f"\n=== dry-run: {n_ok} ok, {n_skip} skipped (by design), "
          f"{n_err} errors ===")
    sys.exit(1 if n_err else 0)


if __name__ == "__main__":
    main()
