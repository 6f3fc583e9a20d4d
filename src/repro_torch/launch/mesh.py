"""Production mesh construction, as functions: importing this module starts
no process group and touches no device.

The production meshes are a 16x16 ("data", "model") mesh of 256 cards and a
2x16x16 ("pod", "data", "model") mesh of 512. This process stands for rank
0 of them over a fake process group (``torch.testing``'s ``FakeStore``, the
"fake" backend): collectives return at once and move nothing, so every op
runs at rank 0's per-device shapes and every redistribution issues its
collective without a cluster.
"""
from __future__ import annotations

import torch

PRODUCTION = {False: ((16, 16), ("data", "model")),
              True: ((2, 16, 16), ("pod", "data", "model"))}

# the fake process group this module started, if any
_started_world = None


def _fake_process_group(world: int):
    """A fake default process group of ``world`` ranks, this process rank
    0. Starts one when none exists; replaces one that this module started
    for another size; raises if another caller's group has another
    size."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    global _started_world
    if dist.is_initialized():
        if dist.get_world_size() == world:
            return
        if _started_world is None:
            raise RuntimeError(
                f"a process group of {dist.get_world_size()} ranks exists; "
                f"the mesh needs {world}")
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    _started_world = world


def make_production_mesh(*, multi_pod: bool = False, device: str = "cuda"):
    """Single pod: 16x16 = 256 cards (data, model). Multi-pod: 2x16x16 =
    512 cards (pod, data, model). A ``DeviceMesh`` over a fake process
    group, with ``device``'s type."""
    from torch.distributed.device_mesh import DeviceMesh
    shape, names = PRODUCTION[multi_pod]
    world = 1
    for n in shape:
        world *= n
    _fake_process_group(world)
    return DeviceMesh(torch.device(device).type,
                      torch.arange(world).reshape(shape),
                      mesh_dim_names=names)


def make_local_mesh():
    """What this process drives: one device, as the dict mesh
    ``{"data": 1, "model": 1}``. Every spec replicates on it, so it needs no process
    group and no DTensor; more cards need one process per card, which the
    dry run does not start."""
    return {"data": 1, "model": 1}
