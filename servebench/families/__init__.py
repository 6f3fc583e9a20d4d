"""Model families, found by name: a configuration whose ``model`` block says
``"arch_type": "<arch>"`` is drawn, checked, cut for the CPU and counted by
``families/<arch>.py`` (a ``-`` in the name becomes ``_`` in the file's), the
way ``bench.py`` finds a traffic mix or a metric. A new architecture joins the
benchmark as new files only: ``families/<arch>.py``, its reference under
``reference/``, a configuration, a traffic mix and entries in
``BENCHMARK.json``.

A family module provides:

- ``draw(model, seed, device) -> dict``: the parameter tree in the port's
  layout for this family (the tree the port's ``init_params`` makes, leaf for
  leaf in shape and dtype), every random leaf from ``seed`` through
  ``weights.generator`` and drawn on ``device`` in the served dtype. It is
  what the benchmark hands both the port and the reference.
- ``logits(model, params, seqs, wanted, *, precision="f32") -> [Tensor]``:
  the plain float32 reference (``reference/<arch>.py``), the float32 logits
  ``(len(wanted[j]), vocab)`` of every sequence ``j`` at the positions
  ``wanted[j]``; ``precision="fp8"`` is the control (see
  ``reference/dense.py``).
- ``tiny(model) -> dict``: a new model block cut to a size the CPU tests run
  in seconds (two layers, width 128, vocabulary 512, page 8), the family's
  own keys cut to match. ``model`` is not changed.
- optionally, any function of ``flops.py`` that takes the model block first
  (``attention_matmul_params``, ``active_matmul_params``, ``attended``,
  ``attention_flops``, ``token_flops``, ``prompt_flops``, ``decode_flops``,
  ``kv_bytes_per_token_layer``, ``kv_bytes_per_token``, ``decode_kv_bytes``,
  ``replication_bytes_per_token``), with the same signature and meaning.
  ``flops.py`` then calls the family's instead of its own formula, which
  counts attention and an MLP on every layer and no other state; the
  family's may call that formula as ``flops.<name>.default``.

A family module and its reference import neither JAX, the JAX package, nor
anything of the port (``repro_torch``): the reference takes nothing that the
program made, and the walk of ``test_servebench_imports.py`` covers these
files.
"""
from __future__ import annotations

import importlib
from pathlib import Path


def module_name(model: dict) -> str:
    """The family module's name: ``servebench.families.<arch>``, a ``-`` in
    ``model["arch_type"]`` read as ``_``. A block without ``arch_type`` names
    no family, and is an error wherever a family is asked for."""
    if "arch_type" not in model:
        raise KeyError("the model block names no family: it has no "
                       "'arch_type'")
    return f"{__name__}.{model['arch_type'].replace('-', '_')}"


def load(model: dict):
    """The family module of ``model`` (a configuration's ``model`` block),
    imported once (``sys.modules`` keeps it)."""
    name = module_name(model)
    try:
        return importlib.import_module(name)
    except ModuleNotFoundError as e:
        if e.name != name:
            raise
        path = Path(__path__[0]) / (name.rsplit(".", 1)[1] + ".py")
        raise FileNotFoundError(f"model family {model['arch_type']!r}: no "
                                f"module at {path}") from None


def function(model: dict, name: str):
    """The family's own ``name``, or None where the family has none."""
    return getattr(load(model), name, None)
