"""The port stands alone: ``repro_torch`` and ``chip_smoke.py`` import with
JAX and the reference package unavailable, and their sources hold no import
of either."""
import os
import re
import subprocess
import sys

import pytest

pytest.importorskip("torch")

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
PORT = os.path.join(ROOT, "src", "repro_torch")

IMPORT_ALL = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None          # any 'import jax' now raises ImportError
sys.modules["repro"] = None        # ... and so does any 'import repro...'
sys.path[:0] = [{src!r}, {root!r}]
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
assert not [m for m in sys.modules
            if (m == "jax" or m.startswith(("jax.", "repro.")))
            and sys.modules[m] is not None]
print(" ".join(names))
"""


def test_port_and_chip_smoke_import_without_jax_or_reference():
    code = IMPORT_ALL.format(src=os.path.join(ROOT, "src"), root=ROOT)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=ROOT, timeout=120)
    assert out.returncode == 0, out.stderr
    names = set(out.stdout.split())
    assert len(names) >= 67                       # every submodule imported
    assert {"repro_torch.kernels.build",
            "repro_torch.kernels.paged_attention_int8",
            "repro_torch.kernels.ops",
            "repro_torch.kernels.ssd_scan",
            "repro_torch.models.ssm",
            "repro_torch.models.moe",
            "repro_torch.models.hybrid",
            "repro_torch.models.api",
            "repro_torch.distributed.sharding",
            "repro_torch.distributed.layout",
            "repro_torch.core.clock",
            "repro_torch.core.cluster",
            "repro_torch.core.communicator",
            "repro_torch.core.failure",
            "repro_torch.core.recovery",
            "repro_torch.core.replication",
            "repro_torch.core.router",
            "repro_torch.core.system",
            "repro_torch.serving.workload",
            "repro_torch.models.transformer",
            "repro_torch.models.vlm",
            "repro_torch.models.encoder",
            "repro_torch.training.tree",
            "repro_torch.training.data",
            "repro_torch.training.optimizer",
            "repro_torch.training.checkpoint",
            "repro_torch.training.train_loop",
            "repro_torch.launch.train",
            "repro_torch.launch.serve",
            "repro_torch.launch.mesh",
            "repro_torch.launch.specs",
            "repro_torch.launch.op_cost",
            "repro_torch.launch.dryrun",
            "repro_torch.launch.hillclimb"} <= names


FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro\b(?!_torch)"
    r"|import\s+repro\.|from\s+repro\b(?!_torch)|from\s+repro\.)", re.M)


def _sources():
    for dirpath, _, files in os.walk(PORT):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(ROOT, "chip_smoke.py")


def test_sources_hold_no_import_of_jax_or_reference():
    found = []
    for path in _sources():
        with open(path, encoding="utf-8") as fh:
            for m in FORBIDDEN.finditer(fh.read()):
                found.append(f"{os.path.relpath(path, ROOT)}: {m.group(0)}")
    assert not found, found
