"""The port's launchers as a user runs them (``python -m``, on the CPU,
reduced configs by the reference's n_params > 3e8 rule): training takes a
few steps and serving answers its 12 requests, each exiting 0; ``--dry-run``
(the reference's TPU lowering, which the port does not have) and the
trainer's ``--multi-pod`` (that lowering's mesh) exit non-zero and name the
ROADMAP.md item."""
import os
import subprocess
import sys

import pytest

pytest.importorskip("torch")

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))


def _run(*args, timeout=240):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    return subprocess.run([sys.executable, "-m", *args], capture_output=True,
                          text=True, env=env, cwd=ROOT, timeout=timeout)


def test_train_launcher_on_cpu():
    out = _run("repro_torch.launch.train", "--arch", "qwen1.5-0.5b",
               "--device", "cpu", "--steps", "3")
    assert out.returncode == 0, out.stderr
    assert "training reduced variant" in out.stdout
    lines = [ln for ln in out.stdout.splitlines() if ln.startswith("{")]
    assert len(lines) == 1 and "'step': 1" in lines[0]     # log_every 10
    assert "final loss:" in out.stdout


def test_serve_launcher_on_cpu():
    out = _run("repro_torch.launch.serve", "--arch", "qwen1.5-0.5b",
               "--device", "cpu")
    assert out.returncode == 0, out.stderr
    assert "served 12 requests" in out.stdout
    # the CPU takes the kernel's plain version: no launch
    assert "paged_attention launches: 0" in out.stdout


@pytest.mark.parametrize("launcher", ["train", "serve"])
def test_dry_run_is_refused(launcher):
    out = _run(f"repro_torch.launch.{launcher}", "--arch", "yi-9b",
               "--dry-run", timeout=60)
    assert out.returncode != 0
    assert "ROADMAP.md" in out.stderr and "TPU" in out.stderr


def test_multi_pod_is_refused():
    out = _run("repro_torch.launch.train", "--arch", "yi-9b", "--multi-pod",
               timeout=60)
    assert out.returncode != 0
    assert "--multi-pod" in out.stderr and "ROADMAP.md" in out.stderr


def test_serve_has_no_tpu_shape_options():
    for flag in ("--shape", "--multi-pod"):
        out = _run("repro_torch.launch.serve", "--arch", "yi-9b", flag,
                   "decode_32k", timeout=60)
        assert out.returncode != 0 and "unrecognized" in out.stderr
