"""The port's launchers as a user runs them (``python -m``, on the CPU,
reduced configs by the reference's n_params > 3e8 rule): training takes a
few steps and serving answers its 12 requests, each exiting 0; with
``--dry-run`` each runs one dry-run record of the full-size config on the
fake production mesh instead (``--multi-pod``: the 2x16x16 one; the serve
launcher's ``--shape`` picks the record) and exits 0 when it is ``ok`` or
``skipped``."""
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


def test_dry_run_is_a_record():
    """mamba2-130m's train_4k step on the 16x16 mesh, the cheapest record
    of the trainer's one shape."""
    out = _run("repro_torch.launch.train", "--arch", "mamba2-130m",
               "--dry-run", "--device", "cpu", timeout=180)
    assert out.returncode == 0, out.stderr
    assert "[ok] mamba2-130m x train_4k x 16x16: flops/dev=" in out.stdout


def test_multi_pod_dry_run_is_on_the_2x16x16_mesh():
    out = _run("repro_torch.launch.serve", "--arch", "mamba2-130m",
               "--shape", "long_500k", "--dry-run", "--multi-pod",
               "--device", "cpu", timeout=120)
    assert out.returncode == 0, out.stderr
    assert "[ok] mamba2-130m x long_500k x 2x16x16:" in out.stdout


@pytest.mark.parametrize("shape,status", [("long_500k", "ok"),
                                          ("decode_32k", "skipped")])
def test_serve_dry_run_takes_its_shape(shape, status):
    """The serve launcher's ``--shape`` picks the record: a decode step for
    mamba2-130m, and none for the encoder-only hubert-xlarge (skipped, by
    the reference's rule: still exit 0)."""
    arch = "mamba2-130m" if status == "ok" else "hubert-xlarge"
    out = _run("repro_torch.launch.serve", "--arch", arch, "--shape", shape,
               "--dry-run", "--device", "cpu", timeout=120)
    assert out.returncode == 0, out.stderr
    assert ("[ok]" in out.stdout) == (status == "ok")
    assert "[ERR]" not in out.stdout
