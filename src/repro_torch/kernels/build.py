"""Build and load the port's CUDA kernel libraries.

Each kernel's CUDA source under ``csrc/`` is compiled by ``nvcc`` for
``sm_90a`` into its own shared library with a plain C interface, at first
use, into ``build/kernels`` at the repository root (a directory git
ignores), and loaded with ctypes. A library's file name carries a hash of
its source and of every header it includes from ``csrc/`` (``#include
"name.cuh"``), so an edited source or header is rebuilt and a stale library
is never loaded; the output is written under a temporary name and renamed into
place, so a concurrent or interrupted build never leaves a partial library.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the port's kernels are built "
                           "from source and need the CUDA toolkit")
    return path


class KernelLibrary:
    """One ``csrc/<name>.cu`` source and the library built from it.

    ``build_seconds`` is the wall time of this process's nvcc run (None
    while the library was already built). ``load`` builds if needed, opens
    the library once and hands it to ``bind`` to set argument types."""

    def __init__(self, name: str, bind):
        self.name = name
        self.source = CSRC / f"{name}.cu"
        self.bind = bind
        self.build_seconds = None
        self._lib = None

    def sources(self) -> list[Path]:
        """The ``.cu`` source and the local headers it includes, directly or
        through another header, in the order first included."""
        found, todo = [], [self.source]
        while todo:
            path = todo.pop(0)
            if path in found:
                continue
            found.append(path)
            todo += [path.parent / name for name in _INCLUDE.findall(
                path.read_text()) if (path.parent / name).exists()]
        return found

    def library_path(self) -> Path:
        digest = hashlib.sha256()
        for path in self.sources():
            digest.update(path.read_bytes())
        return BUILD_DIR / f"lib{self.name}-{digest.hexdigest()[:12]}.so"

    def build(self) -> Path:
        """Compile the library if this source has not been built yet."""
        lib = self.library_path()
        if lib.exists():
            return lib
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(self.source)],
            capture_output=True, text=True)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed on {self.source.name} "
                               f"({proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, lib)
        self.build_seconds = time.perf_counter() - t0
        return lib

    def load(self):
        if self._lib is None:
            lib = ctypes.CDLL(str(self.build()))
            self.bind(lib)
            self._lib = lib
        return self._lib
