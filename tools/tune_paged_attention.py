#!/usr/bin/env python3
"""Time variants of the two paged-attention kernels on one card.

  python3 tools/tune_paged_attention.py [NAME ...]

A variant is a copy of ``src/repro_torch`` and ``chip_smoke.py`` under
``build/tune/<name>/`` with text patches applied to its kernel sources
(``VARIANTS``; "base" is the shipped code, unpatched), so the shipped
sources keep no switch for any of them. Each variant runs in a process of
its own from its copy: the copy's wrappers build its libraries into the
copy's ``build/kernels`` and launch them as the port does. Variants run in
turns (a, b, ..., b, a) so drift on the card shows. Each turn prints the
device time (CUDA graph) of both kernels at the serving shape (B 8, H 32,
K 8, D 128, page 16, length 256) and the long shape (length 4096), bf16 q,
with the bound and the share of the bound; the first turn of a variant
prints the registers and local-memory bytes of its serving instantiation
(cuobjdump), and the first turn of all a contiguous read of the same K/V
bytes as a yardstick. A variant that leaves work out (no_math, no_copies)
is timed but not checked against the plain version.
"""
from __future__ import annotations

import importlib
import os
import re
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = "src/repro_torch/kernels/csrc/"
COMMON = CSRC + "paged_attention_common.cuh"
KERNELS = (CSRC + "paged_attention.cu", CSRC + "paged_attention_int8.cu")

# name -> [(file, text, replacement)]; each text must occur exactly once
VARIANTS = {
    "base": [],
    "splits16": [(COMMON, "constexpr int kMaxSplits = 8;",
                  "constexpr int kMaxSplits = 16;")],
    "no_math": [(f, "    attend_page<", "    if (false) attend_page<")
                for f in KERNELS],
    "no_copies": [(f, "    if (i < n_pages) {", "    if (false) {")
                  for f in KERNELS] +
                 [(f, "    ring.wait(i);\n", "") for f in KERNELS],
}
PROBES = {"no_math", "no_copies"}      # leave work out: timed, not checked


def make_copy(name: str) -> str:
    dst = os.path.join(ROOT, "build", "tune", name)
    shutil.rmtree(os.path.join(dst, "src"), ignore_errors=True)
    shutil.copytree(os.path.join(ROOT, "src", "repro_torch"),
                    os.path.join(dst, "src", "repro_torch"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), dst)
    for rel, old, new in VARIANTS[name]:
        path = os.path.join(dst, rel)
        text = open(path).read()
        if text.count(old) != 1:
            raise RuntimeError(f"{name}: {old!r} is not once in {rel}")
        with open(path, "w") as f:
            f.write(text.replace(old, new))
    return dst


def resources(nvcc: str, lib: str) -> str:
    """Registers and local-memory bytes of the serving instantiation (bf16
    q, a tile of 4 heads, 16 lanes per row) as cuobjdump reads them."""
    tool = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    try:
        out = subprocess.run([tool, "-res-usage", lib], capture_output=True,
                             text=True, check=True).stdout
    except (OSError, subprocess.CalledProcessError) as e:
        return f"not read ({e})"
    lines = out.splitlines()
    for i, line in enumerate(lines[:-1]):
        if re.search(r"kernelI13__nv_bfloat16Li4ELi16E", line):
            m = re.search(r"REG:(\d+).*LOCAL:(\d+)", lines[i + 1])
            if m:
                return f"{m.group(1)} registers, {m.group(2)} B local"
    return "not read (no serving instantiation found)"


def run_variant(name: str, first: bool, yardstick: bool):
    """One turn of one variant, inside its copy (the current directory)."""
    sys.path.insert(0, os.getcwd())
    C = importlib.import_module("chip_smoke")
    import torch
    from repro_torch.kernels import build as KB
    from repro_torch.kernels import paged_attention as PA
    from repro_torch.kernels import paged_attention_int8 as PA8

    torch.backends.cuda.matmul.allow_tf32 = False
    C.device_line()
    refs = {PA: C.paged_attention_ref, PA8: C.paged_attention_int8_ref}
    fns = {PA: PA.paged_attention, PA8: PA8.paged_attention_int8}
    for m in (PA, PA8):
        lib = str(m.build())
        if first:
            print(f"{name} {C.kname(m)}: {resources(KB._nvcc(), lib)}")
    for pps in (16, 256):
        shape = (8, 32, 8, 128, 16, pps, 8 * pps + 1)
        sets = {
            PA: [C.kernel_case(*shape, dtype=torch.bfloat16, seed=100 + j,
                               full=True)[:5]
                 for j in range(5 if pps == 16 else 1)],
            PA8: [C.int8_case(shape, torch.bfloat16, seed=100 + j,
                              full=True)[0][:7]
                  for j in range(12 if pps == 16 else 1)]}
        for m, s in sets.items():
            if m is PA:
                bound = C.bound_ms(s[0][0], s[0][1], s[0][4], None)[0]
            else:
                bound = C.bound_ms(s[0][0], s[0][1], s[0][6], None,
                                   scales=s[0][2])[0]
            if yardstick:
                kv = [s[0][1], s[0][3 if m is PA8 else 2]]
                n = sum(t[:, :8 * pps].numel() * t.element_size()
                        for t in kv)
                flat = torch.zeros(n // 4, dtype=torch.float32,
                                   device="cuda")
                ms = C.graph_ms(lambda w: w.sum(), [(flat,)])
                print(f"yardstick: contiguous f32 sum over {n} B (the K/V "
                      f"bytes of {C.kname(m)} at length {pps * 16}): "
                      f"{ms * 1e3:.2f} us, {n / ms / 1e9:.2f} TB/s")
            if name not in PROBES:
                want = refs[m](*s[0]).float()
                err = float((fns[m](*s[0]).float() - want).abs().max())
                C.check(err <= C.TOL[torch.bfloat16], f"{name}: error {err}")
            ms = C.graph_ms(fns[m], s)
            print(f"{name:10s} {C.kname(m):22s} length {pps * 16:5d}: "
                  f"{ms * 1e3:.2f} us; bound {bound * 1e3:.2f} us; share "
                  f"{bound / ms:.3f}", flush=True)


def main(argv):
    if argv[:1] == ["--run"]:
        run_variant(argv[1], argv[2] == "1", argv[3] == "1")
        return 0
    names = argv or list(VARIANTS)
    dirs = {n: make_copy(n) for n in names}
    seen = set()
    for i, n in enumerate(names + names[::-1]):
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--run", n,
             str(int(n not in seen)), str(int(i == 0))], cwd=dirs[n])
        seen.add(n)
        if proc.returncode:
            return proc.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
