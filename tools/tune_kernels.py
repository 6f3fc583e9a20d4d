#!/usr/bin/env python3
"""Time build-time variants of the port's CUDA kernels on one card, and read
what the compiler gave them.

  python3 tools/tune_kernels.py attention [NAME ...]   # paged attention
  python3 tools/tune_kernels.py ssd_scan [NAME ...]    # the SSD scan
  python3 tools/tune_kernels.py resources [SOURCE ...] # ptxas's report
  python3 tools/tune_kernels.py mma_rate               # mma.sync's rate

A variant is a copy of ``src/repro_torch`` and ``chip_smoke.py`` under
``build/tune/<kernel>/<name>/`` with text patches applied to its kernel
sources (``VARIANTS``; "base" is the shipped code, unpatched), so the
shipped sources keep no switch for any of them. Every copy is built at once
(one process per copy, each its own ``nvcc`` runs), then each variant runs
in a process of its own from its copy, whose wrappers launch its libraries
as the port does. Variants run in turns (a, b, ..., b, a) so drift on the
card shows. The first turn of a variant prints ptxas's registers, stack and
spills for its sources and, unless the variant is a probe (it leaves work
out), its error against the plain version; every turn prints device times
(CUDA graph) with the bound and the share of the bound:

- ``attention``: both kernels at the serving shape (B 8, H 32, K 8, D 128,
  page 16, length 256) and the long shape (length 4096), bf16 q; the first
  turn of all also times a contiguous read of the same K/V bytes as a
  yardstick. Probes: ``no_math``, ``no_copies``.
- ``ssd_scan``: one call at the serving shape (b 8, s 512, h 24, p 64,
  n 128, chunk 256, B and C bf16, two input sets), with the grid. Probes
  ``no_loads``, ``no_off``, ``no_update``, ``no_diag``, ``no_cb_pass``
  leave out the loads, one of the three products or the C·Bᵀ pass.

``resources`` compiles each ``csrc/<SOURCE>.cu`` of the tree (all when none
is named) with the flags of ``kernels/build.py`` plus ``-Xptxas -v`` and
prints ptxas's lines per kernel; dynamic shared memory is set at launch
and does not appear there. ``mma_rate`` runs, in every warp of 132 x 8
blocks of 4 warps, 8 independent accumulator chains of one ``mma.sync``
shape and prints TFLOP/s for m16n8k8 TF32 (the scan's products) and
m16n8k16 bf16 beside the card's dense tensor-core peak for that type.
Everything here needs ``nvcc``; all but ``resources`` need a card.
"""
from __future__ import annotations

import ctypes
import importlib
import os
import re
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOL = os.path.abspath(__file__)
CSRC = "src/repro_torch/kernels/csrc/"
_PA = (CSRC + "paged_attention.cu", CSRC + "paged_attention_int8.cu")
_SSD = CSRC + "ssd_scan.cu"

# kernel -> {variant: [(file, text, replacement)]}; each text must occur
# exactly once in its file
VARIANTS = {
    "attention": {
        "base": [],
        "splits16": [(CSRC + "paged_attention_common.cuh",
                      "constexpr int kMaxSplits = 8;",
                      "constexpr int kMaxSplits = 16;")],
        "no_math": [(f, "    attend_page<", "    if (false) attend_page<")
                    for f in _PA],
        "no_copies": [(f, "    if (i < n_pages) {", "    if (false) {")
                      for f in _PA] + [(f, "    ring.wait(i);\n", "")
                                       for f in _PA],
    },
    "ssd_scan": {
        "base": [],
        "no_loads": [
            (_SSD, "      if (tid == 0) arm_bc<T>(args, bars + ((c + 1) & 1));",
             ""),
            (_SSD, "      fill_x(args, stage(c + 1), c + 1, b, h, p0, tid);",
             "      ;"),
            (_SSD, "    if (c + 1 < args.n_sub) fill_b_c(c + 1);", ""),
            (_SSD, "    bar_wait(bars + (c & 1), (c >> 1) & 1);",
             "    if (c == 0) bar_wait(bars + (c & 1), (c >> 1) & 1);")],
        "no_off": [(_SSD, "        Frag<2, false> sb[2];",
                    "        if (true) break;\n        Frag<2, false> sb[2];")],
        "no_update": [(_SSD, "mma_term<false, true>(k, st[4 * q4 + e], fx, "
                       "fb[e]);", ";")],
        "no_diag": [(_SSD, "      if (k2 > mi) break;",
                     "      if (true) break;")],
        "no_cb_pass": [(_SSD, "  cb_kernel<<<", "  if (false) cb_kernel<<<")],
        # the scan launched after the C·Bᵀ pass ends (no programmatic launch)
        "no_pdl": [(_SSD, "programmaticStreamSerializationAllowed = 1;",
                    "programmaticStreamSerializationAllowed = 0;")],
        # B's and C's tensor copies both issued by thread 0
        "tma_one": [(_SSD, "               tid == 0, tid == 32);",
                     "               tid == 0, tid == 0);")],
        # shared memory padded so that 1 scan block holds an SM (4 otherwise)
        "occupancy1": [(_SSD, "         kYpartBytes + 16;",
                        "         kYpartBytes + 16 + 60000;")],
    },
}
PROBES = {"no_math", "no_copies", "no_loads", "no_off", "no_update",
          "no_diag", "no_cb_pass"}
SOURCES = {"attention": ("paged_attention", "paged_attention_int8"),
           "ssd_scan": ("ssd_scan",)}


def make_copy(kernel: str, name: str) -> str:
    dst = os.path.join(ROOT, "build", "tune", kernel, name)
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(os.path.join(ROOT, "src", "repro_torch"),
                    os.path.join(dst, "src", "repro_torch"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), dst)
    for rel, old, new in VARIANTS[kernel][name]:
        path = os.path.join(dst, rel)
        text = open(path).read()
        if text.count(old) != 1:
            raise RuntimeError(f"{name}: {old!r} is not once in {rel}")
        with open(path, "w") as f:
            f.write(text.replace(old, new))
    return dst


def _build_module(root: str):
    sys.path.insert(0, os.path.join(root, "src"))
    from repro_torch.kernels import build as KB
    return KB


def ptxas_report(source: str, out_dir: str) -> list[str]:
    """ptxas's registers, stack and spill lines for one source, each
    kernel's name demangled by c++filt where it is installed."""
    from repro_torch.kernels import build as KB
    os.makedirs(out_dir, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        proc = subprocess.run(
            [KB._nvcc(), *KB.NVCC_FLAGS, "-Xptxas", "-v", "-o",
             os.path.join(tmp, "lib.so"), source],
            capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on {source}:\n{proc.stderr}")
    lines = []
    for line in proc.stderr.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            try:
                line = "kernel " + subprocess.run(
                    ["c++filt", m.group(1)], capture_output=True, text=True,
                    check=True).stdout.strip()
            except (OSError, subprocess.CalledProcessError):
                line = "kernel " + m.group(1)
        elif not re.search(r"Used \d+ registers|bytes stack frame", line):
            continue
        lines.append(line.replace("ptxas info    : ", "  "))
    return lines


def prepare(kernel: str):
    """Inside a copy: build its libraries and keep ptxas's report."""
    KB = _build_module(os.getcwd())
    lines = []
    for src in SOURCES[kernel]:
        importlib.import_module(f"repro_torch.kernels.{src}").build()
        lines += ptxas_report(str(KB.CSRC / f"{src}.cu"),
                              os.path.join("build", "resources"))
    with open("resources.txt", "w") as f:
        f.write("\n".join(lines) + "\n")


def run_attention(C, name: str, yardstick: bool):
    import torch
    from repro_torch.kernels import paged_attention as PA
    from repro_torch.kernels import paged_attention_int8 as PA8

    refs = {PA: C.paged_attention_ref, PA8: C.paged_attention_int8_ref}
    fns = {PA: PA.paged_attention, PA8: PA8.paged_attention_int8}
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


def run_ssd_scan(C, name: str, first: bool):
    import torch
    from repro_torch.kernels import ssd_scan as SSD

    sets = [C.ssd_case(C.SSD_SERVE, torch.bfloat16, seed=100 + j)[:4]
            for j in range(2)]
    chunk = C.SSD_SERVE[-1]

    def kernel(x, a, B, C_):
        return SSD.ssd_scan(x, a, B, C_, chunk=chunk)

    if first:
        grid = SSD.grid_blocks(*C.SSD_SERVE[:5])
        print(f"{name} ssd_scan: {grid['scan']} scan blocks, "
              f"{grid['scan_blocks_per_sm']} per SM")
        if name not in PROBES:
            y, hf = kernel(*sets[0])
            ry, rh = C.ssd_scan_ref(*sets[0])
            err_y, over_y = C.ssd_error(y, ry)
            err_h, over_h = C.ssd_error(hf, rh)
            print(f"{name} ssd_scan: max_abs_err y {err_y:.3e}, state "
                  f"{err_h:.3e}")
            C.check(max(over_y, over_h) <= 0, f"{name}: outside SSD_TOL")
    bound = C.ssd_bound_ms(sets[0][0], sets[0][2])["tensor_cores"][0]
    ms = C.graph_ms(kernel, sets)
    print(f"{name:12s} ssd_scan serving shape: {ms * 1e3:.2f} us; bound "
          f"{bound * 1e3:.2f} us; share {bound / ms:.3f}", flush=True)


def run_variant(kernel: str, name: str, first: bool, turn: int):
    """One turn of one variant, inside its copy (the current directory)."""
    sys.path.insert(0, os.getcwd())
    C = importlib.import_module("chip_smoke")
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    C.device_line()
    if first:
        print(f"{name}: ptxas\n" + open("resources.txt").read(), end="")
    if kernel == "attention":
        run_attention(C, name, yardstick=turn == 0)
    else:
        run_ssd_scan(C, name, first)


def tune(kernel: str, names) -> int:
    names = names or list(VARIANTS[kernel])
    dirs = {n: make_copy(kernel, n) for n in names}
    builds = [subprocess.Popen([sys.executable, TOOL, "--prepare", kernel],
                               cwd=d) for d in dirs.values()]
    if any([b.wait() for b in builds]):
        return 1
    seen = set()
    for i, n in enumerate(names + names[::-1]):
        proc = subprocess.run(
            [sys.executable, TOOL, "--run", kernel, n,
             str(int(n not in seen)), str(i)], cwd=dirs[n])
        seen.add(n)
        if proc.returncode:
            return proc.returncode
    return 0


MMA_SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>

template <int kShape>
__global__ void __launch_bounds__(128) mma_loop(float* out, int steps,
                                                uint32_t seed) {
  float d[8][4] = {};
  uint32_t a[4], b[2];
  for (int i = 0; i < 4; ++i) a[i] = seed * (threadIdx.x + 3 * i);
  for (int i = 0; i < 2; ++i) b[i] = seed ^ (threadIdx.x + i);
  for (int s = 0; s < steps; ++s) {
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      if (kShape == 0)
        asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
            "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
            : "+f"(d[c][0]), "+f"(d[c][1]), "+f"(d[c][2]), "+f"(d[c][3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]),
              "r"(b[1]));
      else
        asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
            "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
            : "+f"(d[c][0]), "+f"(d[c][1]), "+f"(d[c][2]), "+f"(d[c][3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]),
              "r"(b[1]));
    }
  }
  float sum = 0.f;
  for (int c = 0; c < 8; ++c)
    for (int i = 0; i < 4; ++i) sum += d[c][i];
  out[blockIdx.x * blockDim.x + threadIdx.x] = sum;
}

extern "C" int mma_rate_launch(int shape, void* out, int blocks, int steps,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (shape == 0)
    mma_loop<0><<<blocks, 128, 0, s>>>(static_cast<float*>(out), steps, 7u);
  else
    mma_loop<1><<<blocks, 128, 0, s>>>(static_cast<float*>(out), steps, 7u);
  return (int)cudaGetLastError();
}
"""


def mma_rate() -> int:
    import torch
    KB = _build_module(ROOT)
    out_dir = os.path.join(ROOT, "build", "mma_rate")
    os.makedirs(out_dir, exist_ok=True)
    src, path = (os.path.join(out_dir, n) for n in ("mma_rate.cu",
                                                    "libmma_rate.so"))
    with open(src, "w") as f:
        f.write(MMA_SOURCE)
    subprocess.run([KB._nvcc(), *KB.NVCC_FLAGS, "-o", path, src], check=True)
    lib = ctypes.CDLL(path)
    lib.mma_rate_launch.argtypes = [ctypes.c_int, ctypes.c_void_p,
                                    ctypes.c_int, ctypes.c_int,
                                    ctypes.c_void_p]
    lib.mma_rate_launch.restype = ctypes.c_int
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    blocks, steps = 132 * 8, 4096
    out = torch.empty(blocks * 128, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    for shape, name, flop, peak in ((0, "m16n8k8 TF32", 2 * 16 * 8 * 8, 495),
                                    (1, "m16n8k16 bf16", 2 * 16 * 8 * 16,
                                     989)):
        for _ in range(2):                  # warm-up
            lib.mma_rate_launch(shape, out.data_ptr(), blocks, steps, stream)
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        rc = lib.mma_rate_launch(shape, out.data_ptr(), blocks, steps, stream)
        e1.record()
        e1.synchronize()
        if rc:
            raise RuntimeError(f"launch failed: CUDA error {rc}")
        ms = e0.elapsed_time(e1)
        total = blocks * 4 * steps * 8 * flop
        print(f"mma.sync {name} [{card}]: {total / ms / 1e9:.1f} TFLOP/s "
              f"({ms * 1e3:.1f} us for {blocks * 4 * steps * 8} MMAs per "
              f"card); dense peak {peak} TFLOP/s")
    return 0


def resources(names) -> int:
    KB = _build_module(ROOT)
    names = names or sorted(p.stem for p in KB.CSRC.glob("*.cu"))
    for name in names:
        print(f"== {name}.cu")
        for line in ptxas_report(str(KB.CSRC / f"{name}.cu"),
                                 os.path.join(ROOT, "build", "resources")):
            print(line)
    return 0


def main(argv) -> int:
    if argv[:1] == ["--prepare"]:
        prepare(argv[1])
        return 0
    if argv[:1] == ["--run"]:
        run_variant(argv[1], argv[2], argv[3] == "1", int(argv[4]))
        return 0
    if argv[:1] == ["resources"]:
        return resources(argv[1:])
    if argv[:1] == ["mma_rate"]:
        return mma_rate()
    if argv[:1] and argv[0] in VARIANTS:
        return tune(argv[0], argv[1:])
    print(__doc__, file=sys.stderr)
    return 2


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
