#!/usr/bin/env python3
"""What the prefill's fixed row blocks buy and cost, on one card.

  python3 tools/prefill_blocks.py

``paged_decode.PREFILL_ROWS`` makes every prefill product run over blocks
of 64 rows and the prefill's attention over 64-row query chunks, so a
monolithic prefill and a chunked one (chunks of 64) launch the same
shapes and give each row the same bits. This script sets it to 64, then to
0 (one product over all rows, 1024-row query chunks, as before the
blocks), and for llama3-8b (32 layers), deepseek-67b (24 of 95) and
mixtral-8x7b (8 of 32), full width, random weights, a 200-token prompt in
bucket 256, prints: whether chunks of 64 give the monolithic prefill's
logits and K rows bit for bit, and each setting's prefill wall time
(synchronised host clock, 6 calls a setting in alternating turns, after
one warm-up each). It needs a CUDA card.
"""
from __future__ import annotations

import dataclasses
import gc
import os
import statistics
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.models import paged_decode as PD  # noqa: E402

CONFIGS = (("llama3-8b", 32), ("deepseek-67b", 24), ("mixtral-8x7b", 8))
N, BUCKET, CHUNK = 200, 256, 64


def prefill(cfg, params, toks, rows: int, chunked: bool):
    """(logits, K rows < N) of one prefill with ``PREFILL_ROWS = rows``."""
    PD.PREFILL_ROWS = rows
    q_chunk = rows or 1024
    if not chunked:
        logits, k, _ = PD.prefill_bucketed(cfg, params, toks, N,
                                           q_chunk=q_chunk)
        return logits, k[:, :N]
    kb, vb = PD.init_chunk_buffers(cfg, BUCKET, device="cuda")
    for c0 in range(0, N, CHUNK):
        logits, kb, vb = PD.prefill_chunk(
            cfg, params, toks[:, c0:c0 + CHUNK], c0, min(CHUNK, N - c0), kb,
            vb, q_chunk=min(q_chunk, CHUNK))
    return logits, kb[:, :N].to(PD.kv_dtype(cfg))


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    for name, depth in CONFIGS:
        cfg = dataclasses.replace(get_config(name), n_layers=depth)
        params = api.init_params(
            cfg, torch.Generator("cuda").manual_seed(0), device="cuda")
        toks = torch.zeros((1, BUCKET), dtype=torch.int32, device="cuda")
        toks[0, :N] = torch.randint(
            1, cfg.vocab_size, (N,), device="cuda",
            generator=torch.Generator("cuda").manual_seed(1))
        for rows in (64, 0):
            (lm, km), (lc, kc) = (prefill(cfg, params, toks, rows, c)
                                  for c in (False, True))
            print(f"{name} ({depth} layers), PREFILL_ROWS {rows}: chunks of "
                  f"{CHUNK} equal monolithic bit for bit: logits "
                  f"{torch.equal(lm, lc)}, K rows {torch.equal(km, kc)}")

        def wall(rows):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            prefill(cfg, params, toks, rows, chunked=False)
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) * 1e3
        times = {64: [], 0: []}
        for i in range(6):
            for rows in ((64, 0) if i % 2 == 0 else (0, 64)):
                times[rows].append(wall(rows))
        print(f"{name} ({depth} layers) monolithic prefill wall, bucket "
              f"{BUCKET}: 64-row blocks median "
              f"{statistics.median(times[64]):.2f} ms "
              f"{[round(t, 2) for t in times[64]]}; one product median "
              f"{statistics.median(times[0]):.2f} ms "
              f"{[round(t, 2) for t in times[0]]}")
        PD.PREFILL_ROWS = 64
        del params
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
