#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

  python3 chip_smoke.py
  python3 chip_smoke.py --drill-only    # phase 20 alone (after 1)

Phases (each raises, and the script exits non-zero, if its check fails):

  1. device   — a CUDA card is required; prints its name and power limit;
                TF32 off for matmuls and convolutions.
  2. build    — compiles the three kernel libraries (paged attention, bf16
                and int8 pools; the Mamba-2 SSD scan) from
                src/repro_torch/kernels/csrc/ with nvcc (sm_90a), one nvcc
                process per source, started together.
  3. kernel   — holds the bf16 paged-attention kernel against its plain
                PyTorch version at the serving shape (B=8, H=32, K=8, D=128,
                page 16, 16 pages, bf16, ragged lengths, with and without
                window starts, fully masked pages), in f32, at the reduced
                test shape (page 8, D 64) and at the long shape (256 pages,
                lengths up to 4096); at lengths 1 and around split
                boundaries with starts that mask whole splits; checks batch
                invariance (one sequence alone, in a batch of 8, in another
                slot over other pages: equal bits; two calls equal); times
                kernel and plain version at the serving and the long shape
                in a CUDA graph (device time, bound, share of the bound),
                and, for information only, scaled_dot_product_attention
                over K/V already gathered into contiguous tensors.
  4. kernel (int8) — the same for the int8 kernel over quantized pages
                (q in bf16 and f32, all shapes, one all-zero row with
                scale 1), and quantize_pages on the card against the CPU,
                bit for bit.
  5. kernel (head geometries) — both attention kernels at the decode head
                geometries of the dense configs: yi-9b (H 32, K 4, D 128) and
                deepseek-67b (H 64, K 8, D 128), rep 8, the 8-head tile;
                qwen1.5-0.5b (H 16, K 16, D 64) and qwen1.5-32b (H 40, K 40,
                D 128), rep 1; dbrx-132b (H 48, K 8, D 128), rep 6: 6 of
                the 8-head tile's heads live; recurrentgemma-9b's local
                attention (H 16, K 1, D 256), rep 16: two 8-head tiles of 32
                lanes a row; B 8, page 16, lengths up to 256 and 4096 (2048,
                the window, for recurrentgemma-9b), q bf16 and f32, with and
                without window starts, against the plain versions; then each
                geometry, and llama3-8b's (rep 4, for comparison), timed in
                a CUDA graph with bound and share; ptxas's registers and
                spills of the D 256 instantiations (nvcc -Xptxas -v, run
                beside the build).
  6. kernel (ssd_scan) — the SSD scan kernels (the C·Bᵀ pass, then the
                scan) against the plain sequential version and the plain
                chunked form, at the full-width mamba2-130m shape (b 8,
                s 512, h 24, p 64, n 128, chunk 256; B and C bf16, then
                f32; with an initial state), a ragged chunk = s = 200, the
                reduced shape (h 16, p 32, n 32, chunk 32), p 24 and 40
                (not a multiple of the 16-row P tile), p 16 (one P tile),
                s 33, 64 and 65 at chunk = s (around a 32-position
                sub-chunk) and B and C rows that start off a 16-byte
                boundary; two calls must give equal bits; the precision of
                f32, plain TF32 and split TF32 products against an f64
                recurrence; times kernel and plain versions in a CUDA graph
                with the grid size, and both bounds (f32 CUDA cores, tensor
                cores) with the share of each.
  7. serving  — the port's HTTP server with full-width Llama-3.1-8B (random
                weights from a seeded torch.Generator), 2 instances, ring
                replication on; concurrent completions, greedy determinism,
                TTFT / per-token latency / tokens per second.
  8. failover — the same prompts again; an instance kill through
                /v1/admin/fault while they decode; every stream must equal
                the failure-free one, with at least one migration.
  9. decode profile — one instance's decode step called directly: wall
                time, device-busy time and op count (torch.profiler), and
                the synchronizing calls one step makes.
  10.-12. serving, failover and decode profile again on a second service
                built from the SAME weights with the int8 KV pool and
                chunked prefill (chunks of 64); the kill may restart only
                requests caught mid-prefill on the victim.
  13. cold reference — a shared-prefix prompt set (a 128-token prefix, 8
                pages, with distinct tails; every prompt 129-256 tokens, one
                prefill bucket; one diverges inside page 7, one repeats
                another) served on the same weights with the prefix cache
                off, chunks of 64: one primer, then 8 requests concurrently
                (the 8th a 120-token prefix of the prefix, bucket 128), then
                4 drill prompts. Its streams are what phases 14-15 must
                give; TTFTs for information.
  14. prefix cache — the same traffic with prefix_cache=True: every stream
                equal to cold; hits, skipped prompt compute, copy-on-write,
                each shared page shipped once per ring target that lacked
                it (copies == hosted pages, ship ratio <= 1); the
                cross-bucket follower's stream and page difference reported,
                not asserted; then a kill of the busier instance (if_busy)
                with the batch in flight: streams equal cold, the survivor
                still resolves the 8-page chain.
  15. disaggregated — disaggregate=True with the prefix cache on: instance
                0 prefills, instance 1 decodes; streams equal cold,
                2,097,152 B per handoff block, one seat per request, no
                decode step (so no attention kernel) on the prefill side;
                then, with the service loop paused and the engine stepped
                to the state each drill needs, the prefill instance killed
                while a drill prompt streams (resumed on the decode side)
                and, after it rejoins, the decode instance killed while it
                decodes and handoffs stream to it (victims migrate, the
                handoffs seat on the survivor): streams equal cold.
  16. fleet   — the same weights served by 8 instances (4 slots of 256
                tokens, 4 shards each, rendezvous placement, warm spares 3 s
                after a kill): 24 concurrent prompts of 16-200 tokens, 32
                greedy tokens each, failure-free — the reference streams.
  17. fleet chaos — the 24 again; instances 0, 1 and 2 killed together
                through /v1/admin/fault while they decode; once instance 0's
                spare rejoins, a second wave of 8 prompts, and instance 0
                killed again as soon as it decodes one. Every stream equals
                failure-free serving, no request is dropped, at least one
                victim resumes from its replica, and the fleet heals (8
                alive, epoch +8, an empty plan); MTTR per event and the
                wall time of each warm-spare rejoin printed.
  18. shard degraded — 25 prompts, the engine stepped by hand until an
                instance holds 4 decoding, replicated requests; shard 1 of
                it lost through /v1/admin/fault: /health shows it DEGRADED
                (lost_shards [1], slot_cap 3, the layout over 3 shards), the
                excess request migrates, it never seats more than 3; a shard
                recover restores it HEALTHY at full capacity; every stream
                equals failure-free serving. Then one cold init_params +
                executor build of Llama-3.1-8B, timed, for comparison.
  19. decoupled init — the same weights resident on every node of a
                2 x 4 group (metadata pools); the port's CommunicatorManager
                builds a FamilyExecutor per new topology and runs one
                bucketed prefill (200 tokens) and one decode step: the
                initial form, a re-form with stage 2 on instance 1's node
                and the return to the first topology (a cache hit) timed;
                one cache hit and two builds, every parameter's data_ptr
                unchanged, allocated memory after the re-form within 5% of
                the weights' bytes, equal decode logits on both topologies;
                for information, the fleet phase's cold init and a timed
                copy of the weights' bytes from pinned host memory.
  20. open-loop failure drill — a ShareGPT-shaped Poisson workload (1.5
                req/s over 20 s, prompts of mean 220 up to 448 tokens,
                outputs of mean 64 up to 128; the port's poisson_workload
                and attach_prompt_tokens) replayed open-loop through
                EngineService (2 instances, 8 slots, chunks of 64, warm
                spares 0.5 s after a kill, a 10 s reload stall under
                standard): failure-free under kevlarflow (the reference
                streams), then instance 0 killed at 8 s under kevlarflow
                and under standard recovery. Every request completes and
                every stream equals its failure-free stream; kevlarflow
                migrates and restarts only mid-prefill victims, standard
                restarts and migrates none. Per run: MTTR, latency and TTFT
                (avg, p99), TPOT, goodput, retries, migrations; then the
                standard / kevlarflow ratios. If the failure-free p99 TTFT
                exceeds 2 s, all three run again at half the rate.
  21. dense configs — after freeing Llama's weights: yi-9b (48 layers),
                qwen1.5-0.5b (24), qwen1.5-32b (all 64 layers, int8
                pool) and deepseek-67b (52 of its 95 layers), full width,
                random weights: served twice (equal streams), an instance
                kill (streams equal failure-free), the replication block
                bytes checked, TTFT / latency / tokens per second, and a
                decode-step profile.
  22. moe config mixtral-8x7b — full width, 26 of 32 layers (the
                deepest that fits; the peak is printed), fresh random
                weights: the Llama prompt set served twice over HTTP, an
                instance kill, the decode profile (synchronizing calls per
                step equal to the dense step's), and the MoE MLP alone at
                B 8: device time per layer and step beside its weight-read
                bound.
  23. moe invariants / moe window mixtral-8x7b — engines stepped by hand,
                every stream bit for bit: chunked prefill (chunks of 64)
                equal to the monolithic streams of phase 22; the
                shared-prefix set with the prefix cache equal to cold; the
                int8 pool with chunks of 64 through a kill equal to the same
                path without it (and its decode profile); then two
                4000-token prompts, 128 greedy tokens each, past the
                4096-token window: pages recycle (retire messages, at most
                257 resident), and a kill after the slide resumes both
                streams byte-identically.
  24. moe config dbrx-132b — after freeing mixtral: 11 of 40 layers, the
                same serving, kill, decode and MoE MLP profiles as phase 22.
  25. hybrid config recurrentgemma-9b — after freeing dbrx: full width and
                all 38 layers (26 RG-LRU, 12 local attention; fresh random
                weights): the Llama prompt set served twice over HTTP (equal
                streams), an instance kill (streams equal, a migration: the
                victim's state blob promoted), /health's replicated bytes
                equal to blocks x 196,608 B plus blobs x 1,703,936 B with
                at most one blob per request step, the decode profile, the
                RG-LRU layers' share of the step's device time, the step's
                weight-read bound (from the params, the f32 gate copies
                included) and the sequential RG-LRU scan's time and launches
                in prefill (256 and 2048 positions).
  26. hybrid invariants — engines stepped by hand, every stream bit for
                bit: chunked prefill (chunks of 64) equal to monolithic, the
                two prefills' state blobs equal (largest difference printed);
                the int8 pool with chunks of 64 through a kill equal to the
                same path without it (99,072 B blocks, 425,986 B blobs); the
                shared-prefix set with the prefix cache equal to cold (hits
                share pages, every prompt token recomputed) and
                disaggregated equal to colocated (one blob per handoff).
  27. hybrid window — two 2030-token prompts, 48 greedy tokens each, past
                the 2048-token window: pages recycle (retire messages, at
                most 129 resident), the kernels' window starts run at D 256,
                and a kill after the slide resumes both streams.
  28. mamba2 generation — full-width mamba2-130m (bf16, random weights from
                torch.Generator seed 0) through api.prefill and
                api.decode_step: 8 prompts of 512 tokens (2 chunks), then 8
                of 200 (one ragged chunk), 64 greedy tokens each, twice:
                identical streams, exactly 2 scan launches (C·Bᵀ pass and
                scan) per layer per prefill and no plain scan; in f32,
                kernel prefill against the plain chunked form, and forward
                at t against prefill(:t) plus one decode step; prefill and
                decode-step profiles.
  29. summary — the head-geometry timings, one JSON line of kernels, the
                card line, and the final {"ok": true, "device": ...} line.

Each path's kernel launch counts are set to 0 just before the path and read
just after; launches made to compare a kernel with its plain version are
not counted. An attention call counts each CUDA kernel it launches: its
split pass and, over a table wide enough for two splits, its merge pass; a
scan call its C·Bᵀ pass and its scan.
"""
from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import gc
import json
import math
import os
import statistics
import subprocess
import sys
import threading
import time
import urllib.request
import warnings

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.cluster import build_group  # noqa: E402
from repro_torch.core.communicator import CommunicatorManager  # noqa: E402
from repro_torch.kernels import paged_attention as PA  # noqa: E402
from repro_torch.kernels import paged_attention_int8 as PA8  # noqa: E402
from repro_torch.kernels import ref as REF  # noqa: E402
from repro_torch.kernels import ssd_scan as SSD  # noqa: E402
from repro_torch.kernels.ref import (paged_attention_int8_ref,  # noqa: E402
                                     paged_attention_ref, ssd_scan_ref)
from repro_torch.models import (api, hybrid, moe, ssm,  # noqa: E402
                                transformer)
from repro_torch.models import paged_decode as PD  # noqa: E402
from repro_torch.models.transformer import layer_params  # noqa: E402
from repro_torch.serving.engine import (EngineConfig,  # noqa: E402
                                        FamilyExecutor, RealEngine)
from repro_torch.serving.api_types import FaultSpec  # noqa: E402
from repro_torch.serving.kvcache import PagedKVPool  # noqa: E402
from repro_torch.serving.request import (Request, RequestState,  # noqa: E402
                                         summarize)
from repro_torch.serving.server import EngineService, serve  # noqa: E402
from repro_torch.serving.workload import (attach_prompt_tokens,  # noqa: E402
                                          poisson_workload)

HBM_BYTES_PER_S = 3.35e12                     # H100 SXM, NVIDIA data sheet
PEAK_FLOPS = {torch.bfloat16: 989e12,         # dense tensor-core bf16
              torch.float32: 67e12}           # f32 outside the tensor cores
TF32_PEAK = 495e12                            # dense tensor-core TF32
TOL = {torch.bfloat16: 3e-2, torch.float32: 1e-5}
SERVE_SHAPE = (8, 32, 8, 128, 16, 16, 257)    # B, H, K, D, page, pps, P
LONG_SHAPE = (8, 32, 8, 128, 16, 256, 2049)   # every length 4096 when timed
REDUCED_SHAPE = (4, 4, 2, 64, 8, 32, 129)
SERVE_PROMPT_LENS = [16, 48, 96, 150, 200]
SSD_SERVE = (8, 512, 24, 64, 128, 256)        # b, s, h, p, n, chunk
SSD_REDUCED = (2, 96, 16, 32, 32, 32)
SSD_TOL = 2e-4        # rtol = atol: the reference's kernel-vs-oracle sweep
MAMBA_BATCH, MAMBA_PROMPTS, MAMBA_NEW = 8, (512, 200), 64
# f32 prefill logits, scan kernel against the plain chunked form. At the
# config's chunk of 256 the plain form's cumulative log decays reach
# hundreds (a = dt * A, A down to -16), where the f32 spacing (~3e-5) is
# lost from every exp(cum_i - cum_j); at chunk 32, the length of the
# kernel's sub-chunks, the sums stay small. Hence two limits: tight against
# chunk 32, loose against chunk 256.
MAMBA_PREFILL_TOL = {32: 5e-4, 256: 5e-3}
# forward at t against prefill(:t) + one decode step, f32. As the model
# runs, the prefill stores the conv state in bf16 (as the reference does),
# so the decode step sees the last three conv rows of every layer rounded
# to bf16; through 24 layers of this random model that moves the logits by
# up to ~5% of their range (on the card: 6.8e-2 at t = 511 and 0.136 at
# t = 199, |logits| <= 2.8; with f32 conv rows 5.2e-5 and 1.7e-5). The
# limit for the model as it runs is set at 9% of that range; with the conv
# state kept in f32 the same check isolates the algorithm at 1e-3.
MAMBA_SPLIT_TOL = {torch.bfloat16: 0.25, torch.float32: 1e-3}


def kname(mod) -> str:
    """A kernel wrapper module's short name ("paged_attention_int8")."""
    return mod.__name__.rsplit(".", 1)[-1]


def check(ok: bool, msg: str):
    if not ok:
        raise RuntimeError(f"check failed: {msg}")


T0 = time.perf_counter()


def phase(name: str):
    print(f"== {name} (at {time.perf_counter() - T0:.1f} s)", flush=True)


# -- 1. device ---------------------------------------------------------------

def device_line() -> str:
    check(torch.cuda.is_available(), "no CUDA device")
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


# -- 3. kernel ---------------------------------------------------------------

def kernel_case(b, h, kheads, d, page, pps, n_phys, dtype, seed, full=False):
    """Inputs on the card: ragged lengths 1..pps*page (sequence 0 ends in
    its first page, so its later pages are fully masked; the last one is
    full), window starts with page 0 fully masked for the last sequence.
    ``full`` sets every length to the whole table (the timed shape)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    rnd = lambda *s: torch.randn(s, generator=g, device="cuda").to(dtype)  # noqa: E731
    q = rnd(b, h, d)
    kp, vp = rnd(kheads, n_phys, page, d), rnd(kheads, n_phys, page, d)
    rng = np.random.default_rng(seed)
    tables = rng.permutation(n_phys)[: b * pps].reshape(b, pps)
    lengths = rng.integers(1, pps * page + 1, b)
    lengths[0] = min(lengths[0], page - 1)
    lengths[-1] = pps * page
    if full:
        lengths[:] = pps * page
    starts = rng.integers(0, lengths)
    starts[-1] = page + 1
    t = lambda a: torch.as_tensor(a.astype(np.int32), device="cuda")  # noqa: E731
    return q, kp, vp, t(tables), t(lengths), t(starts)


def bound_ms(q, kp, lengths, starts, scales=None):
    """Least time for this call: bytes it must move (valid K/V rows, with
    their scale rows on an int8 pool, q, out, one table entry per live
    page, lengths, starts) over the memory rate, or its FLOPs over the peak
    rate of its type — the larger."""
    b, h, d = q.shape
    kheads, _, page, _ = kp.shape
    ln = lengths.cpu().numpy().astype(np.int64)
    st = np.zeros_like(ln) if starts is None \
        else starts.cpu().numpy().astype(np.int64)
    tokens = int((ln - st).sum())
    live_pages = int((-(-ln // page) - st // page).sum())
    row_bytes = d * kp.element_size() + \
        (scales.element_size() if scales is not None else 0)
    nbytes = (2 * tokens * kheads * row_bytes
              + 2 * q.numel() * q.element_size()
              + 4 * (live_pages + 2 * b))
    flops = 4 * tokens * h * d
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[q.dtype]
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops \
        else "operations"


def time_ms(fn, inputs, reps=25, warmup=3):
    """Median over ``reps`` of CUDA-event time per eager call, each rep
    running ``fn`` once over every input set (the sets rotate so that the
    K/V pools do not stay resident in the 50 MB L2 between calls). Host
    dispatch is inside the window: a call whose Python side outlasts its
    kernel measures the host."""
    for _ in range(warmup):
        for args in inputs:
            fn(*args)
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for args in inputs:
            fn(*args)
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1) / len(inputs))
    return statistics.median(times)


def graph_ms(fn, inputs, reps=25):
    """Device time per call: one pass of ``fn`` over every input set is
    captured in a CUDA graph and replayed between CUDA events, so no host
    dispatch sits between the launches. Median over ``reps`` replays."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):               # warm-up off the capture
        for args in inputs:
            fn(*args)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for args in inputs:
            fn(*args)
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        graph.replay()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1) / len(inputs))
    return statistics.median(times)


def split_edge_lengths(page, width):
    """Length 1, and lengths just below, at and just above split boundaries
    of a table ``width`` pages wide: 2- and 4-page edges (runs of 2 pages
    while few pages are live), 16 and 32 pages (where the runs grow with
    the live page count), half the table."""
    edges = [e * page for e in (2, 4, 16, 32) if e < width] + \
        [width * page // 2]
    return [1] + [e + d for e in edges for d in (-1, 0, 1)]


def edge_case(shape, dtype, seed):
    """``kernel_case`` with the lengths of ``split_edge_lengths`` and window
    starts that mask whole splits: 4 pages + 1 where the length allows (the
    first two 2-page runs of a start-0 layout fully masked), else 0."""
    _, h, kheads, d, page, pps, _ = shape
    lengths = split_edge_lengths(page, pps)
    b = len(lengths)
    q, kp, vp, bt, _, _ = kernel_case(b, h, kheads, d, page, pps,
                                      b * pps + 1, dtype, seed)
    ln = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    st = torch.where(ln > 4 * page + 1, 4 * page + 1, 0).to(torch.int32)
    return q, kp, vp, bt, ln, st


def seq_errors(got, want, dtype):
    """max |got - want| of each sequence (dim 0), and each sequence's limit:
    TOL[dtype], and for bf16 also TOL[bf16] x that sequence's max |want|.
    bf16 rounds relative to a value's size, and a long sequence's attention
    outputs are far below 1 (about sqrt(e / length) for unit-normal
    inputs), where a fixed 3e-2 would pass a kernel that dropped pages."""
    err = (got.float() - want.float()).abs().flatten(1).amax(1)
    tol = torch.full_like(err, TOL[dtype])
    if dtype == torch.bfloat16:
        tol = torch.minimum(
            tol, TOL[dtype] * want.float().abs().flatten(1).amax(1))
    return err, tol


def launches_per_call(width) -> int:
    """CUDA kernels one attention call launches over a block table ``width``
    pages wide: the split pass, and the merge pass when a sequence can have
    two splits (more than kMinPagesPerSplit = 2 live pages)."""
    return 1 if width <= 2 else 2


def check_against_plain(label, kernel, plain, args, starts, dtype):
    got = kernel(*args, starts)
    torch.cuda.synchronize()
    want = plain(*args, starts)
    errs, tols = seq_errors(got, want, dtype)
    err = float(errs.max())
    worst = float((errs / tols).max())
    print(f"{label} starts={starts is not None}: max_abs_err {err:.3e} "
          f"(limit {TOL[dtype]:.0e}; the tightest sequence's limit "
          f"{float(tols.min()):.2e}; worst sequence at {worst:.3f} of its "
          f"limit)")
    check(math.isfinite(err) and bool((errs <= tols).all()),
          f"{label}: kernel disagrees with plain version: {err}")
    return err


def batch_invariance(label, kernel, pools, dtype):
    """One sequence's output alone (B = 1), inside a batch of 8 and in
    another slot over other physical pages holding the same bytes must be
    the same bits; two calls on the same inputs too. ``pools(kp, vp)``
    gives the pool arguments that follow q."""
    page, width = 16, 64
    q, kp, vp, bt, ln, st = kernel_case(8, 32, 8, 128, page, width,
                                        8 * width + 1, torch.float32, seed=7)
    ln[5], st[5] = 700, 37                   # 42 live pages: several splits
    n_phys = kp.shape[1]
    # the same bytes again on pages no table uses
    pool = pools(torch.cat([kp, kp], 1), torch.cat([vp, vp], 1))
    q = q.to(dtype)
    batch = kernel(q, *pool, bt, ln, st)
    again = kernel(q, *pool, bt, ln, st)
    alone = kernel(q[5:6].contiguous(), *pool, bt[5:6].contiguous(),
                   ln[5:6], st[5:6])
    idx = torch.tensor([0, 1, 5], device="cuda")
    moved_bt = torch.stack([bt[0], bt[1], bt[5] + n_phys])
    moved = kernel(q[idx].contiguous(), *pool, moved_bt.contiguous(),
                   ln[idx].contiguous(), st[idx].contiguous())
    torch.cuda.synchronize()
    same = [torch.equal(batch, again), torch.equal(alone[0], batch[5]),
            torch.equal(moved[2], batch[5])]
    print(f"{label} batch invariance, q {dtype}: two calls equal "
          f"{same[0]}; alone (B=1) == in batch of 8 {same[1]}; in slot 2 "
          f"over other pages == in batch {same[2]}")
    check(all(same), f"{label}: output depends on more than its own row")


def sdpa_ms(gathered):
    """Device time of scaled_dot_product_attention(..., enable_gqa=True)
    over (q (B, H, 1, D), k, v (B, K, S, D)) already contiguous: a yardstick
    only — not the same function (no page gather) and never called by the
    port."""
    import torch.nn.functional as F

    def fn(q, k, v):
        return F.scaled_dot_product_attention(q, k, v, enable_gqa=True)
    try:
        return graph_ms(fn, gathered)
    except (RuntimeError, TypeError) as e:
        print(f"sdpa on gathered K/V: not measured ({e})")
        return None


def gather(q, k, v, bt):
    """q (B, H, D), pools (K, P, page, D), tables -> SDPA's layout."""
    b = q.shape[0]
    kheads, _, page, d = k.shape

    def seq(x):
        x = x[:, bt.long()]                        # (K, B, pps, page, D)
        return x.permute(1, 0, 2, 3, 4).reshape(b, kheads, -1, d) \
            .contiguous()
    return q[:, :, None].contiguous(), seq(k), seq(v)


def time_shapes(label, kernel, plain, sets_by_shape, bound_fn, gathered_fn):
    """Device time of the kernel and its plain version at the serving and
    the long shape, the bound and the share of the bound, and SDPA's time
    over the same K/V gathered. Returns the serving shape's numbers."""
    out = {}
    for shape_name, sets in sets_by_shape.items():
        ms = graph_ms(kernel, sets)
        plain_ms = graph_ms(plain, sets, reps=20 if len(sets) > 1 else 5)
        bms, by = bound_fn(sets[0])
        lib = sdpa_ms([gathered_fn(s) for s in sets])
        lib_txt = "not measured" if lib is None else f"{lib * 1e3:.2f} us"
        print(f"{label} at {shape_name} shape, device time (CUDA graph): "
              f"{ms * 1e3:.2f} us; plain {plain_ms * 1e3:.2f} us; bound "
              f"{bms * 1e3:.2f} us ({by}); share of the bound "
              f"{bms / ms:.3f}")
        print(f"{label} at {shape_name} shape, for information: "
              f"scaled_dot_product_attention(enable_gqa=True) over K/V "
              f"already gathered into contiguous tensors {lib_txt} (not "
              f"the same function: no page gather; the port never calls it)")
        out[shape_name] = (ms, plain_ms, bms, by)
    eager_ms = time_ms(kernel, sets_by_shape["serving"])
    print(f"{label} at serving shape, eager call incl. host dispatch: "
          f"{eager_ms * 1e3:.2f} us")
    return out["serving"]


def kernel_phase() -> dict:
    cases = [(SERVE_SHAPE, torch.bfloat16), (SERVE_SHAPE, torch.float32),
             (REDUCED_SHAPE, torch.float32), (REDUCED_SHAPE, torch.bfloat16),
             (LONG_SHAPE, torch.bfloat16), (LONG_SHAPE, torch.float32)]
    max_err = 0.0
    for i, (shape, dtype) in enumerate(cases):
        q, kp, vp, bt, ln, st = kernel_case(*shape, dtype=dtype, seed=i)
        for starts in (None, st):
            max_err = max(max_err, check_against_plain(
                f"kernel check {shape} {dtype}", PA.paged_attention,
                paged_attention_ref, (q, kp, vp, bt, ln), starts, dtype))
    for shape in (SERVE_SHAPE, LONG_SHAPE):
        for dtype in (torch.bfloat16, torch.float32):
            q, kp, vp, bt, ln, st = edge_case(shape, dtype, seed=20)
            for starts in (None, st):
                max_err = max(max_err, check_against_plain(
                    f"kernel check, lengths {ln.tolist()} (split edges, "
                    f"length 1), {dtype}", PA.paged_attention,
                    paged_attention_ref, (q, kp, vp, bt, ln), starts, dtype))
    for dtype in (torch.bfloat16, torch.float32):
        batch_invariance("kernel", PA.paged_attention,
                         lambda k, v, dtype=dtype: (k.to(dtype), v.to(dtype)),
                         dtype)
    # timing, every sequence at full length: serving 5 sets x 16.8 MB of
    # K/V > the 50 MB L2; long one set of 134 MB
    sets = {"serving": [kernel_case(*SERVE_SHAPE, dtype=torch.bfloat16,
                                    seed=100 + j, full=True)[:5]
                        for j in range(5)],
            "long": [kernel_case(*LONG_SHAPE, dtype=torch.bfloat16,
                                 seed=200, full=True)[:5]]}
    ms, plain_ms, bms, by = time_shapes(
        "kernel", PA.paged_attention, paged_attention_ref, sets,
        lambda s: bound_ms(s[0], s[1], s[4], None),
        lambda s: gather(s[0], s[1], s[2], s[3]))
    return {"name": "paged_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
            "replaces": "src/repro/kernels/paged_attention.py:31",
            "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bms, "bound_by": by, "library_ms": None}


def int8_case(shape, dtype, seed, full=False):
    """``kernel_case`` over a quantized pool: K/V drawn in f32 and quantized
    on the card, with one all-zero token row (scale 1) at a valid position
    of the last (full-length) sequence; q in ``dtype``."""
    b, h, kheads, d, page, pps, n_phys = shape
    q, kp, vp, bt, ln, st = kernel_case(*shape, dtype=torch.float32,
                                        seed=seed, full=full)
    row = int(bt[-1, 1])                      # position page + 3 >= start
    kp[:, row, 3] = 0.0
    vp[:, row, 3] = 0.0
    kq, ks = PA8.quantize_pages(kp)
    vq, vs = PA8.quantize_pages(vp)
    check(bool((ks[:, row, 3] == 1).all()), "zero row must get scale 1")
    return (q.to(dtype), kq, ks, vq, vs, bt, ln, st), kp


def quantized(k, v):
    (kq, ks), (vq, vs) = PA8.quantize_pages(k), PA8.quantize_pages(v)
    return kq, ks, vq, vs


def kernel_int8_phase() -> dict:
    cases = [(SERVE_SHAPE, torch.bfloat16), (SERVE_SHAPE, torch.float32),
             (REDUCED_SHAPE, torch.float32), (REDUCED_SHAPE, torch.bfloat16),
             (LONG_SHAPE, torch.bfloat16), (LONG_SHAPE, torch.float32)]
    max_err = 0.0
    for i, (shape, dtype) in enumerate(cases):
        (q, kq, ks, vq, vs, bt, ln, st), kp = int8_case(shape, dtype, seed=i)
        if i == 0:
            # the pool's quantization on the card equals the CPU's bits
            cq, cs = PA8.quantize_pages(kp.cpu())
            check(torch.equal(kq.cpu(), cq) and torch.equal(
                ks.cpu().view(torch.int16), cs.view(torch.int16)),
                "quantize_pages on the card differs from the CPU")
            print("quantize_pages: card == CPU, bit for bit "
                  f"({kp.numel()} values)")
        for starts in (None, st):
            max_err = max(max_err, check_against_plain(
                f"int8 kernel check {shape} q {dtype}",
                PA8.paged_attention_int8, paged_attention_int8_ref,
                (q, kq, ks, vq, vs, bt, ln), starts, dtype))
    for shape in (SERVE_SHAPE, LONG_SHAPE):
        for dtype in (torch.bfloat16, torch.float32):
            q, kp, vp, bt, ln, st = edge_case(shape, torch.float32, seed=21)
            args = (q.to(dtype), *quantized(kp, vp), bt, ln)
            for starts in (None, st):
                max_err = max(max_err, check_against_plain(
                    f"int8 kernel check, lengths {ln.tolist()} (split "
                    f"edges, length 1), q {dtype}", PA8.paged_attention_int8,
                    paged_attention_int8_ref, args, starts, dtype))
    for dtype in (torch.bfloat16, torch.float32):
        batch_invariance("int8 kernel", PA8.paged_attention_int8, quantized,
                         dtype)
    # timing, every sequence at full length: serving 12 x 4.4 MB of live
    # K/V and scales > the 50 MB L2; long one set of 68 MB

    def deq(s):
        q, kq, ks, vq, vs, bt, _ = s
        return gather(q, PA8.dequantize_pages(kq, ks).to(q.dtype),
                      PA8.dequantize_pages(vq, vs).to(q.dtype), bt)
    sets = {"serving": [int8_case(SERVE_SHAPE, torch.bfloat16, seed=100 + j,
                                  full=True)[0][:7] for j in range(12)],
            "long": [int8_case(LONG_SHAPE, torch.bfloat16, seed=200,
                               full=True)[0][:7]]}
    ms, plain_ms, bms, by = time_shapes(
        "int8 kernel", PA8.paged_attention_int8, paged_attention_int8_ref,
        sets, lambda s: bound_ms(s[0], s[1], s[6], None, scales=s[2]), deq)
    return {"name": "paged_attention_int8", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/paged_attention_int8.cu",
            "replaces": "src/repro/kernels/paged_attention_int8.py:30",
            "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bms, "bound_by": by, "library_ms": None}


# -- 5. kernel (head geometries) ----------------------------------------------

# the dense configs' decode head geometries; llama3-8b's (rep 4, the 4-head
# tile) is timed beside the rep-8 ones (yi-9b, deepseek-67b: the 8-head
# tile, which ptxas says spills), the rep-1 ones are qwen's MHA;
# recurrentgemma-9b's local attention is MQA at D 256 (rep 16: two 8-head
# tiles of one KV head, 32 lanes a row)
GEOMETRY_CONFIGS = ("llama3-8b", "yi-9b", "deepseek-67b", "qwen1.5-0.5b",
                    "qwen1.5-32b", "dbrx-132b", "recurrentgemma-9b")


def geometry_shapes(cfg) -> dict:
    """Length -> shape at ``cfg``'s head geometry: B 8, page 16, 16 pages
    (every length 256 when timed) and the long length, 4096 (256 pages) or
    the config's window where that is shorter (recurrentgemma-9b: 2048,
    128 pages)."""
    h, k, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    long = min(4096, cfg.sliding_window or 4096)
    pps = long // 16
    return {256: (8, h, k, d, 16, 16, 257),
            long: (8, h, k, d, 16, pps, 8 * pps + 1)}


def start_ptxas_report():
    """ptxas's registers, stack and spills of both attention kernels'
    instantiations (``tools/tune_kernels.py resources``: nvcc with
    -Xptxas -v), started beside the build."""
    return subprocess.Popen(
        [sys.executable, os.path.join(ROOT, "tools", "tune_kernels.py"),
         "resources", "paged_attention", "paged_attention_int8"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=ROOT)


def print_d256_resources(proc, card: str):
    """Wait for ``start_ptxas_report``'s run and print its lines for the
    D 256 instantiations (32 lanes a row: template argument G = 32) with
    the 8-head tile recurrentgemma-9b's rep 16 runs."""
    out, _ = proc.communicate(timeout=900)
    check(proc.returncode == 0, f"ptxas report failed:\n{out[-3000:]}")
    keep, shown = False, 0
    for line in out.splitlines():
        if line.startswith("=="):
            print(f"ptxas -v {line[3:]} [{card}]")
        elif line.startswith("kernel"):
            keep = ", 8, 32>" in line
            shown += keep
        if keep:
            print(f"  {line.strip()[:160]}")
    check(shown >= 2, "no D 256 instantiation in the ptxas report")


def rotating_sets(make, shape, itemsize) -> list:
    """Input sets whose live K/V together exceed the 50 MB L2 (each
    sequence at full length), at most 16."""
    b, _, kheads, d, page, pps, _ = shape
    live = 2 * b * pps * page * kheads * d * itemsize
    return [make(300 + j) for j in range(min(16, math.ceil(64e6 / live)))]


def geometry_phase(card: str) -> list:
    """Both attention kernels at the dense, MoE and hybrid configs' head
    geometries (``GEOMETRY_CONFIGS``): held
    against their plain versions (q bf16 and f32, with and without window
    starts, at both lengths; llama3-8b's geometry is the kernel phases'),
    then timed in a CUDA graph with bound and share. Returns the timing
    rows."""
    max_err = 0.0
    rows = []
    for name in GEOMETRY_CONFIGS:
        cfg = get_config(name)
        for length, shape in geometry_shapes(cfg).items():
            label = f"{name} (H {cfg.n_heads}, K {cfg.n_kv_heads}, D " \
                f"{cfg.head_dim}, rep {cfg.q_per_kv}) length {length}"
            if name != "llama3-8b":
                for dtype in (torch.bfloat16, torch.float32):
                    q, kp, vp, bt, ln, st = kernel_case(*shape, dtype=dtype,
                                                        seed=400)
                    for starts in (None, st):
                        max_err = max(max_err, check_against_plain(
                            f"{label} kernel check {dtype}",
                            PA.paged_attention, paged_attention_ref,
                            (q, kp, vp, bt, ln), starts, dtype))
                    args, _ = int8_case(shape, dtype, seed=401)
                    for starts in (None, args[-1]):
                        max_err = max(max_err, check_against_plain(
                            f"{label} int8 kernel check q {dtype}",
                            PA8.paged_attention_int8,
                            paged_attention_int8_ref, args[:-1], starts,
                            dtype))
                    del q, kp, vp, args
            bf16_sets = rotating_sets(
                lambda seed: kernel_case(*shape, dtype=torch.bfloat16,
                                         seed=seed, full=True)[:5],
                shape, 2)
            int8_sets = rotating_sets(
                lambda seed: int8_case(shape, torch.bfloat16, seed=seed,
                                       full=True)[0][:7], shape, 1)
            for kernel, fn, plain, sets, bound in (
                    (PA, PA.paged_attention, paged_attention_ref, bf16_sets,
                     lambda s: bound_ms(s[0], s[1], s[4], None)),
                    (PA8, PA8.paged_attention_int8, paged_attention_int8_ref,
                     int8_sets,
                     lambda s: bound_ms(s[0], s[1], s[6], None,
                                        scales=s[2]))):
                ms = graph_ms(fn, sets)
                plain_ms = graph_ms(plain, sets[:1], reps=5)
                bms, by = bound(sets[0])
                row = {"config": name, "rep": cfg.q_per_kv,
                       "H": cfg.n_heads, "K": cfg.n_kv_heads,
                       "D": cfg.head_dim, "length": length,
                       "kernel": kname(kernel), "us": ms * 1e3,
                       "plain_us": plain_ms * 1e3, "bound_us": bms * 1e3,
                       "bound_by": by, "share": bms / ms,
                       "input_sets": len(sets)}
                rows.append(row)
                print(f"{label} {kname(kernel)} [{card}]: device time (CUDA "
                      f"graph) {ms * 1e3:.2f} us over {len(sets)} rotating "
                      f"sets; "
                      f"plain {plain_ms * 1e3:.2f} us; bound "
                      f"{bms * 1e3:.2f} us ({by}); share of the bound "
                      f"{bms / ms:.3f}")
            del bf16_sets, int8_sets
        torch.cuda.empty_cache()
    print(f"head-geometry checks: largest max_abs_err {max_err:.3e}")
    for kernel in ("paged_attention", "paged_attention_int8"):
        for length in sorted({r["length"] for r in rows}):
            print(f"{kernel} share of the bound at length {length} [{card}]: "
                  + ", ".join(f"{r['config']} (rep {r['rep']}, D {r['D']}) "
                              f"{r['share']:.3f}" for r in rows
                              if r["kernel"] == kernel
                              and r["length"] == length))
    return rows


# -- 6. kernel (ssd_scan) -----------------------------------------------------

def ssd_case(shape, bc_dtype, seed, with_h0=False, odd_rows=False):
    """Scan inputs on the card at the reference sweep's scales (x * 0.5,
    a = -|N(0,1)| * 0.3, B and C * 0.3); B and C are strided halves of one
    (b, s, 2n) tensor, as the model's are slices of the conv output.
    ``odd_rows``: rows of 2n + 5 values, so no row of B or C starts on a
    16-byte boundary (the wrapper copies them to aligned rows)."""
    b, s, h, p, n, _ = shape
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(scale, *size):
        return torch.randn(size, generator=g, device="cuda") * scale

    xdt, a = rnd(0.5, b, s, h, p), -rnd(0.3, b, s, h).abs()
    bc = rnd(0.3, b, s, 2 * n + (5 if odd_rows else 0)).to(bc_dtype)
    h0 = rnd(1.0, b, h, p, n) if with_h0 else None
    return xdt, a, bc[..., :n], bc[..., n:2 * n], h0


def ssd_bound_ms(xdt, B, h0=None):
    """Least time for one scan on each route: the bytes it must move (x, a,
    B, C, y, the final state and h0, each once) over the memory rate, or
    its least operations — per position and head one multiply-add per state
    element for the update and one for the output, 4 * b * s * h * p * n —
    over the peak rate of the units that do them; the larger. On the f32
    CUDA cores the operations run at 67 TFLOP/s. On the tensor cores (the
    kernel's route) an f32-accurate multiply-add is three TF32 products
    (the error-compensated split), two where B and C are bf16 (exact in
    TF32), at 495 TFLOP/s. Returns {"tensor_cores": (ms, by),
    "cuda_cores": (ms, by)}."""
    b, s, h, p = xdt.shape
    n = B.shape[-1]
    state = b * h * p * n * 4
    nbytes = (2 * xdt.numel() * 4 + b * s * h * 4
              + 2 * b * s * n * B.element_size()
              + state * (2 if h0 is not None else 1))
    flops = 4 * b * s * h * p * n
    products = 2 if B.dtype == torch.bfloat16 else 3
    t_bytes = nbytes / HBM_BYTES_PER_S
    out = {}
    for route, t_ops in (("tensor_cores", products * flops / TF32_PEAK),
                         ("cuda_cores", flops / PEAK_FLOPS[torch.float32])):
        out[route] = (max(t_bytes, t_ops) * 1e3,
                      "bytes" if t_bytes >= t_ops else "operations")
    return out


def ssd_error(got, want):
    """(max |got - want|, max of |got - want| - (atol + rtol |want|)): the
    second is <= 0 when every element is inside the limit."""
    diff = (got - want).abs()
    return (float(diff.max()),
            float((diff - SSD_TOL * (1 + want.abs())).max()))


def ssd_seq_f64(xdt, a, B, C):
    """The sequential recurrence in f64: the yardstick of the precision
    table."""
    x, a, B, C = (t.double() for t in (xdt, a, B, C))
    b, s, h, p = x.shape
    state = torch.zeros((b, h, p, B.shape[-1]), dtype=torch.float64,
                        device=x.device)
    ys = []
    for t in range(s):
        state = state * a[:, t].exp()[..., None, None] + \
            x[:, t, ..., None] * B[:, t, None, None, :]
        ys.append(torch.einsum("bhpn,bn->bhp", state, C[:, t]))
    return torch.stack(ys, 1), state


def ssd_precision_table():
    """Error of three ways to form the scan's products at mamba2-130m's
    head geometry (b 2, s 512, h 4, p 64, n 128, the reference sweep's
    scales) against the f64 recurrence: the plain chunked form at chunk 32
    with f32 products, the same with TF32 products (torch's matmul TF32
    switch on for that call only), and the kernel (TF32 with the
    error-compensated split). The kernel's rows must be inside the
    tolerance and the plain TF32 rows outside it (so the switch reached
    the matmuls and the table shows what the split buys)."""
    shape = (2, 512, 4, 64, 128, 32)
    for bc_dtype in (torch.float32, torch.bfloat16):
        xdt, a, B, C, _ = ssd_case(shape, bc_dtype, seed=21)
        want_y, want_h = ssd_seq_f64(xdt, a, B, C)
        rows = {"f32 products (plain chunked, chunk 32)":
                ssm.ssd_chunked_plain(xdt, a, B, C, None, 32)}
        was = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            rows["plain TF32 products (plain chunked, chunk 32)"] = \
                ssm.ssd_chunked_plain(xdt, a, B, C, None, 32)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = was
        rows["kernel: TF32, error-compensated split"] = SSD.ssd_scan(
            xdt, a, B, C, chunk=32)
        for what, (y, hf) in rows.items():
            err_y, over_y = ssd_error(y.double(), want_y)
            err_h, over_h = ssd_error(hf.double(), want_h)
            print(f"ssd_scan precision, B/C {bc_dtype}, {what}: max_abs_err "
                  f"y {err_y:.3e}, state {err_h:.3e}; worst excess over "
                  f"{SSD_TOL:.0e}(1+|want|): y {over_y:+.3e}, state "
                  f"{over_h:+.3e}")
            if what.startswith("kernel"):
                check(max(over_y, over_h) <= 0,
                      "ssd_scan outside the tolerance against f64")
            if what.startswith("plain TF32"):
                check(over_y > 0, "plain TF32 products inside the tolerance: "
                      "the TF32 switch did not reach the matmuls")


SSD_CASES = [   # shape, B/C dtype, h0, rows of 2n + 5 (unaligned B and C)
    (SSD_SERVE, torch.bfloat16, False, False),
    (SSD_SERVE, torch.float32, False, False),
    (SSD_SERVE, torch.bfloat16, True, False),
    (SSD_SERVE, torch.float32, True, False),
    ((8, 200, 24, 64, 128, 200), torch.bfloat16, False, False),  # ragged
    (SSD_REDUCED, torch.float32, False, False),
    (SSD_REDUCED, torch.float32, True, False),
    (SSD_REDUCED, torch.bfloat16, False, False),
    ((2, 128, 4, 24, 64, 64), torch.bfloat16, True, False),   # p not a tile
    ((2, 96, 3, 40, 128, 32), torch.float32, False, False),
    ((2, 33, 4, 64, 128, 33), torch.bfloat16, False, False),  # Q edges
    ((2, 64, 4, 64, 128, 64), torch.float32, True, False),
    ((2, 65, 4, 64, 128, 65), torch.bfloat16, True, False),
    ((2, 128, 8, 16, 128, 64), torch.bfloat16, False, False),  # one P tile
    ((2, 128, 4, 64, 128, 64), torch.bfloat16, True, True),    # unaligned
    ((2, 128, 4, 64, 128, 64), torch.float32, True, True),
    ((2, 96, 4, 64, 256, 32), torch.bfloat16, True, False),    # N 129-256
    ((2, 96, 4, 64, 256, 32), torch.float32, True, False),
    ((2, 96, 4, 32, 200, 96), torch.bfloat16, True, False),
    ((2, 96, 4, 32, 200, 96), torch.float32, False, True),
    ((2, 64, 4, 18, 20, 32), torch.float32, True, True),  # P, N padded
    ((2, 64, 4, 18, 20, 32), torch.bfloat16, False, False),
]


def ssd_scan_phase() -> dict:
    max_err = 0.0
    for i, (shape, bc_dtype, with_h0, odd) in enumerate(SSD_CASES):
        xdt, a, B, C, h0 = ssd_case(shape, bc_dtype, seed=i,
                                    with_h0=with_h0, odd_rows=odd)
        chunk = shape[-1]
        y, hf = SSD.ssd_scan(xdt, a, B, C, chunk=chunk, h0=h0)
        torch.cuda.synchronize()
        plain = {"sequential": ssd_scan_ref(xdt, a, B, C, h0),
                 "chunked": ssm.ssd_chunked_plain(xdt, a, B, C, h0, chunk)}
        for what, (ry, rh) in plain.items():
            err_y, over_y = ssd_error(y, ry)
            err_h, over_h = ssd_error(hf, rh)
            print(f"ssd_scan check {shape} B/C {bc_dtype} h0={with_h0}"
                  f"{' unaligned rows' if odd else ''} vs plain {what}: "
                  f"max_abs_err y {err_y:.3e}, state {err_h:.3e} (limit "
                  f"{SSD_TOL:.0e} + {SSD_TOL:.0e}|want|)")
            check(math.isfinite(err_y + err_h) and max(over_y, over_h) <= 0,
                  f"ssd_scan disagrees with the plain {what} version")
            if what == "sequential":
                max_err = max(max_err, err_y, err_h)
        if shape == SSD_SERVE:
            y2, hf2 = SSD.ssd_scan(xdt, a, B, C, chunk=chunk, h0=h0)
            check(torch.equal(y, y2) and torch.equal(hf, hf2),
                  "ssd_scan: two calls on the same inputs differ")
    print("ssd_scan: two calls bit-identical at every serving-shape case")
    ssd_precision_table()
    # timing at the serving shape; 2 sets x 59 MB > the 50 MB L2
    sets = [ssd_case(SSD_SERVE, torch.bfloat16, seed=100 + j)[:4]
            for j in range(2)]
    chunk = SSD_SERVE[-1]

    def kernel(x, a, B, C):
        return SSD.ssd_scan(x, a, B, C, chunk=chunk)

    def chunked(x, a, B, C):
        return ssm.ssd_chunked_plain(x, a, B, C, chunk=chunk)

    ms = graph_ms(kernel, sets)
    plain_ms = graph_ms(ssd_scan_ref, sets, reps=5)
    chunked_ms = graph_ms(chunked, sets, reps=10)
    eager_ms = time_ms(kernel, sets)
    bounds = ssd_bound_ms(sets[0][0], sets[0][2])
    (bms, by), (cms, cby) = bounds["tensor_cores"], bounds["cuda_cores"]
    b, s, h, p, n, _ = SSD_SERVE
    grid = SSD.grid_blocks(b, s, h, p, n)
    print(f"ssd_scan at serving shape, device time (CUDA graph): "
          f"{ms * 1e3:.2f} us (grid: {grid['cb_pass']} C·Bᵀ blocks, then "
          f"{grid['scan']} scan blocks of 128 threads, "
          f"{grid['scan_smem_bytes']} B shared each, "
          f"{grid['scan_blocks_per_sm']} per SM); plain sequential "
          f"{plain_ms * 1e3:.2f} us; plain chunked {chunked_ms * 1e3:.2f} us")
    print(f"ssd_scan bounds: tensor cores (the kernel's route) "
          f"{bms * 1e3:.2f} us ({by}), {100 * bms / ms:.1f}% of it reached; "
          f"f32 CUDA cores {cms * 1e3:.2f} us ({cby}), "
          f"{100 * cms / ms:.1f}%")
    print(f"ssd_scan at serving shape, eager call incl. host dispatch: "
          f"{eager_ms * 1e3:.2f} us")
    return {"name": "ssd_scan", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
            "replaces": "src/repro/kernels/ssd_scan.py:23",
            "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bms, "bound_by": by, "library_ms": None,
            "bound_cuda_cores_ms": cms, "grid_blocks": grid}


# -- 7.-12. serving, failover and decode profile, per pool --------------------

class Client:
    def __init__(self, port: int):
        self.base = f"http://127.0.0.1:{port}"

    def post(self, path, payload, timeout=600):
        req = urllib.request.Request(
            self.base + path, data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return json.loads(r.read())

    def health(self):
        with urllib.request.urlopen(self.base + "/health", timeout=60) as r:
            return json.loads(r.read())

    def completions(self, prompts, max_tokens):
        """POST every prompt concurrently, one thread each; ``join`` waits
        for them and returns the responses in prompt order."""
        out, errs = [None] * len(prompts), []

        def one(i):
            try:
                out[i] = self.post("/v1/completions",
                                   {"prompt_tokens": prompts[i],
                                    "max_tokens": max_tokens})
            except Exception as e:  # noqa: BLE001 — re-raised below
                errs.append(e)

        threads = [threading.Thread(target=one, args=(i,))
                   for i in range(len(prompts))]
        for t in threads:
            t.start()
        return threads, out, errs


def join(threads, out, errs):
    for t in threads:
        t.join(timeout=600)
    check(not any(t.is_alive() for t in threads), "completion timed out")
    if errs:
        raise errs[0]
    return out


def serving_metrics(resps, wall):
    ttft = [r["timing"]["ttft"] for r in resps]
    tpot = [(r["timing"]["latency"] - r["timing"]["ttft"])
            / max(len(r["choices"][0]["token_ids"]) - 1, 1) for r in resps]
    n_tok = sum(len(r["choices"][0]["token_ids"]) for r in resps)
    return {"ttft_s_median": statistics.median(ttft),
            "ttft_s_max": max(ttft),
            "per_token_s_median": statistics.median(tpot),
            "tokens_per_s": n_tok / wall, "n_requests": len(resps),
            "tokens": n_tok}


def decode_profile(engine, card: str, kernel):
    """One instance's decode step, called directly on the engine's weights
    and pool with every slot at position 200 (13 live pages): wall time per
    step (synchronised host clock), device-busy time per step (sum of
    kernel times under torch.profiler), the paged-attention kernel's share,
    and the aten ops and kernel launches per step. ``kernel`` is the
    wrapper module of the pool's attention kernel."""
    inst = engine.instances[-1]
    pool = inst.pool
    b, width = engine.ecfg.max_slots, inst.pages_per_seq
    bt = torch.arange(1, 1 + b * width, dtype=torch.int32,
                      device="cuda").reshape(b, width)
    pos = torch.full((b,), 200, dtype=torch.int32, device="cuda")
    base = torch.zeros_like(pos)
    tok = torch.arange(1, b + 1, dtype=torch.int32, device="cuda")
    # the hybrid step reads and writes a state blob per slot: blobs 1..b
    blob_slots = torch.arange(1, b + 1, dtype=torch.int32, device="cuda")

    def step():
        if inst.family == "hybrid":
            inst._decode(engine.params, tok, pool.k, pool.v, pool.k_scale,
                         pool.v_scale, pool.blobs, pool.blob_scales, bt,
                         blob_slots, pos, base, inst._generator)
        else:
            inst._decode(engine.params, tok, pool.k, pool.v, pool.k_scale,
                         pool.v_scale, bt, pos, base, inst._generator)

    for _ in range(2):
        step()
    torch.cuda.synchronize()
    # the second step's count: a first call under the debug mode may warn
    # once for a one-time setup, which is printed but not counted
    first, syncs = sync_calls(step), sync_calls(step)
    n = 5
    kernel.launches = 0
    t0 = time.perf_counter()
    for _ in range(n):
        step()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / n
    layers = attn_layers(engine.cfg)      # one call per layer per step
    check(kernel.launches == n * layers * launches_per_call(width),
          f"decode profile: {kernel.launches} {kname(kernel)} launches")
    per_step = kernel.launches / n
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(n):
            step()
        torch.cuda.synchronize()
    events = prof.key_averages()
    # device-side entries only: an aten op's self device time repeats the
    # time of the kernels it launched, which are listed as entries too
    kernels = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / n / 1e3
    name = kname(kernel) + "_kernel"
    # the split pass and its merge pass (only one pool's kernels run here)
    attn = sum(e.self_device_time_total for e in kernels
               if name in e.key or "merge_splits_kernel" in e.key) / n / 1e3
    ops = sum(e.count for e in events if e.key.startswith("aten::")) / n
    m = {"pool": str(pool.k.dtype).replace("torch.", ""),
         "decode_step_wall_ms": wall * 1e3, "device_busy_ms": busy,
         f"{name}_ms": attn,
         f"{name}_launches_per_step": per_step,
         "aten_ops_per_step": ops,
         "kernel_launches_per_step": sum(e.count for e in kernels) / n,
         "device_idle_share": 1 - busy / (wall * 1e3) if busy else None,
         "syncs_per_step": len(syncs)}
    print(f"decode step profile [{card}]: " + json.dumps(m))
    print(f"  synchronizing calls, first step under the debug mode: "
          f"{first}; the next step: {syncs}")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]:
        print(f"  device ms/step {e.self_device_time_total / n / 1e3:8.3f}"
              f"  launches/step {e.count / n:7.1f}  {e.key[:90]}")
    if not busy:
        print("decode step profile: the profiler saw no device time "
              "(device busy not measured)")
    return m


def sync_calls(fn) -> list:
    """The synchronizing CUDA calls ``fn()`` makes, as "file:line"
    strings: the warnings ``torch.cuda.set_sync_debug_mode("warn")``
    raises while it runs."""
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return [f"{os.path.relpath(w.filename, ROOT)}:{w.lineno}"
            for w in caught if "synchronizing" in str(w.message)]


def attn_layers(cfg) -> int:
    """Layers that attend over the paged pool (the hybrid's local-attention
    layers; every layer of the other families): one attention call each
    per decode step."""
    return len(PD.kv_layer_indices(cfg))


def block_bytes(cfg, quantized: bool) -> int:
    """One replication message: K and V rows of every attention layer and
    KV head of one page — int8 plus a bf16 scale per row, or bf16."""
    rows = 2 * attn_layers(cfg) * cfg.n_kv_heads * cfg.page_size
    return rows * (cfg.head_dim + 2) if quantized else rows * cfg.head_dim * 2


def blob_bytes(cfg, quantized: bool) -> int:
    """One state-blob message (the hybrid's RG-LRU state; 0 elsewhere): f32
    words, or int8 words plus one bf16 scale."""
    if cfg.arch_type != "hybrid":
        return 0
    words = hybrid.state_blob_words(cfg)
    return words + 2 if quantized else 4 * words


def counted(label, what, fn, kernel, idle, n_layers):
    """Run ``fn`` with both attention kernels' launch counts set to 0 just
    before and read just after; check the run went through ``kernel`` (a
    positive multiple of ``n_layers`` launches: one call per layer per
    decode step) and never through ``idle``. Returns (fn's result,
    ``kernel``'s launches)."""
    kernel.launches = idle.launches = 0
    out = fn()
    n, other = kernel.launches, idle.launches
    print(f"[{label}] {kname(kernel)} launches in {what}: {n}; "
          f"{kname(idle)}: {other}")
    check(n > 0 and n % n_layers == 0,
          f"{what} launch count {n} is not a positive multiple of "
          f"{n_layers}")
    check(other == 0, f"{what} launched {kname(idle)} {other} times")
    return out, n


def http_kill_drill(client, prompts, max_tokens, label):
    """POST every prompt concurrently; once each holds a slot (none is left
    to be admitted onto the victim) and some instance decodes, kill the
    instance decoding most through /v1/admin/fault (``if_busy``). Returns
    (responses, victim, the victim's mid-prefill count just before)."""
    threads, out, errs = client.completions(prompts, max_tokens)
    deadline = time.time() + 300
    while True:
        check(time.time() < deadline, "no instance started decoding")
        h = client.health()
        inst = h["instances"]
        admitted = sum(i["active"] for i in inst)
        decoding = [i["active"] - i["prefilling"] for i in inst]
        if admitted == len(prompts) and max(decoding) > 0:
            break
        time.sleep(0.002)
    victim = int(np.argmax(decoding))
    prefilling = inst[victim]["prefilling"]
    fault = client.post("/v1/admin/fault",
                        {"granularity": "instance", "instance_id": victim,
                         "if_busy": True})
    check(fault["applied"], "fault was not applied")
    print(f"[{label}] killed instance {victim} ({decoding[victim]} "
          f"decoding, {prefilling} mid-prefill just before the fault); "
          f"seamlessly resumed {fault['seamlessly_resumed']}")
    return join(threads, out, errs), victim, prefilling


def run_path(card, cfg, ecfg, kernel, idle, label, prompts, params=None,
             repeat=False):
    """One serving path end to end: start the HTTP service (on ``params``
    when given), warm it up, then serving (twice with ``repeat``: the
    second run's streams must equal the first's), failover and decode
    profile. ``kernel`` is the wrapper module the path must launch (a
    positive multiple of ``attn_layers(cfg)`` launches), ``idle`` the one
    it must not launch. Returns (launches on the serving and failover phases,
    the engine's params, the decode profile, the first run's streams)."""
    t0 = time.perf_counter()
    n_attn = attn_layers(cfg)
    svc, httpd = serve(cfg, ecfg, n_instances=2, port=0, device="cuda",
                       params=params)
    print(f"[{label}] engine up in {time.perf_counter() - t0:.1f} s "
          f"({'shared' if params is not None else 'new'} params + 2 KV "
          f"pools of {svc.engine.instances[0].pool.block_nbytes} B per "
          f"block; {torch.cuda.memory_allocated() / 2**30:.1f} GiB "
          f"allocated)")
    server = threading.Thread(target=httpd.serve_forever, daemon=True)
    server.start()
    launches = 0
    try:
        client = Client(httpd.server_address[1])
        # warm-up: cuBLAS handles and the first allocations
        warm = client.post("/v1/completions",
                           {"prompt_tokens": prompts[0], "max_tokens": 4})
        check(len(warm["choices"][0]["token_ids"]) == 4, "warm-up")

        phase(f"serving ({label})")
        n_samples = len(svc.engine.step_samples)
        t0 = time.perf_counter()
        resps, n = counted(label, "serving",
                           lambda: join(*client.completions(prompts, 32)),
                           kernel, idle, n_attn)
        launches += n
        wall = time.perf_counter() - t0
        steps = [s[1] for s in svc.engine.step_samples[n_samples:]]
        streams = [r["choices"][0]["token_ids"] for r in resps]
        vocab = cfg.vocab_size
        check(all(len(s) == 32 and all(0 <= t < vocab for t in s)
                  for s in streams), "completion shape / token range")
        check(streams[1] == streams[-1], "greedy determinism: same prompt, "
              "different tokens")
        repl = client.health()["replication"]
        # a hybrid's state blobs ride beside the blocks: take their bytes
        # out before dividing by the blocks
        blob = blob_bytes(cfg, ecfg.kv_quant)
        per_block = (repl["bytes_total"] - repl["blobs_total"] * blob) \
            / max(repl["blocks_total"], 1)
        print(f"[{label}] replication: {repl['blocks_total']} blocks, "
              f"{repl['blobs_total']} blobs, {repl['bytes_total']} B, "
              f"{per_block:.0f} B per block"
              + (f", {blob} B per blob, "
                 f"{repl['blobs_per_request_step']:.3f} blobs per request "
                 "step" if blob else ""))
        want = block_bytes(cfg, ecfg.kv_quant)
        check(repl["blocks_total"] > 0 and per_block == want,
              f"replicated bytes per block {per_block} != {want}")
        check(bool(blob) == (repl["blobs_total"] > 0)
              and repl["blobs_per_request_step"] <= 1,
              f"{repl['blobs_total']} blobs replicated "
              f"({repl['blobs_per_request_step']:.3f} per request step)")
        m = serving_metrics(resps, wall)
        m["engine_steps"] = len(steps)
        m["engine_step_s_median"] = statistics.median(steps)
        m["replicated_bytes_per_block"] = per_block
        print(f"serving [{label}] [{card}]: " + json.dumps(m))
        if repeat:
            again, n = counted(
                label, "serving again",
                lambda: join(*client.completions(prompts, 32)), kernel,
                idle, n_attn)
            launches += n
            check(tokens_of(again) == streams,
                  "greedy streams differ between two failure-free runs")
            print(f"[{label}] second failure-free run: all {len(again)} "
                  "streams equal the first")

        phase(f"failover ({label})")
        (resps2, victim, prefilling), n = counted(
            label, "failover",
            lambda: http_kill_drill(client, prompts, 32, label),
            kernel, idle, n_attn)
        launches += n
        migrations = [r["kevlarflow"]["migrations"] for r in resps2]
        retries = [r["kevlarflow"]["retries"] for r in resps2]
        print(f"[{label}] migrations per request: {migrations}; retries "
              f"per request: {retries}; a mid-prefill victim was "
              f"{'hit' if sum(retries) else 'not hit'}")
        check(max(migrations) >= 1, "no request migrated")
        check(sum(retries) <= prefilling,
              f"{sum(retries)} requests restarted, but only {prefilling} "
              "were mid-prefill on the victim")
        check([r["choices"][0]["token_ids"] for r in resps2] == streams,
              "resumed streams differ from the failure-free run")
        health = client.health()
        survivor = 1 - victim
        inst = health["instances"]
        check(not inst[victim]["alive"] and inst[survivor]["alive"],
              "health does not show the kill")
        check(health["topology"]["states"][str(survivor)] == "HEALTHY",
              "survivor not healthy")
        check(health["failure_events"][0]["restarted"] == sum(retries),
              "failure event disagrees with the retries")
        after = client.post("/v1/completions",
                            {"prompt_tokens": prompts[0], "max_tokens": 8})
        check(after["choices"][0]["token_ids"] == streams[0][:8],
              "survivor's stream differs")
        print(f"failover [{label}] [{card}]: all {len(resps2)} streams "
              f"byte-identical to the failure-free run; survivor {survivor} "
              "serving")
        httpd.shutdown()
        svc.shutdown()

        phase(f"decode profile ({label})")
        profile = decode_profile(svc.engine, card, kernel)
    finally:
        httpd.shutdown()
        svc.shutdown()
        server.join(timeout=30)
    return launches, svc.engine.params, profile, streams


# -- 13.-15. cold reference, prefix cache, disaggregation ---------------------

SHARED_PAGES = 8        # the shared system prompt: 8 pages (128 tokens)
NEW_TOKENS = 32


@dataclasses.dataclass
class SharedPrefixSet:
    """The shared-prefix prompt set (lengths for page 16; a config with
    another page size scales them): a prefix of 8 pages with distinct
    tails, every prompt 129-256 tokens long — one prefill bucket, 256.
    ``batch`` holds five tails (20-128 tokens), one prompt that diverges
    inside page 7 (at token 120: the copy-on-write case) and a repeat of
    the second prompt. ``xbucket`` is the prefix's first 120 tokens alone:
    bucket 128, held against cold serving for information only. ``drill``
    holds four more prompts of the prefix with long new tails (218-256
    tokens): with the prefix cached they still have two chunks to run, the
    window a prefill-side kill needs."""
    shared: list
    primer: list
    batch: list
    xbucket: list
    drill: list


def shared_prefix_set(cfg) -> SharedPrefixSet:
    page = cfg.page_size
    rng = np.random.default_rng(2)

    def rnd(n):
        return rng.integers(1, cfg.vocab_size, n * page // 16).tolist()
    shared = rnd(SHARED_PAGES * 16)
    cut = SHARED_PAGES * page - page // 2
    batch = [shared + rnd(n) for n in (20, 45, 70, 100, 128)]
    batch.append(shared[:cut] + rnd(90))
    batch.append(list(batch[1]))
    drill = [shared + rnd(n) for n in (90, 110, 128, 100)]
    return SharedPrefixSet(shared, shared + rnd(40), batch, shared[:cut],
                           drill)


def prefix_ecfg(cfg, **kw) -> EngineConfig:
    """8 slots, chunks of 4 pages (64 tokens), room for 24 pages."""
    return EngineConfig(max_slots=8, max_seq=24 * cfg.page_size,
                        prefill_chunk=4 * cfg.page_size, **kw)


@contextlib.contextmanager
def http_service(cfg, ecfg, params, n_instances=2):
    """The port's HTTP service on the given weights, stopped (server thread
    and engine loop) on exit."""
    svc, httpd = serve(cfg, ecfg, n_instances=n_instances, port=0,
                       device="cuda", params=params)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        yield svc, Client(httpd.server_address[1])
    finally:
        httpd.shutdown()
        svc.shutdown()
        thread.join(timeout=30)


def tokens_of(resps):
    return [r["choices"][0]["token_ids"] for r in resps]


def primer_then_batch(client, primer, batch):
    """The primer alone, then the batch concurrently. Returns (the primer's
    response, the batch's responses, the batch's wall seconds)."""
    first = client.post("/v1/completions",
                        {"prompt_tokens": primer, "max_tokens": NEW_TOKENS})
    t0 = time.perf_counter()
    resps = join(*client.completions(batch, NEW_TOKENS))
    return first, resps, time.perf_counter() - t0


def ttft_line(label, card, resps, wall):
    m = serving_metrics(resps, wall)
    print(f"serving [{label}] [{card}] (for information): TTFT median "
          f"{m['ttft_s_median']:.4f} s, max {m['ttft_s_max']:.4f} s; "
          f"{m['tokens_per_s']:.1f} tokens/s over {m['n_requests']} "
          "concurrent requests")
    return m


def cold_reference(card, cfg, params, ps):
    """The prompt set served with the prefix cache off (chunked prefill,
    chunks of 64): the streams every later path must reproduce, and the
    cold TTFTs of the primer-then-batch traffic; then the drill prompts
    concurrently. Returns (stream per prompt, metrics, launches)."""
    label = "cold reference"

    def run():
        first, resps, wall = primer_then_batch(client, ps.primer,
                                               ps.batch + [ps.xbucket])
        return first, resps, wall, join(*client.completions(ps.drill,
                                                            NEW_TOKENS))
    with http_service(cfg, prefix_ecfg(cfg), params) as (_, client):
        (first, resps, wall, drill), n = counted(label, "serving", run, PA,
                                                 PA8, cfg.n_layers)
    prompts = [ps.primer] + ps.batch + [ps.xbucket] + ps.drill
    streams = tokens_of([first] + resps + drill)
    check(all(len(t) == NEW_TOKENS for t in streams), "cold stream length")
    check(streams[2] == streams[len(ps.batch)], "greedy determinism: same "
          "prompt, different tokens")
    return ({tuple(p): t for p, t in zip(prompts, streams)},
            ttft_line(label, card, resps, wall), n)


def same_as_cold(cold, prompts, resps) -> bool:
    return tokens_of(resps) == [cold[tuple(p)] for p in prompts]


def bucket_page_difference(cfg, params, ps):
    """Largest |difference| between the K/V rows of the cross-bucket
    follower's whole pages computed in its own bucket (128) and in the
    prompt set's (256), through the engine's chunked prefill (chunks of 64)
    on the card — the bytes a cached page would carry across buckets."""
    page, chunk = cfg.page_size, 4 * cfg.page_size
    n = len(ps.xbucket)
    rows = (n // page) * page
    device = params["embed"]["tok"].device
    out = []
    for bucket in (8 * page, 16 * page):
        toks = torch.zeros((1, bucket), dtype=torch.int32, device=device)
        toks[0, :n] = torch.as_tensor(ps.xbucket, device=device)
        kb, vb = PD.init_chunk_buffers(cfg, bucket, device=device)
        for c0 in range(0, rows, chunk):
            PD.prefill_chunk(cfg, params, toks[:, c0:c0 + chunk], c0,
                             min(chunk, n - c0), kb, vb)
        out.append((kb[:, :rows].to(PD.kv_dtype(cfg)).float(),
                    vb[:, :rows].to(PD.kv_dtype(cfg)).float()))
    return max(float((a - b).abs().max()) for a, b in zip(*out))


def prefix_path(card, cfg, params, ps, cold):
    """Path "prefix cache": the primer, then the batch concurrently over
    HTTP with the prefix cache on; every stream equal to its cold stream;
    hits, skipped compute, copy-on-write and shared pages shipped once per
    ring target; then an instance kill (the busier instance) with the
    batch in flight. Returns (metrics, launches)."""
    label = "prefix cache"
    ecfg = prefix_ecfg(cfg, prefix_cache=True)
    with http_service(cfg, ecfg, params) as (svc, client):
        def run():
            first, resps, wall = primer_then_batch(
                client, ps.primer, ps.batch + [ps.xbucket])
            check(same_as_cold(cold, [ps.primer] + ps.batch,
                               [first] + resps[:-1]),
                  "prefix-cached streams differ from cold serving")
            h = client.health()
            st, repl = h["prefix"], h["replication"]
            print(f"[{label}] prefix stats: " + json.dumps(st))
            check(st["enabled"] and st["prefix_cached_tokens"] > 0,
                  "no prefix-cache hits")
            check(st["prefill_compute_tokens"] < st["prefill_total_tokens"],
                  "the prefix cache skipped no prompt compute")
            check(st["cow_copies"] >= 1, "no copy-on-write")
            # each shared page crossed the wire once per ring target that
            # lacked it: every copy made one hosted page there. A hosting
            # on a target that already held the page from its own traffic
            # ships nothing, so with both instances serving the prefix the
            # ratio copies / hostings is below 1
            check(st["shared_replica_copies"] == st["hosted_pages"] > 0
                  and st["shared_page_ship_ratio"] <= 1.0,
                  "a shared page shipped more than once to a target")
            check(repl["bytes_total"] == repl["blocks_total"]
                  * block_bytes(cfg, False), "replicated bytes per block")
            same = same_as_cold(cold, [ps.xbucket], resps[-1:])
            diff = bucket_page_difference(cfg, params, ps)
            print(f"[{label}] cross-bucket follower ({len(ps.xbucket)} "
                  f"tokens, bucket {8 * cfg.page_size}, its cached pages "
                  f"from bucket {16 * cfg.page_size}) (for information): "
                  f"stream equal to cold serving: {same}; largest K/V "
                  f"difference of its whole pages between the two buckets "
                  f"{diff:.3e}")
            m = ttft_line(label, card, resps, wall)
            m.update(hit_rate=st["hit_rate"],
                     compute_saved_tokens=st["prefill_total_tokens"]
                     - st["prefill_compute_tokens"],
                     ship_ratio=st["shared_page_ship_ratio"],
                     xbucket_stream_equal=same, xbucket_page_diff=diff)

            phase(f"failover ({label})")
            resps2, victim, prefilling = http_kill_drill(
                client, ps.batch, NEW_TOKENS, label)
            retries = sum(r["kevlarflow"]["retries"] for r in resps2)
            check(same_as_cold(cold, ps.batch, resps2),
                  "resumed streams differ from cold serving")
            check(retries <= prefilling, f"{retries} restarts, but only "
                  f"{prefilling} requests were mid-prefill on the victim")
            with svc._lock:
                full, _ = svc.engine.instances[1 - victim].pool.match_prefix(
                    ps.shared, peek=True)
            check(len(full) == SHARED_PAGES,
                  f"the survivor resolves {len(full)} of the prefix's "
                  f"{SHARED_PAGES} pages")
            print(f"failover [{label}] [{card}]: killed instance {victim}; "
                  f"all {len(resps2)} streams byte-identical to cold "
                  f"serving ({retries} restarted); the survivor's index "
                  f"resolves the {SHARED_PAGES}-page chain")
            return m
        m, n = counted(label, "serving and failover", run, PA, PA8,
                       cfg.n_layers)
    return m, n


def decode_launches_by_instance(engine) -> dict:
    """Wrap each instance's decode program: per instance, how many decode
    steps ran and how many attention kernels they launched."""
    counts = {}
    for inst in engine.instances:
        c = counts[inst.instance_id] = {"decode_steps": 0, "launches": 0}

        def decode(*args, fn=inst._decode, c=c):
            before = PA.launches + PA8.launches
            out = fn(*args)
            c["decode_steps"] += 1
            c["launches"] += PA.launches + PA8.launches - before
            return out
        inst._decode = decode
    return counts


@contextlib.contextmanager
def loop_paused(svc):
    """The service loop takes no engine step while the block runs (it sees
    no pending work), so the caller steps the engine by hand; HTTP requests
    are still accepted."""
    eng = svc.engine
    with svc._lock:
        eng.has_pending = eng.recovery_pending = lambda: False
    try:
        yield
    finally:
        with svc._lock:
            del eng.has_pending, eng.recovery_pending


def kill_when(svc, start, n_submitted, cond, kill, label):
    """With the service loop paused: ``start()`` the requests, wait until
    the service holds ``n_submitted``, step the engine by hand until
    ``cond(engine)`` holds and call ``kill()`` right there (the loop still
    paused, the lock free for it) — the state the drill needs, whatever the
    timing. Returns (start()'s result, what ``kill()`` returned)."""
    deadline = time.time() + 300
    with loop_paused(svc):
        started = start()
        while True:
            with svc._lock:
                if svc._next_rid >= n_submitted:
                    break
            check(time.time() < deadline, f"[{label}] requests not submitted")
            time.sleep(0.001)
        with svc._lock:
            eng = svc.engine
            while not cond(eng):
                check(type(eng).has_pending(eng) and time.time() < deadline,
                      f"[{label}] the kill condition never held")
                eng.step()
        resumed = kill()
    return started, resumed


def mid_stream(eng) -> bool:
    """A prompt still prefilling on instance 0 has pages hosted on its
    decode target."""
    return any(not rec.get("final") and rec["dst"] is not None
               and eng.instances[rec["dst"]].pool.replica_table(0, rid)
               for rid, rec in eng._handoffs.items() if rec["src"] == 0)


def disagg_path(card, cfg, params, ps, cold):
    """Path "disaggregated": instance 0 prefills, instance 1 decodes (the
    prefix cache on too); every stream equal to its cold stream, whole
    bf16 blocks on the handoff stream, one seat per request, no attention
    kernel on the prefill side; then the prefill instance killed mid-stream
    and, after it rejoins, the decode instance killed while it decodes and
    handoffs stream to it. Returns (metrics, launches)."""
    label = "disaggregated"
    ecfg = prefix_ecfg(cfg, prefix_cache=True, disaggregate=True)
    with http_service(cfg, ecfg, params) as (svc, client):
        eng = svc.engine

        def run():
            by_inst = decode_launches_by_instance(eng)
            first, resps, wall = primer_then_batch(client, ps.primer,
                                                   ps.batch)
            check(same_as_cold(cold, [ps.primer] + ps.batch,
                               [first] + resps),
                  "disaggregated streams differ from cold serving")
            h = client.health()
            d = h["disagg"]
            print(f"[{label}] disagg stats: " + json.dumps(d))
            print(f"[{label}] decode steps and attention launches per "
                  f"instance: {json.dumps(by_inst)}")
            check(d["roles"] == {"0": "prefill", "1": "decode"}, "roles")
            per_block = d["handoff_bytes_total"] / max(
                d["handoff_blocks_total"], 1)
            check(d["handoff_blocks_total"] > 0
                  and per_block == block_bytes(cfg, False),
                  f"handoff bytes per block {per_block}")
            check(d["handoffs_seated"] == 1 + len(ps.batch),
                  f"{d['handoffs_seated']} handoffs seated")
            check(by_inst[0] == {"decode_steps": 0, "launches": 0}
                  and by_inst[1]["launches"] > 0,
                  "the prefill-role instance decoded")
            m = ttft_line(label, card, resps, wall)
            m.update(handoff_bytes_per_block=per_block,
                     handoff_blocks=d["handoff_blocks_total"],
                     zero_copy_pages=d["handoff_shared_zero_copy_pages"])

            phase(f"failover, prefill side ({label})")
            with svc._lock:
                base = svc._next_rid
            threads, _ = kill_when(
                svc, lambda: client.completions(ps.drill, NEW_TOKENS),
                base + len(ps.drill), mid_stream,
                lambda: svc.fail_instance(0), label)
            resps2 = join(*threads)
            h = client.health()
            event = h["failure_events"][-1]
            print(f"[{label}] prefill instance killed mid-stream: "
                  f"{json.dumps(event)}; streams resumed "
                  f"{h['disagg']['handoff_streams_resumed']}")
            check(same_as_cold(cold, ps.drill, resps2),
                  "streams after the prefill kill differ from cold serving")
            check(h["disagg"]["handoff_streams_resumed"] >= 1
                  or event["resumed"] >= 1,
                  "no handoff resumed on the decode side")
            client.post("/v1/admin/recover",
                        {"granularity": "instance", "instance_id": 0})

            phase(f"failover, decode side ({label})")
            wave_a, wave_b = ps.batch[:3], ps.batch[3:]
            with svc._lock:
                base = svc._next_rid
            threads_a = client.completions(wave_a, NEW_TOKENS)
            deadline = time.time() + 300
            while True:        # wave A seated on 1 and replicated to 0
                with svc._lock:
                    live = [r for r in eng.instances[1].requests.values()
                            if r.rid >= base and r.rid in eng.replica_meta]
                if len(live) == len(wave_a):
                    break
                check(time.time() < deadline, "wave A never decoded")
                time.sleep(0.002)
            threads_b, resumed = kill_when(
                svc, lambda: client.completions(wave_b, NEW_TOKENS),
                base + len(ps.batch),
                lambda e: any(rec["dst"] == 1
                              for rec in e._handoffs.values()),
                lambda: svc.fail_instance(1), label)
            resps3 = join(*threads_a) + join(*threads_b)
            h = client.health()
            print(f"[{label}] decode instance killed with handoffs in "
                  f"flight: {json.dumps(h['failure_events'][-1])}")
            check(same_as_cold(cold, ps.batch, resps3),
                  "streams after the decode kill differ from cold serving")
            check(len(resumed) >= 1 and max(
                r["kevlarflow"]["migrations"] for r in resps3) >= 1,
                "no victim migrated")
            check(h["disagg"]["handoffs_in_flight"] == 0,
                  "handoffs left in flight")
            print(f"failover [{label}] [{card}]: both kills byte-identical "
                  "to cold serving")
            return m
        m, n = counted(label, "serving and both failovers", run, PA, PA8,
                       cfg.n_layers)
    return m, n


def shared_prefix_phases(card, cfg, params) -> int:
    """The cold reference, then the two paths on the same weights. Returns
    the bf16 attention kernel's launches on the three."""
    ps = shared_prefix_set(cfg)
    lens = [len(p) for p in [ps.primer] + ps.batch]
    lens += [len(p) for p in ps.drill]
    print(f"shared-prefix prompt set: prefix {len(ps.shared)} tokens "
          f"({SHARED_PAGES} pages); primer, batch and drill lengths {lens}; "
          f"cross-bucket follower {len(ps.xbucket)}")
    check(all(8 * cfg.page_size < n <= 16 * cfg.page_size for n in lens),
          "every prompt in one prefill bucket")
    phase("serving (cold reference)")
    cold, m_cold, n_cold = cold_reference(card, cfg, params, ps)
    phase("serving (prefix cache)")
    m_pre, n_pre = prefix_path(card, cfg, params, ps, cold)
    phase("serving (disaggregated)")
    m_dis, n_dis = disagg_path(card, cfg, params, ps, cold)
    print(f"TTFT cold / prefix-cached / disaggregated [{card}] (for "
          "information): " + json.dumps(
              {k: {"ttft_s_median": m["ttft_s_median"],
                   "ttft_s_max": m["ttft_s_max"],
                   "tokens_per_s": m["tokens_per_s"]}
               for k, m in (("cold", m_cold), ("prefix_cache", m_pre),
                            ("disaggregated", m_dis))}))
    print(f"prefix cache [{card}]: " + json.dumps(m_pre))
    print(f"disaggregated [{card}]: " + json.dumps(m_dis))
    return n_cold + n_pre + n_dis


# -- 16.-18. fleet, fleet chaos, shard degraded -------------------------------

FLEET = 8                 # instances
FLEET_PROMPTS = 24        # concurrent prompts of 16-200 tokens
REJOIN_DELAY = 3.0        # seconds until a failed instance's warm spare


def fleet_ecfg() -> EngineConfig:
    """4 slots of 256 tokens an instance (129 pool blocks), 4 shards,
    rendezvous placement, warm spares after REJOIN_DELAY s."""
    return EngineConfig(max_slots=4, max_seq=256, n_shards=4,
                        placement="rendezvous", auto_rejoin=True,
                        rejoin_delay=REJOIN_DELAY)


def wait_health(client, cond, what, timeout=300.0):
    """Poll /health until ``cond(health)`` holds; returns that health."""
    deadline = time.time() + timeout
    while True:
        h = client.health()
        if cond(h):
            return h
        check(time.time() < deadline, f"timed out waiting for {what}")
        time.sleep(0.02)


def decoding(inst) -> int:
    return sum(r.state == RequestState.DECODE for r in inst.requests.values())


def time_rejoins(eng) -> list:
    """Wrap the engine's warm-spare rejoin: (instance, wall seconds) per
    rejoin, the new pool's allocation included (synchronised)."""
    times = []
    recover = eng._recover_instance

    def timed(iid):
        t0 = time.perf_counter()
        out = recover(iid)
        torch.cuda.synchronize()
        times.append((iid, time.perf_counter() - t0))
        return out
    eng._recover_instance = timed
    return times


def chaos_drill(card, svc, client, prompts, want) -> dict:
    """A correlated kill of instances 0, 1 and 2 while the 24 prompts
    decode (all three faults through /v1/admin/fault with the service loop
    paused, so they land at one engine time), then, once instance 0's
    warm spare rejoins, a second wave of 8 prompts and a second kill of
    instance 0 as soon as it decodes one of them. Every stream must equal
    failure-free serving; the fleet must heal (8 alive, epoch 8, an empty
    plan)."""
    label = "fleet chaos"
    eng = svc.engine
    rejoins = time_rejoins(eng)
    epoch0 = client.health()["topology"]["epoch"]
    threads, out, errs = client.completions(prompts, NEW_TOKENS)
    wait_health(client, lambda h: sum(
        i["active"] for i in h["instances"]) == len(prompts) and all(
        h["instances"][v]["active"] > 0 for v in (0, 1, 2)),
        "every prompt seated")
    with loop_paused(svc):
        with svc._lock:
            victims = {v: decoding(eng.instances[v]) for v in (0, 1, 2)}
        faults = [client.post("/v1/admin/fault",
                              {"granularity": "instance", "instance_id": v})
                  for v in (0, 1, 2)]
    check(all(f["applied"] for f in faults), "a correlated fault not applied")
    print(f"[{label}] killed instances 0, 1, 2 together (decoding "
          f"{victims}); seamlessly resumed "
          f"{[f['seamlessly_resumed'] for f in faults]}")
    wait_health(client, lambda h: any(
        e["instance"] == 0 and e["t_rejoin"] >= 0
        for e in h["failure_events"]), "instance 0's warm spare")
    wave2 = prompts[:8]
    with svc._lock:
        base = svc._next_rid

    def kill0():
        return client.post("/v1/admin/fault",
                           {"granularity": "instance", "instance_id": 0,
                            "if_busy": True})
    (threads2, out2, errs2), fault = kill_when(
        svc, lambda: client.completions(wave2, NEW_TOKENS),
        base + len(wave2), lambda e: decoding(e.instances[0]) > 0, kill0,
        label)
    check(fault["applied"], "the second kill found instance 0 idle")
    resps = join(threads, out, errs)
    resps2 = join(threads2, out2, errs2)
    h = wait_health(client, lambda h: all(
        i["alive"] for i in h["instances"])
        and not h["topology"]["planner"]["plan"], "the fleet to heal")
    events = h["failure_events"]
    second = events[-1]
    print(f"[{label}] second kill of instance 0 (its spare, decoding wave "
          f"2): {json.dumps(second)}")
    check(second["instance"] == 0 and second["n_victims"] >= 1,
          "the second kill landed on no in-flight work")
    check(tokens_of(resps) == [want[tuple(p)] for p in prompts]
          and tokens_of(resps2) == [want[tuple(p)] for p in wave2],
          "a stream differs from failure-free serving")
    epoch = h["topology"]["epoch"] - epoch0
    mttr = [round(e["mttr"], 4) for e in events]
    resumed = sum(e["resumed"] for e in events)
    restarted = sum(e["restarted"] for e in events)
    check(len(events) == 4 and all(e["mttr"] >= 0 for e in events),
          "four closed failure events")
    check(epoch == 8, f"epoch moved by {epoch}, not 8")
    check(resumed >= 1, "no victim resumed from its replica")
    retries = [r["kevlarflow"]["retries"] for r in resps + resps2]
    migrations = [r["kevlarflow"]["migrations"] for r in resps + resps2]
    m = {"instances": FLEET, "requests": len(resps) + len(resps2),
         "mttr_s_per_event": mttr,
         "rejoin_wall_s": [round(t, 4) for _, t in rejoins],
         "rejoined_instances": [i for i, _ in rejoins],
         "resumed": resumed, "restarted": restarted,
         "migrations": sum(migrations), "retries": sum(retries),
         "epoch_delta": epoch}
    print(f"fleet chaos [{card}]: every stream byte-identical to "
          "failure-free serving; " + json.dumps(m))
    return m


def shard_drill(card, svc, client, prompts, want, cfg) -> dict:
    """25 prompts (the 24 and a repeat of the first) with the loop paused
    and the engine stepped by hand until an instance holds 4 decoding,
    replicated requests; a shard-1 fault on it through /v1/admin/fault;
    /health must show it DEGRADED (lost_shards [1], slot_cap 3, the layout
    of full-width Llama-3.1-8B over 3 shards), the excess request must
    migrate, and the instance must never seat more than 3 while degraded;
    a shard recover then restores it HEALTHY at full capacity, and every
    stream equals failure-free serving."""
    label = "shard degraded"
    eng = svc.engine
    wave = prompts + prompts[:1]
    with svc._lock:
        base = svc._next_rid
    peak = {}

    def full_and_replicated(e):
        return any(decoding(i) == e.ecfg.max_slots and all(
            rid in e.replica_meta for rid in i.requests)
            for i in e.instances)

    def shard_fault():
        with svc._lock:
            inst = max(eng.instances, key=lambda i: (decoding(i),
                                                     -i.instance_id))
            step = inst.step

            def watched(now, inst=inst, step=step):
                if inst.lost_shards:
                    peak[inst.instance_id] = max(
                        peak.get(inst.instance_id, 0), len(inst.requests))
                return step(now)
            inst.step = watched
        return inst.instance_id, client.post(
            "/v1/admin/fault", {"granularity": "shard",
                                "instance_id": inst.instance_id,
                                "shard_idx": 1})
    threads, (victim, fault) = kill_when(
        svc, lambda: client.completions(wave, NEW_TOKENS), base + len(wave),
        full_and_replicated, shard_fault, label)
    check(fault["applied"], "shard fault not applied")
    with loop_paused(svc):
        h = client.health()
        deg = h["instances"][victim]["degradation"]
        event = h["failure_events"][-1]
        layout = deg["layout"]
        print(f"[{label}] shard 1 of instance {victim} lost: "
              f"{json.dumps({k: deg[k] for k in deg if k != 'layout'})}; "
              f"event {json.dumps(event)}")
        print(f"[{label}] layout of {cfg.name} over the 3 surviving shards "
              f"[{card}]: " + json.dumps(layout))
        check(deg["state"] == "DEGRADED" and deg["lost_shards"] == [1]
              and deg["slot_cap"] == 3 and deg["capacity_frac"] == 0.75,
              "health does not show the degradation")
        check(layout is not None and layout["n_shards"] == 4
              and layout["surviving"] == 3
              and layout["params_replicate_fallback"] > 0,
              "no layout for the degraded instance")
        check(h["topology"]["states"][str(victim)] == "DEGRADED",
              "topology state")
        check(event["granularity"] == "shard" and event["n_victims"] == 1
              and event["resumed"] + event["restarted"] == 1
              and h["instances"][victim]["active"] == 3,
              "not exactly the excess request migrated")
        with svc._lock:
            for _ in range(3):          # decode while degraded
                eng.step()
        client.post("/v1/admin/recover",
                    {"granularity": "shard", "instance_id": victim})
        h = client.health()
    deg = h["instances"][victim]["degradation"]
    check(deg["state"] == "HEALTHY" and deg["slot_cap"] == 4
          and deg["capacity_frac"] == 1.0 and deg["layout"] is None,
          "the shard recover did not restore full capacity")
    check(peak.get(victim, 0) <= 3, f"seated {peak.get(victim)} while "
          "degraded")
    resps = join(*threads)
    check(tokens_of(resps) == [want[tuple(p)] for p in wave],
          "a stream differs from failure-free serving")
    closed = client.health()["failure_events"][-1]
    m = {"victim": victim, "slot_cap_degraded": 3,
         "peak_seated_degraded": peak.get(victim, 0),
         "excess_resumed": event["resumed"],
         "excess_restarted": event["restarted"],
         "shard_mttr_s": closed["mttr"],
         "param_bytes_per_shard": [layout["param_bytes_per_shard_full"],
                                   layout["param_bytes_per_shard_degraded"]],
         "kv_bytes_per_shard": [layout["kv_bytes_per_shard_full"],
                                layout["kv_bytes_per_shard_degraded"]]}
    print(f"shard degraded [{card}]: every stream byte-identical to "
          "failure-free serving; " + json.dumps(m))
    return m


def fleet_phases(card, cfg, params) -> tuple:
    """The 8-instance fleet on the given weights: failure-free serving,
    the chaos drill, the shard drill; then, for comparison with the warm
    spares' rejoin times, one cold init_params + executor build. Returns
    the bf16 attention kernel's launches and the cold build's seconds."""
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, cfg.vocab_size, int(n)).tolist()
               for n in rng.integers(16, 201, FLEET_PROMPTS)]
    ecfg = fleet_ecfg()
    launches = 0
    with http_service(cfg, ecfg, params, n_instances=FLEET) as (svc, client):
        pool = svc.engine.instances[0].pool
        print(f"fleet: {FLEET} instances of {cfg.name}, each pool "
              f"{pool.n_blocks} blocks of {pool.block_nbytes} B "
              f"({pool.n_blocks * pool.block_nbytes / 1e9:.3f} GB); "
              f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated; "
              f"prompt lengths {[len(p) for p in prompts]}")
        phase("fleet (failure-free)")
        warm = client.post("/v1/completions",
                           {"prompt_tokens": prompts[0], "max_tokens": 4})
        check(len(warm["choices"][0]["token_ids"]) == 4, "warm-up")
        t0 = time.perf_counter()
        resps, n = counted("fleet", "failure-free serving",
                           lambda: join(*client.completions(prompts,
                                                            NEW_TOKENS)),
                           PA, PA8, cfg.n_layers)
        launches += n
        m = serving_metrics(resps, time.perf_counter() - t0)
        print(f"fleet failure-free [{card}]: " + json.dumps(m))
        want = {tuple(p): t for p, t in zip(prompts, tokens_of(resps))}
        check(all(len(t) == NEW_TOKENS for t in want.values()),
              "stream length")
        phase("fleet chaos")
        _, n = counted("fleet chaos", "the drill",
                       lambda: chaos_drill(card, svc, client, prompts, want),
                       PA, PA8, cfg.n_layers)
        launches += n
        phase("shard degraded")
        _, n = counted("shard degraded", "the drill",
                       lambda: shard_drill(card, svc, client, prompts, want,
                                           cfg),
                       PA, PA8, cfg.n_layers)
        launches += n
    t0 = time.perf_counter()
    cold = transformer.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(1), device="cuda")
    FamilyExecutor(cfg, ecfg)
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    print(f"cold init_params + executor build of {cfg.name} [{card}] (for "
          f"information, beside the warm-spare rejoins above): "
          f"{cold_s:.3f} s")
    del cold
    return launches, cold_s


# -- 19. decoupled init -------------------------------------------------------

DECOUPLED_PROMPT = 200     # tokens: bucket 256, 13 pages written


def tree_leaves(tree) -> list:
    """Every tensor of a nested dict / list of tensors, in order."""
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in tree_leaves(v)]
    if isinstance(tree, list):
        return [t for v in tree for t in tree_leaves(v)]
    return [tree]


def pipeline_step(cfg, ex, params):
    """What a re-formed pipeline runs first: one bucketed prefill of a
    DECOUPLED_PROMPT-token prompt into a fresh paged pool, then one decode
    step through ``ex`` (so one attention call a layer). Returns the
    decode logits."""
    page = cfg.page_size
    bucket = PD.next_bucket(DECOUPLED_PROMPT, lo=page)
    tokens = torch.zeros((1, bucket), dtype=torch.int32, device="cuda")
    tokens[0, :DECOUPLED_PROMPT] = torch.arange(
        1, DECOUPLED_PROMPT + 1, device="cuda")
    logits, k, v = ex.prefill(params, tokens, DECOUPLED_PROMPT)
    width = bucket // page
    pool = PagedKVPool(width + 1, page, cfg.n_layers, cfg.n_kv_heads,
                       cfg.head_dim, real=True, dtype=PD.kv_dtype(cfg),
                       device="cuda")
    refs = pool.allocate(0, DECOUPLED_PROMPT + 1)
    n_pages = -(-DECOUPLED_PROMPT // page)
    pool.write_blocks([r.slot for r in refs[:n_pages]],
                      *PD.pack_pages(k, v, n_pages, page))
    bt = torch.tensor([[r.slot for r in refs] + [width] * (width - len(refs))],
                      dtype=torch.int32, device="cuda")
    pos = torch.tensor([DECOUPLED_PROMPT], dtype=torch.int32, device="cuda")
    first = logits.argmax(-1).to(torch.int32)
    _, out = ex.decode(params, first, pool.k, pool.v, None, None, bt, pos,
                       torch.zeros_like(pos), None)
    torch.cuda.synchronize()
    return out


def pinned_copy_s(leaves) -> float:
    """Device time of copying ``leaves``' bytes from pinned host memory to
    the card, through one 512 MiB pinned buffer and one device buffer (each
    piece first staged to the host, untimed): the on-machine part of a
    weight load."""
    chunk = 512 * 2**20
    host = torch.empty(chunk, dtype=torch.uint8, pin_memory=True)
    dev = torch.empty(chunk, dtype=torch.uint8, device="cuda")
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    total_ms = 0.0
    for t in leaves:
        flat = t.reshape(-1).view(torch.uint8)
        for i in range(0, flat.numel(), chunk):
            n = min(chunk, flat.numel() - i)
            host[:n].copy_(flat[i:i + n])
            torch.cuda.synchronize()
            start.record()
            dev[:n].copy_(host[:n], non_blocking=True)
            stop.record()
            stop.synchronize()
            total_ms += start.elapsed_time(stop)
    del host, dev
    return total_ms / 1e3


def decoupled_init_phase(card, cfg, params, cold_s) -> int:
    """The torch counterpart of tests/test_decoupled_init.py at full width:
    a 2 x 4 group (metadata pools) whose nodes hold ``params``; the port's
    CommunicatorManager builds a FamilyExecutor over them per new topology
    and runs ``pipeline_step``. The initial form, a re-form with stage 2
    served by instance 1's node, and the return to the first topology (a
    cache hit) are timed; no parameter moves and no second copy of the
    weights appears. Returns the bf16 attention kernel's launches."""
    group = build_group(2, 4)
    for node in group.nodes:
        node.weights = params
    leaves = tree_leaves(params)
    ptrs = [t.data_ptr() for t in leaves]
    weight_bytes = tree_bytes(params)
    ecfg = EngineConfig(max_slots=8, max_seq=256)
    outputs = []

    def build_executable(nodes):
        check(all(n.weights is params for n in nodes),
              "a node of the pipeline holds other weights")
        ex = FamilyExecutor(cfg, ecfg)
        outputs.append(pipeline_step(cfg, ex, nodes[0].weights))
        return ex

    mgr = CommunicatorManager(build_executable=build_executable)
    home = group.instances[0].stage_nodes
    patched = list(home)
    patched[2] = group.instances[1].home_nodes[2]

    def forms():
        times, mem = [], []
        for nodes in (home, patched, home):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            mgr.form(cfg.name, nodes, 0.0)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            mem.append(torch.cuda.memory_allocated())
        return times, mem

    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    (times, mem), n = counted("decoupled init", "the three forms", forms,
                              PA, PA8, cfg.n_layers)
    t_initial, t_reform, t_cached = times
    grown = mem[1] - mem0
    print(f"decoupled init [{card}]: initial form {t_initial:.4f} s, "
          f"re-form to the patched topology {t_reform:.4f} s, return to "
          f"the first topology (cache hit) {t_cached * 1e6:.1f} us; stats "
          f"{mgr.stats}; allocated after the re-form {grown / 2**20:+.1f} "
          f"MiB against {weight_bytes / 1e9:.3f} GB of weights")
    check(mgr.stats["cache_hits"] == 1 and mgr.stats["compiles"] == 2,
          f"communicator stats {mgr.stats}")
    check([t.data_ptr() for t in leaves] == ptrs,
          "a parameter tensor moved during the re-forms")
    check(grown < 0.05 * weight_bytes,
          f"allocated grew by {grown} B over the re-form: a second copy "
          "of the weights?")
    check(t_cached < t_initial, "the cached form was not faster")
    check(len(outputs) == 2 and bool(torch.isfinite(outputs[0]).all())
          and torch.equal(outputs[0], outputs[1]),
          "the patched pipeline's decode logits differ from the first's")
    copy_s = pinned_copy_s(leaves)
    print(f"decoupled init [{card}], for information: cold materialization "
          f"of {cfg.name}'s params + executor build (fleet phase) "
          f"{cold_s:.3f} s; host-to-device copy of the "
          f"{weight_bytes / 1e9:.3f} GB of weights from pinned host memory "
          f"{copy_s:.3f} s "
          f"({weight_bytes / copy_s / 1e9:.1f} GB/s) — the part of a weight "
          "load that happens on this machine; a fetch from remote storage "
          "is not measured")
    return n


# -- 20. open-loop failure drill ----------------------------------------------

# ShareGPT-shaped prompts at the paper's lengths, outputs shortened so a run
# takes tens of seconds; the kill lands at DRILL_FAIL_AT seconds
DRILL_WORKLOAD = dict(duration=20.0, seed=0, prompt_mean=220.0,
                      max_prompt=448, output_mean=64.0, min_output=4,
                      max_output=128)
DRILL_RPS, DRILL_FAIL_AT = 1.5, 8.0
DRILL_TTFT_P99_LIMIT = 2.0   # seconds: above it queueing decides the numbers


def drill_ecfg(mode: str) -> EngineConfig:
    # reload_penalty is 20x the rejoin delay, the reference bench's ratio
    return EngineConfig(max_slots=8, max_seq=640, prefill_chunk=64,
                        recovery=mode, replicate=mode == "kevlarflow",
                        auto_rejoin=True, rejoin_delay=0.5,
                        reload_penalty=10.0)


def drill_warmup(svc, cfg):
    """Every prefill bucket a drill prompt can land in, once, before the
    clock starts."""
    page = cfg.page_size
    buckets = sorted({PD.next_bucket(n, lo=page)
                      for n in range(page, DRILL_WORKLOAD["max_prompt"] + 1)})
    rng = np.random.default_rng(1)
    warm = [svc.submit(rng.integers(1, cfg.vocab_size,
                                    max(page, b // 2 + 1)).tolist(), 2)
            for b in buckets]
    for req in warm:
        check(svc.wait(req, timeout=300.0), "warm-up request timed out")


def drill_kill(svc, t0, out):
    """At DRILL_FAIL_AT s kill instance 0 as soon as it decodes a request
    (bounded wait), under the service lock, noting how many of its
    requests were mid-prefill just before."""
    while time.time() < t0 + DRILL_FAIL_AT:
        time.sleep(0.005)
    deadline = time.time() + 10.0
    while True:
        with svc._lock:
            inst = svc.engine.instances[0]
            prefilling = inst.prefill_depth()
            if len(inst.requests) > prefilling or time.time() > deadline:
                svc.engine.apply_fault(
                    FaultSpec(granularity="instance", instance_id=0))
                break
        time.sleep(0.002)
    out.update(at=time.time() - t0, prefilling=prefilling)


def drill_state() -> dict:
    """What a run starts from, on the card and on the host: CUDA memory
    allocated and reserved, live Python threads and objects, and the card's
    SM clock (against its maximum), temperature and power draw."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,temperature.gpu,"
         "power.draw", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    sm, sm_max, temp, draw = (float(v) for v in
                              smi.strip().splitlines()[0].split(","))
    return {"allocated_gib": torch.cuda.memory_allocated() / 2**30,
            "reserved_gib": torch.cuda.memory_reserved() / 2**30,
            "threads": threading.active_count(),
            "gc_objects": len(gc.get_objects()),
            "sm_mhz": sm, "sm_max_mhz": sm_max, "temp_c": temp,
            "power_w": draw}


def drill_run(cfg, params, mode, work, kill) -> dict:
    """One open-loop replay of ``work`` through a fresh EngineService on
    ``params``: arrivals never wait for the engine; with ``kill``, instance
    0 dies mid-run. Returns the run's metrics and streams."""
    svc = EngineService(cfg, drill_ecfg(mode), n_instances=2, device="cuda",
                        params=params)
    kill_info = {}
    try:
        drill_warmup(svc, cfg)
        state = drill_state()
        t0 = time.time()
        killer = threading.Thread(target=drill_kill,
                                  args=(svc, t0, kill_info))
        if kill:
            killer.start()
        reqs = []
        for w in work:
            dt = t0 + w.arrival_time - time.time()
            if dt > 0:
                time.sleep(dt)
            reqs.append(svc.submit(w.prompt_tokens, w.max_new_tokens))
        if kill:
            killer.join(timeout=60)
            check(not killer.is_alive(), "the kill did not happen")
        check(svc.drain(timeout=600.0), f"[{mode}] the run did not drain")
        makespan = time.time() - t0
        # the spare's rejoin may land after the last completion
        deadline = time.time() + drill_ecfg(mode).reload_penalty + 5.0
        while kill and time.time() < deadline:
            with svc._lock:
                if svc.engine.mttr_events():
                    break
            time.sleep(0.01)
        with svc._lock:
            events = [dict(e) for e in svc.engine.failure_events]
    finally:
        svc.shutdown()
    check(svc.error is None, f"[{mode}] the engine loop failed")
    m = summarize(reqs, span=makespan)
    m["n_submitted"] = len(reqs)
    m["makespan_s"] = makespan
    m["streams"] = [list(r.output_tokens or []) for r in reqs]
    m["state"] = state
    if kill:
        ev = events[0]
        m.update(killed_at_s=kill_info["at"],
                 mid_prefill_on_victim=kill_info["prefilling"],
                 mttr_s=ev["mttr"], victims=ev["n_victims"],
                 resumed=ev["resumed"], requeued=ev["requeued"],
                 restarted=ev["restarted"])
    return m


DRILL_KEYS = ("n", "n_submitted", "makespan_s", "mttr_s", "latency_avg",
              "latency_p99", "ttft_avg", "ttft_p99", "tpot_avg",
              "goodput_req_s", "goodput_tok_s", "retries", "migrations",
              "victims", "resumed", "requeued", "restarted", "killed_at_s",
              "mid_prefill_on_victim", "state")


def open_loop_drill_phase(card, cfg, params) -> int:
    """The paper's open-loop failure drill on the card: a ShareGPT-shaped
    Poisson workload (the port's poisson_workload and attach_prompt_tokens)
    replayed through EngineService on ``params``, failure-free under
    kevlarflow (the reference streams), then with instance 0 killed at
    DRILL_FAIL_AT s under kevlarflow and under standard recovery. Returns
    the bf16 attention kernel's launches."""
    rps, launches = DRILL_RPS, 0
    while True:
        work = attach_prompt_tokens(poisson_workload(rps, **DRILL_WORKLOAD),
                                    cfg.vocab_size, seed=0)
        print(f"open-loop drill: {len(work)} requests at {rps} req/s over "
              f"{DRILL_WORKLOAD['duration']} s, prompts "
              f"{min(w.prompt_len for w in work)}-"
              f"{max(w.prompt_len for w in work)} tokens (mean "
              f"{statistics.mean(w.prompt_len for w in work):.1f}), outputs "
              f"{min(w.max_new_tokens for w in work)}-"
              f"{max(w.max_new_tokens for w in work)} (mean "
              f"{statistics.mean(w.max_new_tokens for w in work):.1f})")
        runs = {}
        for label, mode, kill in (("failure-free", "kevlarflow", False),
                                  ("kevlarflow", "kevlarflow", True),
                                  ("standard", "standard", True)):
            runs[label], n = counted(
                "open-loop drill", f"the {label} run",
                lambda: drill_run(cfg, params, mode, work, kill), PA, PA8,
                cfg.n_layers)
            launches += n
            m = runs[label]
            print(f"open-loop drill [{label}] [{card}]: " + json.dumps(
                {k: m[k] for k in DRILL_KEYS if k in m}))
            check(m["n"] == m["n_submitted"] == len(work),
                  f"[{label}] {m['n']} of {len(work)} requests completed")
            if label == "failure-free" and \
                    m["ttft_p99"] > DRILL_TTFT_P99_LIMIT and rps == DRILL_RPS:
                break
        if len(runs) == 3:
            break
        print(f"open-loop drill: failure-free p99 TTFT "
              f"{runs['failure-free']['ttft_p99']:.3f} s > "
              f"{DRILL_TTFT_P99_LIMIT} s at {rps} req/s: queueing decides "
              "the numbers; once more at half the rate")
        rps /= 2
    want = runs["failure-free"]["streams"]
    for label in ("kevlarflow", "standard"):
        check(runs[label]["streams"] == want,
              f"[{label}] streams differ from the failure-free run")
    kf, st = runs["kevlarflow"], runs["standard"]
    check(kf["migrations"] >= 1, "kevlarflow: no request migrated")
    check(kf["retries"] <= kf["mid_prefill_on_victim"]
          and kf["restarted"] == kf["retries"],
          f"kevlarflow: {kf['retries']} retries, but "
          f"{kf['mid_prefill_on_victim']} requests were mid-prefill on the "
          "victim")
    check(kf["mttr_s"] >= 0 and st["mttr_s"] >= 0,
          "an MTTR event is missing")
    check(st["retries"] >= 1 and st["migrations"] == 0,
          f"standard: {st['retries']} retries, {st['migrations']} migrations")
    print(f"open-loop drill [{card}]: every stream of both failure runs "
          f"equals the failure-free run; standard / kevlarflow: latency avg "
          f"{st['latency_avg'] / kf['latency_avg']:.3f}x, p99 "
          f"{st['latency_p99'] / kf['latency_p99']:.3f}x; TTFT avg "
          f"{st['ttft_avg'] / kf['ttft_avg']:.3f}x, p99 "
          f"{st['ttft_p99'] / kf['ttft_p99']:.3f}x; MTTR "
          f"{st['mttr_s']:.3f} s vs {kf['mttr_s']:.3f} s. The standard "
          f"run's stall is the set reload_penalty "
          f"({drill_ecfg('standard').reload_penalty} s), not a measured "
          "weight reload")
    return launches


# -- 21. dense configs --------------------------------------------------------

# (config, layers served: None = all) and the replication block bytes
# /health must report
DENSE_CONFIGS = (("yi-9b", None, 1_572_864), ("qwen1.5-0.5b", None, 1_572_864),
                 ("qwen1.5-32b", None, 10_649_600),
                 ("deepseek-67b", 52, 3_407_872))
DEPTH_CUTS = {
    "deepseek-67b": "all 95 layers are 134.9 GB of bf16 weights, more than "
                    "the card holds; 52 is the deepest whose peak, printed "
                    "below, leaves room for the CUDA context (each layer "
                    "adds 1.29 GiB)"}


def dense_config_phases(card) -> dict:
    """yi-9b, qwen1.5-0.5b, qwen1.5-32b and deepseek-67b at full width, one
    after another on fresh random weights (torch.Generator seed 0): 2
    instances, replication on, the int8 pool where the config's KV dtype
    is int8; serving twice, an instance kill, a decode-step profile.
    Returns each attention kernel's launches."""
    out = {"paged_attention": 0, "paged_attention_int8": 0}
    for name, depth, block in DENSE_CONFIGS:
        full = get_config(name)
        cfg = full if depth is None else dataclasses.replace(
            full, n_layers=depth)
        cut = f"depth cut to {depth} of {full.n_layers} layers: " \
            f"{DEPTH_CUTS[name]}" if depth else "full depth"
        phase(f"dense config {name}")
        before = torch.cuda.memory_allocated() / 2**30
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params = transformer.init_params(
            cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda")
        torch.cuda.synchronize()
        quant = cfg.kv_dtype == "int8"
        print(f"model {name}: {cfg.n_layers} layers ({cut}), d_model "
              f"{cfg.d_model}, heads {cfg.n_heads}/{cfg.n_kv_heads} (rep "
              f"{cfg.q_per_kv}), head_dim {cfg.head_dim}, d_ff {cfg.d_ff}, "
              f"vocab {cfg.vocab_size}, qkv_bias {cfg.qkv_bias}, "
              f"{cfg.n_params() / 1e9:.2f} B params "
              f"({2 * cfg.n_params() / 1e9:.1f} GB bf16), "
              f"{'int8' if quant else 'bf16'} KV pool; random weights made "
              f"in {time.perf_counter() - t0:.1f} s ({before:.1f} GiB "
              "allocated before)")
        check(block_bytes(cfg, quant) == block, "block bytes")
        rng = np.random.default_rng(0)
        prompts = [rng.integers(1, cfg.vocab_size, n).tolist()
                   for n in SERVE_PROMPT_LENS]
        prompts.append(list(prompts[1]))      # the same prompt twice
        kernel, idle = (PA8, PA) if quant else (PA, PA8)
        n = run_path(card, cfg, EngineConfig(max_slots=8, max_seq=256,
                                             kv_quant=quant),
                     kernel, idle, name, prompts, params=params,
                     repeat=True)[0]
        out[kname(kernel)] += n
        card_gib = torch.cuda.get_device_properties(0).total_memory / 2**30
        peak = torch.cuda.max_memory_allocated() / 2**30
        held = torch.cuda.max_memory_reserved() / 2**30
        print(f"[{name}] peak memory: {peak:.2f} GiB allocated, {held:.2f} "
              f"GiB reserved, of the card's {card_gib:.2f} GiB [{card}]")
        del params
        gc.collect()
        torch.cuda.empty_cache()
    return out


# -- 22.-24. MoE configs -----------------------------------------------------

# (config, layers served at full width, whether its invariant phase runs):
# the deepest depth at which every phase of the config passes on one H100
# 80GB HBM3 (700 W): the phases' peak at a probe depth plus a layer's
# bytes (mixtral 25 -> 26 fits, dbrx 11 -> 12 does not); each config's
# peak is printed
MOE_CONFIGS = (("mixtral-8x7b", 26, True), ("dbrx-132b", 11, False))
MOE_DEPTH_CUTS = {
    "mixtral-8x7b": "all 32 layers are 92.9 GB of bf16 weights; a layer "
                    "adds 2.70 GiB, and on an H100 80GB HBM3 every phase at "
                    "25 layers peaked at 73.45 GiB of its 79.18, so 26 is "
                    "the deepest that fits",
    "dbrx-132b": "all 40 layers are 260.7 GB of bf16 weights; a layer adds "
                 "6.07 GiB, and on an H100 80GB HBM3 every phase at 11 "
                 "layers peaked at 73.73 GiB of its 79.18"}
# mixtral's window phase: 4000-token prompts and 128 new tokens, so
# positions pass the 4096-token window and the first page is retired at
# position 4111, 16 tokens before the end
WINDOW_PROMPT, WINDOW_NEW = 4000, 128


def busiest_decoding(eng):
    """The alive instance decoding the most requests, once no request is
    waiting to be seated and some instance decodes; else None."""
    if eng.queued_requests() or eng.waiting:
        return None
    counts = [decoding(i) if i.alive else -1 for i in eng.instances]
    return int(np.argmax(counts)) if max(counts) > 0 else None


def engine_run(cfg, params, ecfg, waves, n_new, kill=None):
    """Serve ``waves`` of prompts on a 2-instance RealEngine stepped by
    hand (each wave submitted once the one before has finished), ``n_new``
    greedy tokens each. ``kill(eng)`` is asked after every step until it
    names an instance, which is killed right there. Returns (streams in
    prompt order, the requests, the most pages one request held, the
    engine)."""
    gc.collect()                  # the last run's engine and its pools
    torch.cuda.empty_cache()
    eng = RealEngine(cfg, ecfg, n_instances=2, device="cuda", params=params)
    reqs, peak, killed = [], 0, False
    for wave in waves:
        batch = [Request(rid=len(reqs) + i, prompt_len=len(p),
                         max_new_tokens=n_new, arrival_time=0.0,
                         prompt_tokens=list(p)) for i, p in enumerate(wave)]
        reqs += batch
        for r in batch:
            eng.submit(r)
        while eng.has_pending():
            eng.step()
            for inst in eng.instances:
                if inst.alive:
                    for rid in inst.requests:
                        peak = max(peak, len(inst.pool.table(rid)))
            if kill is not None and not killed:
                victim = kill(eng)
                if victim is not None:
                    eng.fail_instance(victim)
                    killed = True
    check(kill is None or killed, "the kill condition never held")
    return [r.output_tokens for r in reqs], reqs, peak, eng


def moe_mlp_profile(card, cfg, params):
    """``moe.decode_mlp`` alone on layer 0 at B 8: device time per call
    (kernel sums under torch.profiler, and CUDA events around 5 calls),
    times the layers, beside the weight-read bound (every expert's three
    bf16 matrices read once)."""
    p = layer_params(params["layers"], 0)
    gen = torch.Generator(device="cuda").manual_seed(5)
    x = torch.randn((8, 1, cfg.d_model), generator=gen,
                    device="cuda").to(params["embed"]["tok"].dtype)
    for _ in range(2):
        moe.decode_mlp(cfg, p, x)
    n = 5
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(n):
        moe.decode_mlp(cfg, p, x)
    stop.record()
    torch.cuda.synchronize()
    events_ms = start.elapsed_time(stop) / n
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(n):
            moe.decode_mlp(cfg, p, x)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / n / 1e3
    w = p["experts"]["w_gate"]
    nbytes = 3 * w.numel() * w.element_size()
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    m = {"layer_device_busy_ms": busy, "layer_events_ms": events_ms,
         "step_device_busy_ms": busy * cfg.n_layers,
         "layer_bound_ms": bound, "step_bound_ms": bound * cfg.n_layers,
         "share_of_bound": bound / busy if busy else None,
         "launches_per_layer": sum(e.count for e in kernels) / n}
    print(f"MoE MLP per decode step [{cfg.name}] [{card}]: " + json.dumps(m))
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]:
        print(f"  device ms/layer {e.self_device_time_total / n / 1e3:8.3f}"
              f"  launches/layer {e.count / n:6.1f}  {e.key[:90]}")
    return m


def moe_config_phase(card, cfg, params, dense_syncs):
    """Phase "moe config NAME": the Llama prompt set served twice (equal
    streams), an instance kill (streams equal failure-free), the decode
    profile; the synchronizing calls in one decode step, which must be as
    many as the dense Llama step's; the MoE MLP's device time. Returns
    (launches, prompts, their streams)."""
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab_size, n).tolist()
               for n in SERVE_PROMPT_LENS]
    prompts.append(list(prompts[1]))          # the same prompt twice
    check(block_bytes(cfg, False) == cfg.n_layers * 65_536, "block bytes")
    launches, _, profile, streams = run_path(
        card, cfg, EngineConfig(max_slots=8, max_seq=256), PA, PA8,
        cfg.name, prompts, params=params, repeat=True)
    syncs = profile["syncs_per_step"]
    print(f"[{cfg.name}] synchronizing calls in one decode step: {syncs} "
          f"(dense llama3-8b step: {dense_syncs})")
    check(syncs == dense_syncs, f"the MoE decode step makes {syncs} "
          f"synchronizing calls, the dense step {dense_syncs}")
    moe_mlp_profile(card, cfg, params)
    return launches, prompts, streams


def moe_invariants_phase(card, cfg, params, prompts, streams) -> dict:
    """Phase "moe invariants NAME", every stream bit for bit: chunked
    prefill (chunks of 64) against the monolithic streams of the config
    phase; the shared-prefix set (primer first) with the prefix cache
    against cold serving; the int8 pool with chunks of 64 through an
    instance kill against the same path without it, and that path's
    decode profile. Returns each kernel's launches."""
    label = f"moe invariants {cfg.name}"
    out = {"paged_attention": 0, "paged_attention_int8": 0}
    (got, _, _, _), n = counted(
        label, "chunked prefill", lambda: engine_run(
            cfg, params, EngineConfig(max_slots=8, max_seq=256,
                                      prefill_chunk=64), [prompts], 32),
        PA, PA8, cfg.n_layers)
    out["paged_attention"] += n
    check(got == streams, "chunked prefill (chunks of 64) streams differ "
          "from monolithic prefill")
    print(f"[{label}] chunked prefill (chunks of 64): all {len(got)} "
          "streams equal monolithic prefill")
    ps = shared_prefix_set(cfg)
    waves = [[ps.primer], ps.batch + [ps.xbucket] + ps.drill]
    runs = {}
    for cache in (False, True):
        (got, _, _, eng), n = counted(
            label, f"shared prefix (prefix_cache={cache})",
            lambda: engine_run(cfg, params,
                               prefix_ecfg(cfg, prefix_cache=cache), waves,
                               NEW_TOKENS), PA, PA8, cfg.n_layers)
        out["paged_attention"] += n
        runs[cache] = got, eng.prefix_stats()
        del eng
    stats = runs[True][1]
    check(runs[True][0] == runs[False][0], "prefix-cached streams differ "
          "from cold serving")
    check(stats["prefix_cached_tokens"] > 0, "no prefix-cache hit")
    print(f"[{label}] prefix cache: all {len(runs[True][0])} streams equal "
          f"cold; {stats['prefix_cached_tokens']} of "
          f"{stats['prefill_total_tokens']} prompt tokens from cached pages")
    ecfg = EngineConfig(max_slots=8, max_seq=256, kv_quant=True,
                        prefill_chunk=64)
    (want, _, _, eng), n = counted(
        label, "int8 + chunks", lambda: engine_run(cfg, params, ecfg,
                                                   [prompts], 32),
        PA8, PA, cfg.n_layers)
    out["paged_attention_int8"] += n
    phase(f"decode profile ({cfg.name}, int8)")
    decode_profile(eng, card, PA8)
    del eng
    (got, reqs, _, _), n = counted(
        label, "int8 + chunks, instance kill",
        lambda: engine_run(cfg, params, ecfg, [prompts], 32,
                           kill=busiest_decoding), PA8, PA, cfg.n_layers)
    out["paged_attention_int8"] += n
    migrations = [r.n_migrations for r in reqs]
    check(max(migrations) >= 1, "no request migrated")
    check(got == want, "int8 + chunked streams through a kill differ from "
          "the same path without it")
    print(f"[{label}] int8 pool, chunks of 64, instance kill: all "
          f"{len(got)} streams equal the failure-free run; migrations "
          f"{migrations}, retries {[r.n_retries for r in reqs]}")
    return out


def window_phase(card, cfg, params, label, prompt_len, n_new) -> int:
    """Phase "moe window NAME" / "hybrid window NAME": two prompts of
    ``prompt_len`` tokens, ``n_new`` greedy tokens each, so positions pass
    the config's window and pages recycle (the kernels' window starts run);
    then again with the instance decoding most killed just after the first
    page is retired. Every stream equals the failure-free run, retirements
    ran and no request held more than ceil(window/16) + 1 pages. Returns
    the bf16 kernel's launches."""
    n_attn = attn_layers(cfg)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(1, cfg.vocab_size, prompt_len).tolist()
               for _ in range(2)]
    ecfg = EngineConfig(max_slots=2, max_seq=prompt_len + n_new)
    ring = -(-cfg.sliding_window // cfg.page_size) + 1
    t0 = time.perf_counter()
    (want, _, peak, eng), n = counted(
        label, "failure-free", lambda: engine_run(cfg, params, ecfg,
                                                  [prompts], n_new),
        PA, PA8, n_attn)
    wall = time.perf_counter() - t0
    retired = eng.retire_msgs_total
    del eng
    check(all(len(t) == n_new for t in want), "stream length")
    check(0 < peak <= ring, f"a request held {peak} pages (ring {ring})")
    check(retired > 0, "no recycled page was retired")
    print(f"[{label}] failure-free [{card}]: {wall:.1f} s wall; most pages "
          f"held by one request {peak} (ring {ring}); retire messages "
          f"{retired}")
    slid = lambda e: busiest_decoding(e) if e.retire_msgs_total else None
    (got, reqs, peak, eng), n2 = counted(
        label, "instance kill after the slide",
        lambda: engine_run(cfg, params, ecfg, [prompts], n_new,
                           kill=slid), PA, PA8, n_attn)
    check(peak <= ring, f"a request held {peak} pages (ring {ring})")
    check(max(r.n_migrations for r in reqs) >= 1, "no request migrated")
    check(got == want, "streams through the kill differ from failure-free")
    print(f"[{label}] kill after the slide: both streams equal failure-free;"
          f" migrations {[r.n_migrations for r in reqs]}, retries "
          f"{[r.n_retries for r in reqs]}; retire messages "
          f"{eng.retire_msgs_total}")
    return n + n2


def moe_phases(card, dense_syncs, configs=MOE_CONFIGS) -> dict:
    """mixtral-8x7b (config, invariants, window) and dbrx-132b (config)
    at full width, cut in depth, each on fresh random weights
    (torch.Generator seed 0) and freed before the next. Returns each
    attention kernel's launches."""
    out = {"paged_attention": 0, "paged_attention_int8": 0}
    for name, depth, invariants in configs:
        full = get_config(name)
        cfg = dataclasses.replace(full, n_layers=depth)
        phase(f"moe config {name}")
        before = torch.cuda.memory_allocated() / 2**30
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params = api.init_params(
            cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda")
        torch.cuda.synchronize()
        print(f"model {name}: {depth} of {full.n_layers} layers (depth cut: "
              f"{MOE_DEPTH_CUTS[name]}), d_model {cfg.d_model}, heads "
              f"{cfg.n_heads}/{cfg.n_kv_heads} (rep {cfg.q_per_kv}), "
              f"d_ff {cfg.d_ff}, {cfg.n_experts} experts top-{cfg.top_k}, "
              f"window {cfg.sliding_window}, vocab {cfg.vocab_size}, "
              f"{cfg.n_params() / 1e9:.2f} B params "
              f"({2 * cfg.n_params() / 1e9:.1f} GB bf16), "
              f"{cfg.n_active_params() / 1e9:.2f} B active; random weights "
              f"made in {time.perf_counter() - t0:.1f} s ({before:.1f} GiB "
              "allocated before)")
        n, prompts, streams = moe_config_phase(card, cfg, params,
                                               dense_syncs)
        out["paged_attention"] += n
        if invariants:
            phase(f"moe invariants {name}")
            for kernel, k in moe_invariants_phase(card, cfg, params, prompts,
                                                  streams).items():
                out[kernel] += k
        if cfg.sliding_window:
            label = f"moe window {name}"
            phase(label)
            out["paged_attention"] += window_phase(
                card, cfg, params, label, WINDOW_PROMPT, WINDOW_NEW)
        card_gib = torch.cuda.get_device_properties(0).total_memory / 2**30
        print(f"[{name}] {depth} layers: peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
              f"allocated, {torch.cuda.max_memory_reserved() / 2**30:.2f} "
              f"GiB reserved, of the card's {card_gib:.2f} GiB [{card}]")
        del params
        gc.collect()
        torch.cuda.empty_cache()
    return out


def serving_phases(card: str) -> dict:
    """The bf16 path, the int8 + chunked-prefill path, the prefix-cache and
    disaggregated paths, the 8-instance fleet, decoupled init and the
    open-loop failure drill, all on the same Llama-3.1-8B weights; then the other dense configs, the MoE configs and
    the hybrid config. Returns each kernel's launches on its paths."""
    cfg = get_config("llama3-8b")
    print(f"model {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"vocab {cfg.vocab_size}, {cfg.n_params() / 1e9:.2f} B params, "
          f"{cfg.dtype}, random weights (torch.Generator seed 0)")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab_size, n).tolist()
               for n in SERVE_PROMPT_LENS]
    prompts.append(list(prompts[1]))          # the same prompt twice
    bf16, params, profile, _ = run_path(
        card, cfg, EngineConfig(max_slots=8, max_seq=256), PA, PA8, "bf16",
        prompts)
    # same weights, int8 pool, chunks of 64: the 200-token prompt runs 4
    int8 = run_path(
        card, cfg, EngineConfig(max_slots=8, max_seq=256, kv_quant=True,
                                prefill_chunk=64),
        PA8, PA, "int8 + chunked prefill", prompts, params=params)[0]
    bf16 += shared_prefix_phases(card, cfg, params)
    fleet, cold_s = fleet_phases(card, cfg, params)
    bf16 += fleet
    phase("decoupled init")
    bf16 += decoupled_init_phase(card, cfg, params, cold_s)
    phase("open-loop failure drill")
    bf16 += open_loop_drill_phase(card, cfg, params)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    launches = dense_config_phases(card)
    for name, n in moe_phases(card, profile["syncs_per_step"]).items():
        launches[name] += n
    for name, n in hybrid_phases(card, profile["syncs_per_step"]).items():
        launches[name] += n
    return {"paged_attention": bf16 + launches["paged_attention"],
            "paged_attention_int8": int8 + launches["paged_attention_int8"]}


# -- 25.-27. hybrid config ----------------------------------------------------

HYBRID_CONFIG = "recurrentgemma-9b"
# the hybrid window phase: prompts of 2030 tokens (bucket 2048) and 48 new
# tokens, so positions pass the 2048-token window and the first page is
# retired at position 2063, 14 tokens before the end
HYBRID_WINDOW_PROMPT, HYBRID_WINDOW_NEW = 2030, 48


def tree_bytes(tree) -> int:
    """Bytes of every tensor in a nested dict / list of tensors."""
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def hybrid_step_bytes(cfg, params) -> int:
    """Weight bytes one hybrid decode step must read: every layer's tensors
    with the RG-LRU gate matrices as the f32 copies the step reads (not
    their bf16 originals), the final norm and the unembedding (of the token
    embedding only B rows, left out)."""
    total = 0
    for p, kind in zip(params["layers"], cfg.layer_kinds()):
        total += tree_bytes(p)
        if kind == "rglru":
            total += sum(p[k].numel() * (4 - p[k].element_size())
                         for k in ("wa", "wx_gate"))
    emb = params["embed"]
    return total + tree_bytes(emb["norm_f"]) + tree_bytes(emb["unembed"])


def events_ms(fn, n=10) -> float:
    """Elapsed device time per call of ``fn`` by CUDA events over ``n``
    calls, after two warm-up calls."""
    for _ in range(2):
        fn()
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(n):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / n


def device_profile(fn, n=3) -> tuple:
    """(device-busy ms, CUDA kernels) per call of ``fn`` under
    torch.profiler: the kernels' own device time summed, gaps left out."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    return (sum(e.self_device_time_total for e in kernels) / n / 1e3,
            sum(e.count for e in kernels) / n)


def hybrid_profile(card, cfg, params, gates, decode) -> dict:
    """The hybrid's own costs: one RG-LRU layer's decode block at B 8
    (device-busy time and kernels; times the 26 layers, its share of the
    decode step's device-busy time), the step's weight-read bound, and the
    sequential RG-LRU scan of prefill (one layer, one prompt of 256 and of
    2048 positions): elapsed device time (CUDA events: the launches of one
    addcmul per position leave the card waiting), device-busy time and
    kernel launches."""
    p, g = params["layers"][0], gates[0]
    n_rg = len(hybrid.recurrent_layer_indices(cfg))
    gen = torch.Generator(device="cuda").manual_seed(7)
    x = torch.randn((8, 1, cfg.d_model), generator=gen,
                    device="cuda").to(torch.bfloat16)
    state = {"h": torch.zeros((8, cfg.lru_width), device="cuda"),
             "conv": torch.zeros((8, hybrid.CONV_WIDTH - 1, cfg.lru_width),
                                 dtype=torch.bfloat16, device="cuda")}
    busy, launches = device_profile(
        lambda: hybrid._recurrent_block(cfg, p, x, state, g))
    nbytes = hybrid_step_bytes(cfg, params)
    step_busy = decode["device_busy_ms"]
    m = {"rglru_layer_device_busy_ms": busy,
         "rglru_layers_device_busy_ms": busy * n_rg,
         "rglru_share_of_step_device_busy":
             busy * n_rg / step_busy if step_busy else None,
         "rglru_layer_launches": launches,
         "step_weight_bytes": nbytes,
         "step_weight_read_bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
         "decode_step_wall_ms": decode["decode_step_wall_ms"],
         "step_device_busy_ms": step_busy}
    for s in (256, 2048):
        conv_out = torch.randn((1, s, cfg.lru_width), generator=gen,
                               device="cuda").to(torch.bfloat16)
        scan = lambda: hybrid.rglru_scan(p, conv_out, g=g,  # noqa: E731
                                         rows=PD.PREFILL_ROWS)
        m[f"scan_{s}_layer_elapsed_ms"] = events_ms(scan, n=3)
        (m[f"scan_{s}_layer_device_busy_ms"],
         m[f"scan_{s}_layer_launches"]) = device_profile(scan, n=1)
        m[f"scan_{s}_prefill_elapsed_ms"] = \
            m[f"scan_{s}_layer_elapsed_ms"] * n_rg
    print(f"hybrid profile [{cfg.name}] [{card}]: " + json.dumps(m))
    return m


def chunked_blob_difference(cfg, params, gates, prompt) -> float:
    """Largest |difference| between the state blob of a monolithic prefill
    of ``prompt`` and of chunks of 64 over the same bucket."""
    n = len(prompt)
    bucket = PD.next_bucket(n, lo=cfg.page_size)
    toks = torch.zeros((1, bucket), dtype=torch.int32, device="cuda")
    toks[0, :n] = torch.tensor(prompt, dtype=torch.int32)
    whole = PD.prefill_hybrid_bucketed(cfg, params, toks, n, gates=gates)[3]
    kb, vb = PD.init_chunk_buffers(cfg, bucket, device="cuda")
    st = PD.init_hybrid_chunk_state(cfg, device="cuda")
    c = min(64, bucket)
    for c0 in range(0, n, c):
        *_, st, blob = PD.prefill_hybrid_chunk(
            cfg, params, toks[:, c0:c0 + c], c0, min(c, n - c0), kb, vb, st,
            gates=gates)
    return float((blob - whole).abs().max())


def repl_bytes_ok(eng, cfg, quantized: bool, kind: str = "repl") -> bool:
    """The transport's shipped bytes of ``kind`` equal its blocks and blobs
    times the config's block and blob bytes."""
    t = eng.transport.shipped[kind]
    return t.bytes == t.blocks * block_bytes(cfg, quantized) \
        + t.blobs * blob_bytes(cfg, quantized)


def hybrid_invariants_phase(card, cfg, params, prompts, streams) -> dict:
    """Phase "hybrid invariants NAME", engines stepped by hand, every
    stream bit for bit: chunked prefill (chunks of 64) against the
    monolithic streams of the config phase, and the largest blob
    difference of the two prefills; the int8 pool with chunks of 64
    through an instance kill against the same path without it; the
    shared-prefix set with the prefix cache against cold serving (a hit
    shares pages but recomputes the prompt: the RG-LRU state spans the
    prefix); disaggregated against colocated, each handoff carrying its
    blob. Returns each kernel's launches."""
    label = f"hybrid invariants {cfg.name}"
    n_attn = attn_layers(cfg)
    out = {"paged_attention": 0, "paged_attention_int8": 0}
    (got, _, _, _), n = counted(
        label, "chunked prefill", lambda: engine_run(
            cfg, params, EngineConfig(max_slots=8, max_seq=256,
                                      prefill_chunk=64), [prompts], 32),
        PA, PA8, n_attn)
    out["paged_attention"] += n
    check(got == streams, "chunked prefill (chunks of 64) streams differ "
          "from monolithic prefill")
    gates = hybrid.gate_tables(cfg, params)
    diff = chunked_blob_difference(cfg, params, gates, prompts[4])
    del gates
    print(f"[{label}] chunked prefill (chunks of 64): all {len(got)} "
          f"streams equal monolithic prefill; largest state-blob difference "
          f"(200-token prompt, 4 chunks): {diff:.3e}")
    check(diff == 0.0, "chunked and monolithic prefill state blobs differ")
    ecfg = EngineConfig(max_slots=8, max_seq=256, kv_quant=True,
                        prefill_chunk=64)
    (want, _, _, eng), n = counted(
        label, "int8 + chunks", lambda: engine_run(cfg, params, ecfg,
                                                   [prompts], 32),
        PA8, PA, n_attn)
    out["paged_attention_int8"] += n
    del eng
    (got, reqs, _, eng), n = counted(
        label, "int8 + chunks, instance kill",
        lambda: engine_run(cfg, params, ecfg, [prompts], 32,
                           kill=busiest_decoding), PA8, PA, n_attn)
    out["paged_attention_int8"] += n
    migrations = [r.n_migrations for r in reqs]
    check(max(migrations) >= 1, "no request migrated")
    check(got == want, "int8 + chunked streams through a kill differ from "
          "the same path without it")
    t = eng.transport.shipped["repl"]
    check(t.blobs > 0 and repl_bytes_ok(eng, cfg, True),
          f"int8 replication bytes {t.bytes} != {t.blocks} x "
          f"{block_bytes(cfg, True)} + {t.blobs} x {blob_bytes(cfg, True)}")
    print(f"[{label}] int8 pool, chunks of 64, instance kill: all "
          f"{len(got)} streams equal the failure-free run; migrations "
          f"{migrations}, retries {[r.n_retries for r in reqs]}; "
          f"{t.blocks} blocks of {block_bytes(cfg, True)} B and {t.blobs} "
          f"blobs of {blob_bytes(cfg, True)} B replicated")
    del eng
    ps = shared_prefix_set(cfg)
    waves = [[ps.primer], ps.batch + [ps.xbucket] + ps.drill]
    runs = {}
    for name, kw in (("cold", {}), ("prefix cache", {"prefix_cache": True}),
                     ("disaggregated", {"disaggregate": True})):
        (got, _, _, eng), n = counted(
            label, f"shared prefix ({name})",
            lambda: engine_run(cfg, params, prefix_ecfg(cfg, **kw), waves,
                               NEW_TOKENS), PA, PA8, n_attn)
        out["paged_attention"] += n
        runs[name] = got, eng.prefix_stats(), eng.disagg_stats(), \
            repl_bytes_ok(eng, cfg, False, "handoff")
        del eng
    stats = runs["prefix cache"][1]
    check(runs["prefix cache"][0] == runs["cold"][0],
          "prefix-cached streams differ from cold serving")
    check(stats["prefix_cached_tokens"] > 0, "no prefix-cache hit")
    check(stats["prefill_compute_tokens"] == stats["prefill_total_tokens"],
          "a hybrid prefix hit skipped prompt compute")
    print(f"[{label}] prefix cache: all {len(runs['cold'][0])} streams "
          f"equal cold; {stats['prefix_cached_tokens']} of "
          f"{stats['prefill_total_tokens']} prompt tokens on shared pages, "
          f"all {stats['prefill_compute_tokens']} recomputed")
    dis = runs["disaggregated"][2]
    check(runs["disaggregated"][0] == runs["cold"][0],
          "disaggregated streams differ from colocated serving")
    check(dis["handoffs_seated"] > 0
          and dis["handoff_blobs_total"] == dis["handoffs_seated"]
          and runs["disaggregated"][3],
          f"handoffs {dis['handoffs_seated']} carried "
          f"{dis['handoff_blobs_total']} blobs")
    print(f"[{label}] disaggregated: all {len(runs['cold'][0])} streams "
          f"equal colocated; {dis['handoffs_seated']} handoffs, "
          f"{dis['handoff_blocks_total']} blocks and "
          f"{dis['handoff_blobs_total']} blobs, {dis['handoff_bytes_total']}"
          " B")
    return out


def hybrid_phases(card, dense_syncs) -> dict:
    """recurrentgemma-9b at full width and full depth (all 38 layers) on
    fresh random weights (torch.Generator seed 0): the config phase over
    HTTP, the invariants, the window. Returns each attention kernel's
    launches."""
    cfg = get_config(HYBRID_CONFIG)
    phase(f"hybrid config {cfg.name}")
    before = torch.cuda.memory_allocated() / 2**30
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = api.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    torch.cuda.synchronize()
    nbytes = tree_bytes(params)
    kinds = cfg.layer_kinds()
    print(f"model {cfg.name}: all {cfg.n_layers} layers "
          f"({kinds.count('rglru')} RG-LRU, {kinds.count('attn')} local "
          f"attention), d_model {cfg.d_model}, lru_width {cfg.lru_width}, "
          f"heads {cfg.n_heads}/{cfg.n_kv_heads} (rep {cfg.q_per_kv}), "
          f"head_dim {cfg.head_dim}, d_ff {cfg.d_ff}, window "
          f"{cfg.sliding_window}, vocab {cfg.vocab_size}; {nbytes / 1e9:.2f}"
          f" GB of params counted from the tensors (ModelConfig.n_params() "
          f"says {cfg.n_params() / 1e9:.2f} B params: its RG-LRU term "
          "leaves out the MLP and the gate matrices); random weights made "
          f"in {time.perf_counter() - t0:.1f} s ({before:.1f} GiB allocated "
          "before)")
    check((block_bytes(cfg, False), blob_bytes(cfg, False),
           block_bytes(cfg, True), blob_bytes(cfg, True))
          == (196_608, 1_703_936, 99_072, 425_986), "block / blob bytes")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab_size, n).tolist()
               for n in SERVE_PROMPT_LENS]
    prompts.append(list(prompts[1]))          # the same prompt twice
    out = {"paged_attention": 0, "paged_attention_int8": 0}
    n, _, profile, streams = run_path(
        card, cfg, EngineConfig(max_slots=8, max_seq=256), PA, PA8,
        cfg.name, prompts, params=params, repeat=True)
    out["paged_attention"] += n
    print(f"[{cfg.name}] synchronizing calls in one decode step: "
          f"{profile['syncs_per_step']} (dense llama3-8b step: "
          f"{dense_syncs})")
    gates = hybrid.gate_tables(cfg, params)
    hybrid_profile(card, cfg, params, gates, profile)
    del gates
    phase(f"hybrid invariants {cfg.name}")
    for kernel, k in hybrid_invariants_phase(card, cfg, params, prompts,
                                             streams).items():
        out[kernel] += k
    label = f"hybrid window {cfg.name}"
    phase(label)
    out["paged_attention"] += window_phase(
        card, cfg, params, label, HYBRID_WINDOW_PROMPT, HYBRID_WINDOW_NEW)
    card_gib = torch.cuda.get_device_properties(0).total_memory / 2**30
    print(f"[{cfg.name}] {cfg.n_layers} layers: peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB allocated, "
          f"{torch.cuda.max_memory_reserved() / 2**30:.2f} GiB reserved, "
          f"of the card's {card_gib:.2f} GiB [{card}]")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return out


# -- 28. mamba2 generation ----------------------------------------------------

@contextlib.contextmanager
def plain_scan_calls():
    """Counts calls of the scan's plain versions while the block runs:
    ``ssd_scan_ref`` (where ``ops.ssd_scan`` would send a CPU tensor) and
    ``ssm.ssd_chunked_plain`` (``ssd_chunked``'s CPU path)."""
    calls = [0]
    orig = REF.ssd_scan_ref, ssm.ssd_chunked_plain

    def counted(fn):
        def call(*args, **kw):
            calls[0] += 1
            return fn(*args, **kw)
        return call

    REF.ssd_scan_ref, ssm.ssd_chunked_plain = map(counted, orig)
    try:
        yield calls
    finally:
        REF.ssd_scan_ref, ssm.ssd_chunked_plain = orig


@contextlib.contextmanager
def scan_through_plain_form():
    """The model's scan runs the plain chunked form (for comparison only)."""
    orig = ssm.ssd_chunked
    ssm.ssd_chunked = ssm.ssd_chunked_plain
    try:
        yield
    finally:
        ssm.ssd_chunked = orig


def generate(cfg, params, tokens, n_new):
    """Greedy decoding through the model API: api.prefill, then n_new - 1
    api.decode_step calls. Returns (tokens (b, n_new) on the host, the
    prefill's logits, prefill wall s, decode wall s per step)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache, pos = api.prefill(cfg, params, {"tokens": tokens})
    first = logits
    tok = logits.argmax(-1).to(torch.int32)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    out = [tok]
    for i in range(n_new - 1):
        logits, cache = api.decode_step(cfg, params, tok, cache, pos + i,
                                        seq_len=pos + n_new)
        tok = logits.argmax(-1).to(torch.int32)
        out.append(tok)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    return torch.stack(out, 1).cpu(), first, t1 - t0, (t2 - t1) / (n_new - 1)


def profile_device(fn, n):
    """``fn`` run ``n`` times on the card: wall ms per call (synchronised
    host clock), then under torch.profiler the device-side entries only (an
    aten op's self device time repeats the time of the kernels it launched,
    which are listed as entries too). Returns (wall ms, busy ms, kernel
    launches per call, the entries)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / n * 1e3
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / n / 1e3
    return wall, busy, sum(e.count for e in kernels) / n, kernels


def mamba2_profile(card, what, fn, n):
    wall, busy, launches, kernels = profile_device(fn, n)
    scan = sum(e.self_device_time_total for e in kernels
               if "ssd_scan" in e.key) / n / 1e3
    m = {"wall_ms": wall, "device_busy_ms": busy, "ssd_scan_kernel_ms": scan,
         "ssd_scan_share_of_busy": scan / busy if busy else None,
         "kernel_launches": launches,
         "device_idle_share": 1 - busy / wall if busy else None}
    print(f"mamba2 {what} profile [{card}]: " + json.dumps(m))
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]:
        print(f"  device ms/call {e.self_device_time_total / n / 1e3:8.3f}"
              f"  launches/call {e.count / n:7.1f}  {e.key[:90]}")
    if not busy:
        print(f"mamba2 {what} profile: the profiler saw no device time "
              "(device busy not measured)")


def mamba2_phase(card: str) -> int:
    """Full-width mamba2-130m through the model API. Returns the scan
    kernel's launches on the counted generation runs."""
    cfg = get_config("mamba2-130m")
    t0 = time.perf_counter()
    params = api.init_params(cfg, torch.Generator(device="cuda")
                             .manual_seed(0), device="cuda")
    torch.cuda.synchronize()
    print(f"model {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.ssm_n_heads} SSD heads x {cfg.ssm_head_dim}, state "
          f"{cfg.ssm_state}, chunk {cfg.ssm_chunk}, vocab {cfg.vocab_size}, "
          f"{cfg.n_params() / 1e6:.1f} M params, {cfg.dtype}, random weights "
          f"(torch.Generator seed 0), made in "
          f"{time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(1)
    batches = {s: torch.as_tensor(
        rng.integers(1, cfg.vocab_size, (MAMBA_BATCH, s)), dtype=torch.int32,
        device="cuda") for s in MAMBA_PROMPTS}
    generate(cfg, params, batches[MAMBA_PROMPTS[-1]], 3)   # warm-up
    launches = 0
    for s, toks in batches.items():
        runs = []
        for _ in range(2):
            SSD.launches = PA.launches = PA8.launches = 0
            with plain_scan_calls() as plain:
                out = generate(cfg, params, toks, MAMBA_NEW)
            n = SSD.launches
            print(f"[mamba2 {s}] ssd_scan launches: {n} (one prefill); plain "
                  f"scans: {plain[0]}; paged attention: "
                  f"{PA.launches + PA8.launches}")
            check(n == SSD.KERNELS_PER_CALL * cfg.n_layers,
                  f"{n} ssd_scan launches, not {SSD.KERNELS_PER_CALL} per "
                  f"layer ({cfg.n_layers} layers)")
            check(plain[0] == 0, "a plain scan ran on the card's path")
            launches += n
            runs.append(out)
        (streams, logits, t_pre, t_dec), (streams2, _, t_pre2, t_dec2) = runs
        check(tuple(streams.shape) == (MAMBA_BATCH, MAMBA_NEW)
              and int(streams.min()) >= 0
              and int(streams.max()) < cfg.vocab_size,
              "stream shape / token range")
        check(bool(torch.isfinite(logits).all()), "prefill logits not finite")
        check(torch.equal(streams, streams2),
              "greedy determinism: two runs gave different tokens")
        m = {"prompt_tokens": s, "batch": MAMBA_BATCH,
             "prefill_wall_s": [t_pre, t_pre2],
             "per_token_decode_s": [t_dec, t_dec2],
             "tokens_per_s": [MAMBA_BATCH * MAMBA_NEW
                              / (tp + (MAMBA_NEW - 1) * td)
                              for tp, td in ((t_pre, t_dec),
                                             (t_pre2, t_dec2))],
             "distinct_tokens": len(set(streams.flatten().tolist()))}
        print(f"mamba2 generation [{card}]: " + json.dumps(m))
    print("mamba2: greedy streams identical across two runs per batch")

    # f32: the kernel's prefill against the plain chunked form, and forward
    # at t against prefill(:t) plus one decode step
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    p32 = {k: {kk: vv.float() for kk, vv in v.items()}
           for k, v in params.items()}
    for s, toks in batches.items():
        SSD.launches = 0
        kl, kc, _ = api.prefill(cfg32, p32, {"tokens": toks})
        for chunk, tol in MAMBA_PREFILL_TOL.items():
            with scan_through_plain_form():
                pl, pc, _ = api.prefill(
                    dataclasses.replace(cfg32, ssm_chunk=chunk), p32,
                    {"tokens": toks})
            torch.cuda.synchronize()
            err = float((kl - pl).abs().max())
            err_state = float((kc["ssm"] - pc["ssm"]).abs().max())
            print(f"[mamba2 {s}] f32 prefill, kernel vs plain chunked form "
                  f"at chunk {chunk}: logits max_abs_err {err:.3e} (limit "
                  f"{tol:g}, |logits| <= {float(pl.abs().max()):.3f}); "
                  f"ssm state {err_state:.3e} (|state| <= "
                  f"{float(pc['ssm'].abs().max()):.2f})")
            check(math.isfinite(err) and err <= tol,
                  "kernel prefill differs from the plain chunked form")
        check(SSD.launches == SSD.KERNELS_PER_CALL * cfg.n_layers,
              "f32 prefill launch count")
        t = s - 1
        full = api.forward(cfg32, p32, toks)[:, t]
        for conv_dtype, tol in MAMBA_SPLIT_TOL.items():
            ssm.CONV_STATE_DTYPE = conv_dtype
            try:
                _, cache, pos = api.prefill(cfg32, p32,
                                            {"tokens": toks[:, :t]})
                dl, _ = api.decode_step(cfg32, p32, toks[:, t], cache, pos,
                                        seq_len=s)
            finally:
                ssm.CONV_STATE_DTYPE = torch.bfloat16
            err = float((dl - full).abs().max())
            print(f"[mamba2 {s}] f32 forward at t={t} vs prefill(:{t}) + "
                  f"one decode step, conv state {conv_dtype}: max_abs_err "
                  f"{err:.3e} (limit {tol:g}, |logits| <= "
                  f"{float(full.abs().max()):.3f})")
            check(math.isfinite(err) and err <= tol,
                  "prefill + decode step differs from forward")
    del p32

    phase("mamba2 profile")
    toks = batches[MAMBA_PROMPTS[0]]
    _, cache, pos = api.prefill(cfg, params, {"tokens": toks})
    tok = toks[:, -1]
    mamba2_profile(card, f"prefill ({MAMBA_BATCH} x {MAMBA_PROMPTS[0]})",
                   lambda: api.prefill(cfg, params, {"tokens": toks}), 3)
    mamba2_profile(card, f"decode step (batch {MAMBA_BATCH})",
                   lambda: api.decode_step(cfg, params, tok, cache, pos,
                                           seq_len=pos + 1), 10)
    return launches


def build_all():
    """The three kernel libraries from source, one nvcc process per source,
    all started together."""
    t0 = time.perf_counter()
    mods = (PA, PA8, SSD)
    with concurrent.futures.ThreadPoolExecutor(len(mods)) as pool:
        libs = list(pool.map(lambda m: m.build(), mods))   # re-raises
    for m, lib in zip(mods, libs):
        secs = m.build_seconds
        print(f"built {os.path.relpath(lib, ROOT)} in "
              f"{secs:.1f} s" if secs is not None else
              f"{os.path.relpath(lib, ROOT)} already built")
    print(f"build phase: {time.perf_counter() - t0:.1f} s wall")


def drill_only(card: str) -> int:
    """``--drill-only``: phase 20 alone, on fresh Llama-3.1-8B weights made
    as the full run makes them (seed 0), so that its numbers and its
    run-start state stand beside those of the full run, which reaches the
    drill late. Builds the one kernel the drill runs; prints no summary."""
    phase("build")
    PA.build()
    print(f"built the bf16 paged_attention kernel in {PA.build_seconds} s")
    cfg = get_config("llama3-8b")
    params = api.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    phase("open-loop failure drill")
    n = open_loop_drill_phase(card, cfg, params)
    print(f"open-loop drill alone [{card}]: {n} paged_attention launches")
    return 0


def main() -> int:
    phase("device")
    card = device_line()
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if sys.argv[1:] == ["--drill-only"]:
        return drill_only(card)
    check(not sys.argv[1:], f"unknown arguments {sys.argv[1:]}")

    phase("build")
    ptxas = start_ptxas_report()
    try:
        build_all()

        phase("kernel")
        entries = [kernel_phase()]
        phase("kernel (int8)")
        entries.append(kernel_int8_phase())
        phase("kernel (head geometries)")
        geometry = geometry_phase(card)
        print_d256_resources(ptxas, card)
    finally:
        if ptxas.poll() is None:
            ptxas.kill()
            ptxas.wait()
    phase("kernel (ssd_scan)")
    entries.append(ssd_scan_phase())

    launches = serving_phases(card)
    phase("mamba2 generation")
    launches["ssd_scan"] = mamba2_phase(card)
    for e in entries:
        e["launches"] = launches[e["name"]]

    phase("summary")
    print(f"head geometries [{card}]: " + json.dumps(geometry))
    print(json.dumps({"kernels": entries}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
