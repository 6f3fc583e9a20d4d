#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

  python3 chip_smoke.py

Phases (each raises, and the script exits non-zero, if its check fails):

  1. device   — a CUDA card is required; prints its name and power limit;
                TF32 off for matmuls and convolutions.
  2. build    — compiles both kernel libraries (paged attention, bf16 and
                int8 pools) from src/repro_torch/kernels/csrc/ with nvcc
                (sm_90a), one nvcc process per source, started together.
  3. kernel   — holds the bf16 paged-attention kernel against its plain
                PyTorch version at the serving shape (B=8, H=32, K=8, D=128,
                page 16, 16 pages, bf16, ragged lengths, with and without
                window starts, fully masked pages), in f32, and at the
                reduced test shape (page 8, D 64); times kernel and plain
                version with CUDA events.
  4. kernel (int8) — the same for the int8 kernel over quantized pages
                (q in bf16 and f32, both shapes, one all-zero row with
                scale 1), and quantize_pages on the card against the CPU,
                bit for bit.
  5. serving  — the port's HTTP server with full-width Llama-3.1-8B (random
                weights from a seeded torch.Generator), 2 instances, ring
                replication on; concurrent completions, greedy determinism,
                TTFT / per-token latency / tokens per second.
  6. failover — the same prompts again; an instance kill through
                /v1/admin/fault while they decode; every stream must equal
                the failure-free one, with at least one migration.
  7. decode profile — one instance's decode step called directly: wall
                time, device-busy time and op count (torch.profiler).
  8.-10. serving, failover and decode profile again on a second service
                built from the SAME weights with the int8 KV pool and
                chunked prefill (chunks of 64); the kill may restart only
                requests caught mid-prefill on the victim.
  11. summary — one JSON line of kernels, the card line, and the final
                {"ok": true, "device": ...} line.

Each path's kernel launch counts are set to 0 just before the path and read
just after; launches made to compare a kernel with its plain version are
not counted.
"""
from __future__ import annotations

import concurrent.futures
import json
import math
import os
import statistics
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import paged_attention as PA  # noqa: E402
from repro_torch.kernels import paged_attention_int8 as PA8  # noqa: E402
from repro_torch.kernels.ref import (paged_attention_int8_ref,  # noqa: E402
                                     paged_attention_ref)
from repro_torch.serving.engine import EngineConfig  # noqa: E402
from repro_torch.serving.server import serve  # noqa: E402

HBM_BYTES_PER_S = 3.35e12                     # H100 SXM, NVIDIA data sheet
PEAK_FLOPS = {torch.bfloat16: 989e12,         # dense tensor-core bf16
              torch.float32: 67e12}           # f32 outside the tensor cores
TOL = {torch.bfloat16: 3e-2, torch.float32: 1e-5}
LAYERS_PER_STEP = 32                          # one launch per layer per step
SERVE_PROMPT_LENS = [16, 48, 96, 150, 200]


def kname(mod) -> str:
    """A kernel wrapper module's short name ("paged_attention_int8")."""
    return mod.__name__.rsplit(".", 1)[-1]


def check(ok: bool, msg: str):
    if not ok:
        raise RuntimeError(f"check failed: {msg}")


def phase(name: str):
    print(f"== {name}", flush=True)


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


def kernel_phase() -> dict:
    serve_shape = (8, 32, 8, 128, 16, 16, 257)    # B,H,K,D,page,pps,P
    cases = [(serve_shape, torch.bfloat16), (serve_shape, torch.float32),
             ((4, 4, 2, 64, 8, 32, 129), torch.float32),
             ((4, 4, 2, 64, 8, 32, 129), torch.bfloat16)]
    max_err = 0.0
    for i, (shape, dtype) in enumerate(cases):
        q, kp, vp, bt, ln, st = kernel_case(*shape, dtype=dtype, seed=i)
        for starts in (None, st):
            got = PA.paged_attention(q, kp, vp, bt, ln, starts)
            torch.cuda.synchronize()
            want = paged_attention_ref(q, kp, vp, bt, ln, starts)
            err = float((got.float() - want.float()).abs().max())
            print(f"kernel check {shape} {dtype} starts={starts is not None}"
                  f": max_abs_err {err:.3e} (limit {TOL[dtype]:.0e})")
            check(math.isfinite(err) and err <= TOL[dtype],
                  f"kernel disagrees with plain version: {err}")
            max_err = max(max_err, err)
    # timing at the serving shape, every sequence at full length (256)
    n_sets = 5                                      # 5 x 16.8 MB > L2
    sets = [kernel_case(*serve_shape, dtype=torch.bfloat16, seed=100 + j,
                        full=True)[:5] for j in range(n_sets)]
    ms = graph_ms(PA.paged_attention, sets)
    plain_ms = graph_ms(paged_attention_ref, sets, reps=20)
    eager_ms = time_ms(PA.paged_attention, sets)
    eager_plain_ms = time_ms(paged_attention_ref, sets, reps=20, warmup=1)
    q, kp, _, _, ln = sets[0]
    bms, by = bound_ms(q, kp, ln, None)
    print(f"kernel at serving shape, device time (CUDA graph): "
          f"{ms * 1e3:.2f} us; plain {plain_ms * 1e3:.2f} us; bound "
          f"{bms * 1e3:.2f} us ({by})")
    print(f"kernel at serving shape, eager call incl. host dispatch: "
          f"{eager_ms * 1e3:.2f} us; plain {eager_plain_ms * 1e3:.2f} us")
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


def kernel_int8_phase() -> dict:
    serve_shape = (8, 32, 8, 128, 16, 16, 257)    # B,H,K,D,page,pps,P
    reduced = (4, 4, 2, 64, 8, 32, 129)
    cases = [(serve_shape, torch.bfloat16), (serve_shape, torch.float32),
             (reduced, torch.float32), (reduced, torch.bfloat16)]
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
            got = PA8.paged_attention_int8(q, kq, ks, vq, vs, bt, ln, starts)
            torch.cuda.synchronize()
            want = paged_attention_int8_ref(q, kq, ks, vq, vs, bt, ln, starts)
            err = float((got.float() - want.float()).abs().max())
            print(f"int8 kernel check {shape} q {dtype} "
                  f"starts={starts is not None}: max_abs_err {err:.3e} "
                  f"(limit {TOL[dtype]:.0e})")
            check(math.isfinite(err) and err <= TOL[dtype],
                  f"int8 kernel disagrees with plain version: {err}")
            max_err = max(max_err, err)
    # timing at the serving shape, every sequence at full length (256);
    # 12 x 4.4 MB of live K/V and scales > the 50 MB L2
    sets = [int8_case(serve_shape, torch.bfloat16, seed=100 + j,
                      full=True)[0][:7] for j in range(12)]
    ms = graph_ms(PA8.paged_attention_int8, sets)
    plain_ms = graph_ms(paged_attention_int8_ref, sets, reps=20)
    eager_ms = time_ms(PA8.paged_attention_int8, sets)
    eager_plain_ms = time_ms(paged_attention_int8_ref, sets, reps=20,
                             warmup=1)
    q, kq, ks, _, _, _, ln = sets[0]
    bms, by = bound_ms(q, kq, ln, None, scales=ks)
    print(f"int8 kernel at serving shape, device time (CUDA graph): "
          f"{ms * 1e3:.2f} us; plain {plain_ms * 1e3:.2f} us; bound "
          f"{bms * 1e3:.2f} us ({by})")
    print(f"int8 kernel at serving shape, eager call incl. host dispatch: "
          f"{eager_ms * 1e3:.2f} us; plain {eager_plain_ms * 1e3:.2f} us")
    return {"name": "paged_attention_int8", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/paged_attention_int8.cu",
            "replaces": "src/repro/kernels/paged_attention_int8.py:30",
            "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bms, "bound_by": by, "library_ms": None}


# -- 5.-10. serving, failover and decode profile, per pool ---------------------

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

    def step():
        inst._decode(engine.params, tok, pool.k, pool.v, pool.k_scale,
                     pool.v_scale, bt, pos, base, inst._generator)

    for _ in range(2):
        step()
    torch.cuda.synchronize()
    n = 5
    kernel.launches = 0
    t0 = time.perf_counter()
    for _ in range(n):
        step()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / n
    check(kernel.launches == n * LAYERS_PER_STEP,
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
    attn = sum(e.self_device_time_total for e in kernels
               if name in e.key) / n / 1e3
    ops = sum(e.count for e in events if e.key.startswith("aten::")) / n
    m = {"pool": str(pool.k.dtype).replace("torch.", ""),
         "decode_step_wall_ms": wall * 1e3, "device_busy_ms": busy,
         f"{name}_ms": attn,
         f"{name}_launches_per_step": per_step,
         "aten_ops_per_step": ops,
         "kernel_launches_per_step": sum(e.count for e in kernels) / n,
         "device_idle_share": 1 - busy / (wall * 1e3) if busy else None}
    print(f"decode step profile [{card}]: " + json.dumps(m))
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]:
        print(f"  device ms/step {e.self_device_time_total / n / 1e3:8.3f}"
              f"  launches/step {e.count / n:7.1f}  {e.key[:90]}")
    if not busy:
        print("decode step profile: the profiler saw no device time "
              "(device busy not measured)")


def block_bytes(cfg, quantized: bool) -> int:
    """One replication message: K and V rows of every layer and KV head of
    one page — int8 plus a bf16 scale per row, or bf16."""
    rows = 2 * cfg.n_layers * cfg.n_kv_heads * cfg.page_size
    return rows * (cfg.head_dim + 2) if quantized else rows * cfg.head_dim * 2


def run_path(card, cfg, ecfg, kernel, idle, label, prompts, params=None):
    """One serving path end to end: start the HTTP service (on ``params``
    when given), warm it up, then serving, failover and decode profile.
    ``kernel`` is the wrapper module the path must launch (a positive
    multiple of 32 launches), ``idle`` the one it must not launch. Returns
    (launches on the serving and failover phases, the engine's params)."""
    t0 = time.perf_counter()
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

    def counted(what, fn):
        """Run ``fn`` with both kernels' launch counts set to 0 just before
        and read just after; check the path went through ``kernel``."""
        nonlocal launches
        kernel.launches = idle.launches = 0
        out = fn()
        n, other = kernel.launches, idle.launches
        launches += n
        print(f"[{label}] {kname(kernel)} launches in {what}: {n}; "
              f"{kname(idle)}: {other}")
        check(n > 0 and n % LAYERS_PER_STEP == 0,
              f"{what} launch count {n} is not a positive multiple of "
              f"{LAYERS_PER_STEP}")
        check(other == 0, f"{what} launched {kname(idle)} {other} times")
        return out

    try:
        client = Client(httpd.server_address[1])
        # warm-up: cuBLAS handles and the first allocations
        warm = client.post("/v1/completions",
                           {"prompt_tokens": prompts[0], "max_tokens": 4})
        check(len(warm["choices"][0]["token_ids"]) == 4, "warm-up")

        phase(f"serving ({label})")
        n_samples = len(svc.engine.step_samples)
        t0 = time.perf_counter()
        resps = counted("serving",
                        lambda: join(*client.completions(prompts, 32)))
        wall = time.perf_counter() - t0
        steps = [w for _, w in svc.engine.step_samples[n_samples:]]
        streams = [r["choices"][0]["token_ids"] for r in resps]
        vocab = cfg.vocab_size
        check(all(len(s) == 32 and all(0 <= t < vocab for t in s)
                  for s in streams), "completion shape / token range")
        check(streams[1] == streams[-1], "greedy determinism: same prompt, "
              "different tokens")
        repl = client.health()["replication"]
        per_block = repl["bytes_total"] / max(repl["blocks_total"], 1)
        print(f"[{label}] replication: {repl['blocks_total']} blocks, "
              f"{repl['bytes_total']} B, {per_block:.0f} B per block")
        want = block_bytes(cfg, ecfg.kv_quant)
        check(repl["blocks_total"] > 0 and per_block == want,
              f"replicated bytes per block {per_block} != {want}")
        m = serving_metrics(resps, wall)
        m["engine_steps"] = len(steps)
        m["engine_step_s_median"] = statistics.median(steps)
        m["replicated_bytes_per_block"] = per_block
        print(f"serving [{label}] [{card}]: " + json.dumps(m))

        phase(f"failover ({label})")

        def drill():
            threads, out, errs = client.completions(prompts, 32)
            deadline = time.time() + 300
            while True:
                check(time.time() < deadline, "no instance started decoding")
                h = client.health()
                inst = h["instances"]
                admitted = sum(i["active"] for i in inst)
                decoding = [i["active"] - i["prefilling"] for i in inst]
                # every prompt holds a slot (none is left to be admitted
                # onto the victim after this read) and one instance decodes
                if admitted == len(prompts) and max(decoding) > 0:
                    break
                time.sleep(0.002)
            victim = int(np.argmax(decoding))
            prefilling = inst[victim]["prefilling"]
            fault = client.post("/v1/admin/fault",
                                {"granularity": "instance",
                                 "instance_id": victim, "if_busy": True})
            check(fault["applied"], "fault was not applied")
            print(f"[{label}] killed instance {victim} ({decoding[victim]} "
                  f"decoding, {prefilling} mid-prefill just before the "
                  f"fault); seamlessly resumed {fault['seamlessly_resumed']}")
            return join(threads, out, errs), victim, prefilling

        resps2, victim, prefilling = counted("failover", drill)
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
        decode_profile(svc.engine, card, kernel)
    finally:
        httpd.shutdown()
        svc.shutdown()
        server.join(timeout=30)
    return launches, svc.engine.params


def serving_phases(card: str) -> dict:
    """The bf16 path, then the int8 + chunked-prefill path on the same
    weights. Returns each kernel's launches on its path."""
    cfg = get_config("llama3-8b")
    print(f"model {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"vocab {cfg.vocab_size}, {cfg.n_params() / 1e9:.2f} B params, "
          f"{cfg.dtype}, random weights (torch.Generator seed 0)")
    check(cfg.n_layers == LAYERS_PER_STEP, "layer count")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab_size, n).tolist()
               for n in SERVE_PROMPT_LENS]
    prompts.append(list(prompts[1]))          # the same prompt twice
    bf16, params = run_path(
        card, cfg, EngineConfig(max_slots=8, max_seq=256), PA, PA8, "bf16",
        prompts)
    # same weights, int8 pool, chunks of 64: the 200-token prompt runs 4
    int8, _ = run_path(
        card, cfg, EngineConfig(max_slots=8, max_seq=256, kv_quant=True,
                                prefill_chunk=64),
        PA8, PA, "int8 + chunked prefill", prompts, params=params)
    return {"paged_attention": bf16, "paged_attention_int8": int8}


def build_all():
    """Both kernel libraries from source, one nvcc process per source, all
    started together."""
    t0 = time.perf_counter()
    mods = (PA, PA8)
    with concurrent.futures.ThreadPoolExecutor(len(mods)) as pool:
        libs = list(pool.map(lambda m: m.build(), mods))   # re-raises
    for m, lib in zip(mods, libs):
        secs = m.build_seconds
        print(f"built {os.path.relpath(lib, ROOT)} in "
              f"{secs:.1f} s" if secs is not None else
              f"{os.path.relpath(lib, ROOT)} already built")
    print(f"build phase: {time.perf_counter() - t0:.1f} s wall")


def main() -> int:
    phase("device")
    card = device_line()
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    phase("build")
    build_all()

    phase("kernel")
    entries = [kernel_phase()]
    phase("kernel (int8)")
    entries.append(kernel_int8_phase())

    launches = serving_phases(card)
    for e in entries:
        e["launches"] = launches[e["name"]]

    phase("summary")
    print(json.dumps({"kernels": entries}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
