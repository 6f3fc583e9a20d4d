#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

  python3 chip_smoke.py

Phases (each raises, and the script exits non-zero, if its check fails):

  1. device   — a CUDA card is required; prints its name and power limit;
                TF32 off for matmuls and convolutions.
  2. build    — compiles the paged-attention kernel from
                src/repro_torch/kernels/csrc/ with nvcc (sm_90a).
  3. kernel   — holds the CUDA kernel against its plain PyTorch version at
                the serving shape (B=8, H=32, K=8, D=128, page 16, 16 pages,
                bf16, ragged lengths, with and without window starts, fully
                masked pages), in f32, and at the reduced test shape (page 8,
                D 64); times kernel and plain version with CUDA events.
  4. serving  — the port's HTTP server with full-width Llama-3.1-8B (random
                weights from a seeded torch.Generator), 2 instances, ring
                replication on; concurrent completions, greedy determinism,
                TTFT / per-token latency / tokens per second.
  5. failover — the same prompts again; an instance kill through
                /v1/admin/fault while they decode; every stream must equal
                the failure-free one, with at least one migration.
  6. decode profile — one instance's decode step called directly: wall
                time, device-busy time and op count (torch.profiler).
  7. summary  — one JSON line of kernels, the card line, and the final
                {"ok": true, "device": ...} line.

Each path's kernel launch count is set to 0 just before the path and read
just after; launches made to compare a kernel with its plain version are
not counted.
"""
from __future__ import annotations

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
from repro_torch.kernels.ref import paged_attention_ref  # noqa: E402
from repro_torch.serving.engine import EngineConfig  # noqa: E402
from repro_torch.serving.server import serve  # noqa: E402

HBM_BYTES_PER_S = 3.35e12                     # H100 SXM, NVIDIA data sheet
PEAK_FLOPS = {torch.bfloat16: 989e12,         # dense tensor-core bf16
              torch.float32: 67e12}           # f32 outside the tensor cores
TOL = {torch.bfloat16: 3e-2, torch.float32: 1e-5}
LAYERS_PER_STEP = 32                          # one launch per layer per step
SERVE_PROMPT_LENS = [16, 48, 96, 150, 200]


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


def bound_ms(q, kp, lengths, starts):
    """Least time for this call: bytes it must move (valid K/V rows, q,
    out, one table entry per live page, lengths, starts) over the memory
    rate, or its FLOPs over the peak rate of its type — the larger."""
    b, h, d = q.shape
    kheads, _, page, _ = kp.shape
    ln = lengths.cpu().numpy().astype(np.int64)
    st = np.zeros_like(ln) if starts is None \
        else starts.cpu().numpy().astype(np.int64)
    tokens = int((ln - st).sum())
    live_pages = int((-(-ln // page) - st // page).sum())
    nbytes = (2 * tokens * kheads * d * kp.element_size()
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


# -- 4./5. serving and failover -------------------------------------------------

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


def decode_profile(engine, card: str):
    """One instance's decode step, called directly on the engine's weights
    and pool with every slot at position 200 (13 live pages): wall time per
    step (synchronised host clock), device-busy time per step (sum of
    kernel times under torch.profiler), the paged-attention kernel's share,
    and the aten ops dispatched per step."""
    inst = engine.instances[-1]
    b, width = engine.ecfg.max_slots, inst.pages_per_seq
    bt = torch.arange(1, 1 + b * width, dtype=torch.int32,
                      device="cuda").reshape(b, width)
    pos = torch.full((b,), 200, dtype=torch.int32, device="cuda")
    base = torch.zeros_like(pos)
    tok = torch.arange(1, b + 1, dtype=torch.int32, device="cuda")

    def step():
        inst._decode(engine.params, tok, inst.pool.k, inst.pool.v, bt, pos,
                     base, inst._generator)

    for _ in range(2):
        step()
    torch.cuda.synchronize()
    n = 5
    t0 = time.perf_counter()
    for _ in range(n):
        step()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / n
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
    attn = sum(e.self_device_time_total for e in kernels
               if "paged_attention_kernel" in e.key) / n / 1e3
    ops = sum(e.count for e in events if e.key.startswith("aten::")) / n
    m = {"decode_step_wall_ms": wall * 1e3, "device_busy_ms": busy,
         "paged_attention_ms": attn, "aten_ops_per_step": ops,
         "device_idle_share": 1 - busy / (wall * 1e3) if busy else None}
    print(f"decode step profile [{card}]: " + json.dumps(m))
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]:
        print(f"  device ms/step {e.self_device_time_total / n / 1e3:8.3f}"
              f"  launches/step {e.count / n:7.1f}  {e.key[:90]}")
    print(f"  kernel launches per step: {sum(e.count for e in kernels) / n}")
    if not busy:
        print("decode step profile: the profiler saw no device time "
              "(device busy not measured)")


def serving_phases(card: str) -> int:
    cfg = get_config("llama3-8b")
    print(f"model {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"vocab {cfg.vocab_size}, {cfg.n_params() / 1e9:.2f} B params, "
          f"{cfg.dtype}, random weights (torch.Generator seed 0)")
    check(cfg.n_layers == LAYERS_PER_STEP, "layer count")
    t0 = time.perf_counter()
    svc, httpd = serve(cfg, EngineConfig(max_slots=8, max_seq=256),
                       n_instances=2, port=0, device="cuda")
    print(f"engine up in {time.perf_counter() - t0:.1f} s "
          f"(params + 2 KV pools; {torch.cuda.memory_allocated() / 2**30:.1f}"
          f" GiB allocated)")
    server = threading.Thread(target=httpd.serve_forever, daemon=True)
    server.start()
    launches = 0
    try:
        client = Client(httpd.server_address[1])
        rng = np.random.default_rng(0)
        prompts = [rng.integers(1, cfg.vocab_size, n).tolist()
                   for n in SERVE_PROMPT_LENS]
        prompts.append(list(prompts[1]))          # the same prompt twice
        # warm-up: cuBLAS handles and the first allocations
        warm = client.post("/v1/completions",
                           {"prompt_tokens": prompts[0], "max_tokens": 4})
        check(len(warm["choices"][0]["token_ids"]) == 4, "warm-up")

        phase("serving")
        n_samples = len(svc.engine.step_samples)
        PA.launches = 0
        t0 = time.perf_counter()
        resps = join(*client.completions(prompts, 32))
        wall = time.perf_counter() - t0
        steps = [w for _, w in svc.engine.step_samples[n_samples:]]
        n = PA.launches
        launches += n
        print(f"paged_attention launches in serving: {n}")
        check(n > 0 and n % LAYERS_PER_STEP == 0,
              f"launch count {n} is not a positive multiple of "
              f"{LAYERS_PER_STEP}")
        streams = [r["choices"][0]["token_ids"] for r in resps]
        vocab = cfg.vocab_size
        check(all(len(s) == 32 and all(0 <= t < vocab for t in s)
                  for s in streams), "completion shape / token range")
        check(streams[1] == streams[-1], "greedy determinism: same prompt, "
              "different tokens")
        m = serving_metrics(resps, wall)
        m["engine_steps"] = len(steps)
        m["engine_step_s_median"] = statistics.median(steps)
        print(f"serving [{card}]: " + json.dumps(m))

        phase("failover")
        PA.launches = 0
        threads, out, errs = client.completions(prompts, 32)
        deadline = time.time() + 300
        victim = None
        while victim is None:
            check(time.time() < deadline, "no instance started decoding")
            active = [i["active"] for i in client.health()["instances"]]
            if max(active) > 0:
                victim = int(np.argmax(active))
            else:
                time.sleep(0.005)
        fault = client.post("/v1/admin/fault",
                            {"granularity": "instance",
                             "instance_id": victim, "if_busy": True})
        check(fault["applied"], "fault was not applied")
        print(f"killed instance {victim}; seamlessly resumed "
              f"{fault['seamlessly_resumed']}")
        resps2 = join(threads, out, errs)
        n = PA.launches
        launches += n
        print(f"paged_attention launches in failover: {n}")
        check(n > 0 and n % LAYERS_PER_STEP == 0,
              f"failover launch count {n}")
        migrations = [r["kevlarflow"]["migrations"] for r in resps2]
        print(f"migrations per request: {migrations}")
        check(max(migrations) >= 1, "no request migrated")
        check(all(r["kevlarflow"]["retries"] == 0 for r in resps2),
              "a request restarted instead of resuming")
        check([r["choices"][0]["token_ids"] for r in resps2] == streams,
              "resumed streams differ from the failure-free run")
        health = client.health()
        survivor = 1 - victim
        inst = health["instances"]
        check(not inst[victim]["alive"] and inst[survivor]["alive"],
              "health does not show the kill")
        check(health["topology"]["states"][str(survivor)] == "HEALTHY",
              "survivor not healthy")
        after = client.post("/v1/completions",
                            {"prompt_tokens": prompts[0], "max_tokens": 8})
        check(after["choices"][0]["token_ids"] == streams[0][:8],
              "survivor's stream differs")
        print(f"failover [{card}]: all {len(resps2)} streams byte-identical "
              f"to the failure-free run; survivor {survivor} serving")
        httpd.shutdown()
        svc.shutdown()

        phase("decode profile")
        decode_profile(svc.engine, card)
    finally:
        httpd.shutdown()
        svc.shutdown()
        server.join(timeout=30)
    return launches


def main() -> int:
    phase("device")
    card = device_line()
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    phase("build")
    t0 = time.perf_counter()
    lib = PA.build()
    secs = PA.build_seconds
    print(f"built {os.path.relpath(lib, ROOT)} in "
          f"{secs if secs is not None else time.perf_counter() - t0:.1f} s"
          f"{'' if secs is not None else ' (already built)'}")

    phase("kernel")
    entry = kernel_phase()

    entry["launches"] = serving_phases(card)

    phase("summary")
    print(json.dumps({"kernels": [entry]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
