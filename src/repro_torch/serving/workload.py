"""ShareGPT-shaped workload generator (paper Sec 4: ShareGPT requests with
Poisson arrivals at a configured RPS).

Length distributions are lognormal, calibrated so the no-failure baseline
reproduces the paper's Sec 4.1 numbers with TPOT 163 ms: avg latency ~64-68 s
(=> ~400 output tokens on average) and p99 latency ~140-150 s (=> ~900
tokens at p99), TTFT ~0.2 s at low load. These are the reference's
calibration constants to the paper's published numbers, copied as they
are."""
from __future__ import annotations

from typing import List

import numpy as np

from repro_torch.serving.request import Request

PROMPT_MEAN, PROMPT_SIGMA = 220.0, 0.6
OUTPUT_MEAN, OUTPUT_SIGMA = 400.0, 0.4


def sharegpt_lengths(rng: np.random.Generator, n: int, *,
                     prompt_mean: float = PROMPT_MEAN,
                     output_mean: float = OUTPUT_MEAN,
                     min_prompt: int = 8, max_prompt: int = 2048,
                     min_output: int = 10, max_output: int = 2048):
    """ShareGPT-shaped lognormal lengths. The mean/clip knobs let the REAL
    engine replay the same distribution scaled to what a run can afford
    while the sim path keeps the calibrated paper defaults."""
    prompt = rng.lognormal(np.log(prompt_mean) - PROMPT_SIGMA ** 2 / 2,
                           PROMPT_SIGMA, n)
    output = rng.lognormal(np.log(output_mean) - OUTPUT_SIGMA ** 2 / 2,
                           OUTPUT_SIGMA, n)
    return (np.clip(prompt, min_prompt, max_prompt).astype(int),
            np.clip(output, min_output, max_output).astype(int))


def attach_prompt_tokens(requests: List[Request], vocab_size: int, *,
                         shared_prefix_frac: float = 0.0,
                         prefix_len: int = 0, seed: int = 0
                         ) -> List[Request]:
    """Materialize concrete prompt token ids onto simulator-shaped
    requests. A ``shared_prefix_frac`` fraction of them (exact count,
    spread uniformly) open with the SAME ``prefix_len``-token preamble —
    the shared system prompt / few-shot header that prefix caching interns
    — while every other prompt (and every tail) is fresh random content.
    Prompts shorter than the preamble stay fully private. Returns the same
    request list for chaining."""
    rng = np.random.default_rng(seed)
    preamble = rng.integers(1, vocab_size, prefix_len).tolist()
    n_shared = int(round(shared_prefix_frac * len(requests)))
    shared = set(rng.permutation(len(requests))[:n_shared].tolist())
    for i, r in enumerate(requests):
        n = r.prompt_len
        if i in shared and prefix_len and n >= prefix_len:
            tail = rng.integers(1, vocab_size, n - prefix_len).tolist()
            r.prompt_tokens = preamble + tail
        else:
            r.prompt_tokens = rng.integers(1, vocab_size, n).tolist()
    return requests


def poisson_workload(rps: float, duration: float, seed: int = 0,
                     start: float = 0.0, rid_base: int = 0,
                     **length_kw) -> List[Request]:
    """Poisson arrivals over [start, start+duration) at the given RPS.
    ``length_kw`` forwards to :func:`sharegpt_lengths`."""
    rng = np.random.default_rng(seed)
    n_expected = int(rps * duration * 1.5 + 64)
    gaps = rng.exponential(1.0 / rps, n_expected)
    times = start + np.cumsum(gaps)
    times = times[times < start + duration]
    prompts, outputs = sharegpt_lengths(rng, len(times), **length_kw)
    return [
        Request(rid=rid_base + i, prompt_len=int(p), max_new_tokens=int(o),
                arrival_time=float(t))
        for i, (t, p, o) in enumerate(zip(times, prompts, outputs))
    ]
