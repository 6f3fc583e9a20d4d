"""The traffic generator: one general reader of ``traffic/<name>.json``.

The lognormal length model is a frozen copy of the port's
``serving/workload.py`` (``sharegpt_lengths``: a lognormal whose mean is the
stated mean, ``mu = ln(mean) - sigma**2 / 2``, clipped to [min, max] and
truncated to int), kept here so that a change to the program cannot move the
yardstick. What is new: the draw is stratified. A run gets the
distribution's quantiles at ``(i + 0.5) / n`` as its lengths and, for an open
loop, the exponential's quantiles as its inter-arrival gaps, in an order drawn
from the traffic's ``schedule_seed``: every run replays one schedule, and the
run's seed draws the prompts' token ids (and the weights). Runs of two seeds
then offer the same work at the same times and differ by what the tokens
are.

A traffic file gives::

    {"loop": "open" | "closed",
     "rate_rps": ..., (open)      "clients": ..., "stagger_s": ..., (closed)
     "requests": N,   (closed: the pool of requests the clients draw from)
     "schedule_seed": ...,
     "prompt": {"mean": ..., "sigma": ..., "min": ..., "max": ...},
     "output": {"mean": ..., "sigma": ..., "min": ..., "max": ...},
     "kill": {"at_frac": ..., "instance": ..., "rejoin_delay_s": ...} | null,
     "grace_s": ..., "profile_s": ... (the traced run's sub-window, the
     window's last seconds)}
"""
from __future__ import annotations

import dataclasses
import math
from statistics import NormalDist
from typing import List

import numpy as np


@dataclasses.dataclass
class Planned:
    """One request of the plan: when it is due (seconds after the window
    opens; open loop only), its prompt ids and its output length."""
    index: int
    due: float
    prompt: List[int]
    max_new: int


def lognormal_params(mean: float, sigma: float):
    """(mu, sigma) of a lognormal with the given mean (the port's
    parametrization, copied)."""
    return math.log(mean) - sigma ** 2 / 2, sigma


def lognormal_lengths(rng: np.random.Generator, n: int,
                      spec: dict) -> np.ndarray:
    """``n`` lengths from ``spec`` (mean, sigma, min, max): the quantiles at
    (i + 0.5) / n, in ``rng``'s order."""
    mu, sigma = lognormal_params(spec["mean"], spec["sigma"])
    z = np.array([NormalDist().inv_cdf((i + 0.5) / n) for i in range(n)])
    x = np.exp(mu + sigma * z)[rng.permutation(n)]
    return np.clip(x, spec["min"], spec["max"]).astype(int)


def arrival_offsets(rng: np.random.Generator, rate: float,
                    seconds: float) -> np.ndarray:
    """Open-loop due times in [0, seconds): n = floor(rate * seconds) gaps,
    the exponential's quantiles in ``rng``'s order, scaled to sum to
    seconds * n / (n + 1), the first request due at 0."""
    n = max(1, int(rate * seconds))
    gaps = np.array([-math.log(1.0 - (i + 0.5) / n) for i in range(n)])
    gaps = gaps[rng.permutation(n)]
    gaps *= seconds * n / (n + 1) / gaps.sum()
    return np.cumsum(gaps) - gaps[0]


def plan(traffic: dict, seed: int, seconds: float,
         vocab_size: int) -> List[Planned]:
    """The run's requests: due times (open loop), prompt lengths and ids,
    output lengths. A closed loop's plan is the pool its clients take from
    in order (``traffic["requests"]``). The schedule (due times and lengths,
    in their order) comes from the traffic's ``schedule_seed``, the prompt
    ids from ``seed``."""
    rng = np.random.default_rng(traffic["schedule_seed"])
    if traffic["loop"] == "open":
        due = arrival_offsets(rng, traffic["rate_rps"], seconds)
    else:
        due = np.zeros(int(traffic["requests"]))
    n = len(due)
    prompts = lognormal_lengths(rng, n, traffic["prompt"])
    outputs = lognormal_lengths(rng, n, traffic["output"])
    ids = np.random.default_rng([seed % (1 << 63), 1]).integers(
        1, vocab_size, int(prompts.sum()))
    out, at = [], 0
    for i in range(n):
        p = int(prompts[i])
        out.append(Planned(i, float(due[i]), ids[at:at + p].tolist(),
                           int(outputs[i])))
        at += p
    return out


def warmup_prompt_lengths(traffic: dict, page: int) -> List[int]:
    """One prompt length per prefill shape the traffic can reach: the
    power-of-two buckets (at least one page) that lengths in [min, max] fall
    into. A bucket's shapes are the same for every length in it."""
    lo, hi = traffic["prompt"]["min"], traffic["prompt"]["max"]
    out, b = [], page
    while b < lo:
        b *= 2
    prev = b // 2
    while prev < hi:
        out.append(min(b, hi))
        prev, b = b, b * 2
    return out
