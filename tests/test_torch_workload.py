"""The port's ShareGPT-shaped workload generator (``serving/workload.py``)
against the reference's: for the same seeds, rates and length knobs,
``sharegpt_lengths``, ``poisson_workload`` and ``attach_prompt_tokens``
give equal values, bit for bit. Then the reference's shape bounds on the
port."""
from collections import Counter

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.serving import workload as J  # noqa: E402
from repro_torch.serving import workload as T  # noqa: E402

# the bench-shaped knobs a real-engine replay passes (scaled-down lengths)
KNOBS = [
    {},
    dict(prompt_mean=18.0, output_mean=24.0, max_prompt=40, max_output=40),
    dict(prompt_mean=220.0, max_prompt=448, output_mean=64.0, min_output=4,
         max_output=128),
    dict(min_prompt=1, max_prompt=16, min_output=1, max_output=8),
]


def _rows(reqs):
    return [(r.rid, r.prompt_len, r.max_new_tokens, r.arrival_time,
             r.prompt_tokens) for r in reqs]


@pytest.mark.parametrize("knobs", KNOBS)
@pytest.mark.parametrize("seed", [0, 1, 7])
def test_sharegpt_lengths_equal_reference(seed, knobs):
    p_j, o_j = J.sharegpt_lengths(np.random.default_rng(seed), 500, **knobs)
    p_t, o_t = T.sharegpt_lengths(np.random.default_rng(seed), 500, **knobs)
    assert p_t.dtype == p_j.dtype and o_t.dtype == o_j.dtype
    assert np.array_equal(p_t, p_j) and np.array_equal(o_t, o_j)


@pytest.mark.parametrize("knobs", KNOBS)
@pytest.mark.parametrize("rps,duration,start,rid_base",
                         [(0.5, 200.0, 0.0, 0), (2.0, 600.0, 0.0, 0),
                          (4.0, 100.0, 12.5, 1000), (8.0, 5.0, 0.0, 7)])
@pytest.mark.parametrize("seed", [0, 2])
def test_poisson_workload_equal_reference(seed, rps, duration, start,
                                          rid_base, knobs):
    j = J.poisson_workload(rps, duration, seed=seed, start=start,
                           rid_base=rid_base, **knobs)
    t = T.poisson_workload(rps, duration, seed=seed, start=start,
                           rid_base=rid_base, **knobs)
    assert len(t) == len(j) > 0
    assert _rows(t) == _rows(j)
    assert all(type(r.arrival_time) is float for r in t)
    assert all(start <= r.arrival_time < start + duration for r in t)


@pytest.mark.parametrize("frac,prefix_len", [(0.0, 0), (0.5, 32), (1.0, 16),
                                             (0.3, 300)])
@pytest.mark.parametrize("seed", [0, 3])
def test_attach_prompt_tokens_equal_reference(seed, frac, prefix_len):
    knobs = dict(prompt_mean=60.0, max_prompt=200)
    j = J.attach_prompt_tokens(J.poisson_workload(3.0, 20.0, seed=seed,
                                                  **knobs),
                               1000, shared_prefix_frac=frac,
                               prefix_len=prefix_len, seed=seed)
    t = T.attach_prompt_tokens(T.poisson_workload(3.0, 20.0, seed=seed,
                                                  **knobs),
                               1000, shared_prefix_frac=frac,
                               prefix_len=prefix_len, seed=seed)
    assert _rows(t) == _rows(j)
    assert all(len(r.prompt_tokens) == r.prompt_len for r in t)
    assert all(1 <= tok < 1000 for r in t for tok in r.prompt_tokens)
    if frac and prefix_len:
        # the preamble opens the shared prompts that can hold it, and no
        # more prompts than the fraction asks for
        eligible = [r for r in t if r.prompt_len >= prefix_len]
        heads = Counter(tuple(r.prompt_tokens[:prefix_len])
                        for r in eligible)
        top = heads.most_common(1)[0][1] if heads else 0
        assert top <= round(frac * len(t))
        if frac == 1.0:
            assert top == len(eligible)


def test_workload_shape():
    """The reference's ``tests/test_system.py::test_workload_shape`` bounds
    on the port."""
    rng = np.random.default_rng(0)
    p, o = T.sharegpt_lengths(rng, 20_000)
    assert 180 < p.mean() < 260
    assert 360 < o.mean() < 440
    assert np.percentile(o, 99) > 2 * o.mean()       # heavy tail
    work = T.poisson_workload(4.0, 100.0, seed=2)
    assert 320 < len(work) < 480                     # ~400 expected
