"""The split-K layout and merge of the port's paged-attention kernels, as
plain torch on the CPU.

``csrc/paged_attention_common.cuh`` cuts each sequence's live pages into
contiguous splits, runs an online softmax per split into an f32 partial
(m, l, acc) — scores in log2 units — and merges a sequence's partials in
split order. This file writes that layout and merge out in torch (here, not
in the package: the package's CPU path is the plain oracle) and holds it
against the JAX kernels in interpret mode and the port's oracles, on numpy
inputs, at the f32 tolerance. It also pins the layout's invariants: it is a
function of (start, length, page, head_dim) alone, it covers exactly the
live pages, the grid depth bounds it, and the serving shape gets >= 512
blocks. The CUDA kernels themselves are held against the oracles on the
card in test_torch_gpu.py."""
import inspect
import math
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs in parallel workers on few
# cores, and idle OpenMP threads spin and starve the other workers
torch.set_num_threads(1)
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro_torch.kernels import paged_attention_int8 as PA8  # noqa: E402
from repro_torch.kernels.build import CSRC  # noqa: E402
from repro_torch.kernels.ref import (paged_attention_int8_ref,  # noqa: E402
                                     paged_attention_ref)

TOL = 1e-5
NEG_INF = -1e30
LOG2E = 1.4426950408889634


def _constant(pattern: str) -> int:
    text = (CSRC / "paged_attention_common.cuh").read_text()
    return int(re.search(pattern, text).group(1))


MIN_PAGES_PER_SPLIT = _constant(r"kMinPagesPerSplit = (\d+);")
MAX_SPLITS = _constant(r"kMaxSplits = (\d+);")


def split_layout(start, length, page, head_dim):
    """The kernel's split layout (``split_plan``): the live pages
    [start // page, ceil(length / page)) cut into runs of
    max(MIN_PAGES_PER_SPLIT, ceil(live / MAX_SPLITS)) pages. Returns the
    list of (first page, end page) runs; one empty run when nothing is live.
    ``head_dim`` is taken because the layout may depend on it; this one
    does not."""
    first = max(start, 0) // page
    last = -(-length // page)
    live = max(last - first, 0)
    per = max(MIN_PAGES_PER_SPLIT, -(-live // MAX_SPLITS))
    if live == 0:
        return [(first, first)]
    return [(p, min(p + per, last)) for p in range(first, last, per)]


def max_splits(width):
    """Grid depth for a block table ``width`` pages wide."""
    return max(1, min(MAX_SPLITS, -(-width // MIN_PAGES_PER_SPLIT)))


def split_partial(q, k, v, start, length, page, p0, p1):
    """One split's f32 partial over pages [p0, p1) of one sequence's
    gathered K/V rows: (m, l) per head in log2 units and acc (H, D)."""
    h, d = q.shape
    rows = torch.arange(p0 * page, p1 * page)
    valid = (rows >= start) & (rows < length)
    s = torch.einsum("hd,hrd->hr", q.double(), k[:, rows].double()).float() \
        * np.float32(LOG2E / math.sqrt(d))                  # (H, rows)
    s = torch.where(valid[None], s, torch.full_like(s, NEG_INF))
    m = s.max(-1).values if len(rows) else torch.full((h,), NEG_INF)
    p = torch.where(valid[None], torch.exp2(s - m[:, None]),
                    torch.zeros_like(s))
    acc = torch.einsum("hr,hrd->hd", p.double(), v[:, rows].double())
    return m, p.sum(-1), acc.float()


def merge(partials):
    """The merge pass: partials combined in split order, as the kernel's
    merge_splits_kernel does (an empty split: m = -1e30, l = 0)."""
    mx = torch.stack([m for m, _, _ in partials]).max(0).values
    # one weight vector per split, each of shape (H,): what each split's
    # weight rounds to does not depend on how many splits there are
    w = [torch.exp2(m - mx) for m, _, _ in partials]
    l = sum(wi * li for wi, (_, li, _) in zip(w, partials))
    acc = sum(wi[:, None] * ai for wi, (_, _, ai) in zip(w, partials))
    return acc / torch.clamp(l, min=1e-30)[:, None]


def split_attention(q, k_pages, v_pages, tables, lengths, starts=None):
    """Decode attention through the kernel's split layout and merge, f32:
    q (B, H, D); k/v_pages (K, P, page, D) f32; tables (B, width)."""
    b, h, d = q.shape
    kheads, _, page, _ = k_pages.shape
    rep = h // kheads
    out = torch.empty(b, h, d)
    for i in range(b):
        st = int(starts[i]) if starts is not None else 0
        ln = int(lengths[i])
        kg = k_pages[:, tables[i].long()].reshape(kheads, -1, d)
        vg = v_pages[:, tables[i].long()].reshape(kheads, -1, d)
        kq = kg.repeat_interleave(rep, 0)                    # (H, rows, D)
        vq = vg.repeat_interleave(rep, 0)
        parts = [split_partial(q[i].float(), kq, vq, st, ln, page, p0, p1)
                 for p0, p1 in split_layout(st, ln, page, d)]
        out[i] = merge(parts)
    return out


def _case(b, h, kheads, d, page, width, lengths, starts=None, seed=0):
    """numpy inputs: a pool larger than the tables, pages permuted."""
    rng = np.random.default_rng(seed)
    n_phys = b * width + 3
    q = rng.standard_normal((b, h, d)).astype(np.float32)
    kp = rng.standard_normal((kheads, n_phys, page, d)).astype(np.float32)
    vp = rng.standard_normal((kheads, n_phys, page, d)).astype(np.float32)
    tables = rng.permutation(n_phys)[: b * width].reshape(b, width)
    lengths = np.asarray(lengths, np.int32)
    starts = None if starts is None else np.asarray(starts, np.int32)
    return q, kp, vp, tables.astype(np.int32), lengths, starts


def _torch(*arrs):
    return [None if a is None else torch.from_numpy(a) for a in arrs]


def _jax(*arrs):
    return [None if a is None else jnp.asarray(a) for a in arrs]


PAGE, WIDTH = 4, 36          # runs of 2 pages while few pages are live


def _per_split_boundaries():
    """Lengths just below, at and just above split boundaries: 2-page runs
    (8 tokens), and the live page count past which runs grow beyond 2
    pages."""
    per = MIN_PAGES_PER_SPLIT * PAGE
    edge = MIN_PAGES_PER_SPLIT * MAX_SPLITS * PAGE
    return [per - 1, per, per + 1, 3 * per - 1, 3 * per, 3 * per + 1,
            edge - 1, edge, edge + 1]


CASES = {
    # name: (b, h, kheads, d, lengths, starts)
    "ragged_gqa": (4, 8, 2, 16, [1, 37, 101, WIDTH * PAGE], None),
    "split_boundaries": (9, 4, 1, 16, _per_split_boundaries(), None),
    "length_1": (3, 4, 4, 16, [1, 1, 2], None),
    "starts_mask_whole_splits": (4, 8, 2, 16, [60, 60, 144, 17],
                                 [17, 33, 100, 16]),
    "starts_mask_whole_pages": (3, 6, 3, 32, [9, 40, 130], [4, 12, 3]),
    "mha": (2, 4, 4, 16, [30, 144], [0, 5]),
    "mqa": (2, 8, 1, 16, [70, 129], None),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_split_merge_matches_reference_kernel_and_oracle(name):
    """The split layout + merge agrees with the JAX kernel (interpret mode)
    and the port's plain oracle, f32, within 1e-5."""
    b, h, kheads, d, lengths, starts = CASES[name]
    q, kp, vp, bt, ln, st = _case(b, h, kheads, d, PAGE, WIDTH, lengths,
                                  starts)
    got = split_attention(*_torch(q, kp, vp, bt, ln, st))
    oracle = paged_attention_ref(*_torch(q, kp, vp, bt, ln, st))
    kernel = jops.paged_attention(*_jax(q, kp, vp, bt, ln, st),
                                  interpret=True)
    assert bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got.numpy(), oracle.numpy(), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(kernel), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("name", ["ragged_gqa", "split_boundaries",
                                  "starts_mask_whole_splits", "mqa"])
def test_int8_split_merge_matches_reference_kernel_and_oracle(name):
    """The same over an int8 pool: K and V dequantized (int8 * scale, f32)
    before the split pass, against the JAX int8 kernel (interpret mode) and
    the port's int8 oracle."""
    b, h, kheads, d, lengths, starts = CASES[name]
    q, kp, vp, bt, ln, st = _case(b, h, kheads, d, PAGE, WIDTH, lengths,
                                  starts, seed=1)
    (kq, ks), (vq, vs) = (PA8.quantize_pages(torch.from_numpy(x))
                          for x in (kp, vp))
    tq, tbt, tln, tst = _torch(q, bt, ln, st)
    got = split_attention(tq, PA8.dequantize_pages(kq, ks),
                          PA8.dequantize_pages(vq, vs), tbt, tln, tst)
    oracle = paged_attention_int8_ref(tq, kq, ks, vq, vs, tbt, tln, tst)
    jq, jbt, jln, jst = _jax(q, bt, ln, st)
    ks_j, vs_j = (jnp.asarray(s.float().numpy(), jnp.bfloat16)
                  for s in (ks, vs))
    kernel = jops.paged_attention_int8(
        jq, jnp.asarray(kq.numpy()), ks_j, jnp.asarray(vq.numpy()), vs_j,
        jbt, jln, jst, interpret=True)
    np.testing.assert_allclose(got.numpy(), oracle.numpy(), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(kernel), rtol=TOL,
                               atol=TOL)


def test_layout_is_a_function_of_start_length_page_and_head_dim():
    """The layout takes nothing but the sequence's own start, length, page
    size and head_dim — no batch size, slot, pool size, page ids or card —
    and one sequence's result through it is bit-identical alone, inside a
    batch, and in another slot over other physical pages."""
    assert list(inspect.signature(split_layout).parameters) == [
        "start", "length", "page", "head_dim"]
    q, kp, vp, bt, ln, st = _torch(*_case(5, 8, 2, 16, PAGE, WIDTH,
                                          [3, 77, 129, 144, 50],
                                          [0, 9, 40, 1, 0]))
    batch = split_attention(q, kp, vp, bt, ln, st)
    alone = split_attention(q[2:3], kp, vp, bt[2:3], ln[2:3], st[2:3])
    assert torch.equal(batch[2], alone[0])
    # another slot (first of a new batch) over other physical pages holding
    # the same bytes
    moved_k, moved_v = kp.clone(), vp.clone()
    new_ids = torch.flip(bt[2], [0])         # other ids, same count
    taken = set(bt[2].tolist())
    spare = torch.tensor([p for p in range(kp.shape[1]) if p not in taken]
                         [: len(new_ids)])
    moved_k[:, spare] = kp[:, bt[2].long()]
    moved_v[:, spare] = vp[:, bt[2].long()]
    tables = torch.stack([spare.int(), new_ids.int()])
    moved = split_attention(q[[2, 0]], moved_k, moved_v, tables,
                            ln[[2, 0]], st[[2, 0]])
    assert torch.equal(moved[0], batch[2])


@pytest.mark.parametrize("page", [4, 16])
def test_layout_covers_exactly_the_live_pages(page):
    """Every (start, length) of a table 40 pages wide: the runs are
    contiguous, cover [start // page, ceil(length / page)), are at most
    max(2, ceil(live / MAX_SPLITS)) pages, and number at most the grid
    depth."""
    width = 40
    for length in range(1, width * page + 1):
        for start in range(0, length, max(1, page // 2)):
            runs = split_layout(start, length, page, 128)
            first, last = start // page, -(-length // page)
            assert runs[0][0] == first and runs[-1][1] == last
            assert all(a[1] == b[0] for a, b in zip(runs, runs[1:]))
            live = last - first
            per = max(MIN_PAGES_PER_SPLIT, -(-live // MAX_SPLITS))
            assert all(0 < e - s <= per for s, e in runs)
            assert len(runs) <= min(MAX_SPLITS, max_splits(width))


def test_serving_and_long_shapes_fill_the_card():
    """Serving shape (B 8, K 8, 16 pages): >= 512 blocks. Long shape
    (256 pages): the f32 partials' write + read within 10% of the K/V bytes
    on the bf16 pool (and of the int8 pool with its scales)."""
    b, kheads, rep, d, page = 8, 8, 4, 128, 16
    assert kheads * b * max_splits(16) >= 512
    assert len(split_layout(0, 256, page, d)) == 8
    splits = len(split_layout(0, 4096, page, d))
    partials = 2 * splits * kheads * rep * (d + 2) * 4          # per seq
    kv_bf16 = 2 * 4096 * kheads * d * 2
    kv_int8 = 2 * 4096 * kheads * (d + 2)
    assert partials <= 0.10 * kv_bf16
    assert partials <= 0.10 * kv_int8


def test_empty_split_is_weighted_zero():
    """A split with no valid position (m = -1e30, l = 0) changes nothing
    when merged in, and a merge of empty splits alone gives finite zeros."""
    q, kp, vp, bt, ln, st = _torch(*_case(1, 4, 2, 16, PAGE, WIDTH, [50]))
    kq = kp[:, bt[0].long()].reshape(2, -1, 16).repeat_interleave(2, 0)
    vq = vp[:, bt[0].long()].reshape(2, -1, 16).repeat_interleave(2, 0)
    parts = [split_partial(q[0], kq, vq, 0, 50, PAGE, p0, p1)
             for p0, p1 in split_layout(0, 50, PAGE, 16)]
    empty = split_partial(q[0], kq, vq, 60, 50, PAGE, 0, 2)  # all masked
    assert bool((empty[0] == NEG_INF).all()) and not empty[1].any()
    assert torch.equal(merge(parts + [empty]), merge(parts))
    assert torch.equal(merge([empty] + parts), merge(parts))
    zeros = merge([empty, empty])
    assert bool(torch.isfinite(zeros).all()) and not zeros.any()
