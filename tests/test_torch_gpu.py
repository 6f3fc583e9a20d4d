"""The port's CUDA kernels against their plain PyTorch versions, on a card.

A CUDA kernel has no CPU mode, so every test here carries the ``gpu``
marker and skips without a card. This file imports nothing of JAX, so it
runs where only PyTorch is installed:

  python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
import dataclasses
import importlib
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import paged_attention as PA  # noqa: E402
from repro_torch.kernels import paged_attention_int8 as PA8  # noqa: E402
from repro_torch.kernels import ssd_scan as SSD  # noqa: E402
from repro_torch.kernels.ref import (paged_attention_int8_ref,  # noqa: E402
                                     paged_attention_ref, ssd_scan_ref)
from repro_torch.models import paged_decode as PD  # noqa: E402
from repro_torch.models import ssm  # noqa: E402
from repro_torch.models import transformer  # noqa: E402

TOL = {torch.float32: 1e-5, torch.bfloat16: 3e-2}
ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture(scope="module")
def smoke():
    """chip_smoke.py, for its attention-kernel checks (split-edge cases,
    batch invariance, error limits, kernels per call): one copy serves the
    script and these tests."""
    sys.path.insert(0, str(ROOT))
    return importlib.import_module("chip_smoke")


def _case(b, h, kheads, d, page, pps, dtype, seed=0):
    """Ragged lengths (sequence 0 inside its first page: later pages fully
    masked), window starts (the last sequence's page 0 fully masked)."""
    rng = np.random.default_rng(seed)
    n_phys = pps * b + 3
    f = lambda *s: torch.from_numpy(  # noqa: E731
        rng.standard_normal(s).astype(np.float32)).to(dtype).cuda()
    q, kp, vp = f(b, h, d), f(kheads, n_phys, page, d), \
        f(kheads, n_phys, page, d)
    tables = rng.permutation(n_phys)[: b * pps].reshape(b, pps)
    lengths = rng.integers(1, pps * page + 1, b)
    lengths[0] = max(1, min(lengths[0], page - 1))
    lengths[-1] = pps * page
    starts = rng.integers(0, lengths)
    if pps > 1:
        starts[-1] = page + 1
    i32 = lambda a: torch.from_numpy(a.astype(np.int32)).cuda()  # noqa: E731
    return q, kp, vp, i32(tables), i32(lengths), i32(starts)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [
    (8, 32, 8, 128, 16, 16),   # llama3-8b serving shape
    (8, 32, 8, 128, 16, 256),  # long: 256 pages (length up to 4096)
    (1, 4, 4, 64, 16, 2),      # MHA
    (3, 8, 1, 128, 16, 3),     # MQA
    (2, 16, 8, 128, 32, 2),    # bigger page
    (4, 4, 2, 256, 16, 5),     # head_dim 256
    (4, 4, 2, 64, 8, 5),       # reduced test config (page 8, D 64)
])
def test_paged_attention_kernel_matches_plain(card, smoke, dtype, shape):
    q, kp, vp, bt, ln, st = _case(*shape, dtype)
    for starts in (None, st):
        before = PA.launches
        got = PA.paged_attention(q, kp, vp, bt, ln, starts)
        torch.cuda.synchronize()
        assert PA.launches == before + smoke.launches_per_call(shape[-1])
        want = paged_attention_ref(q, kp, vp, bt, ln, starts)
        assert got.dtype == dtype and got.shape == q.shape
        torch.testing.assert_close(got.float(), want.float(),
                                   rtol=TOL[dtype], atol=TOL[dtype])
        err, limit = smoke.seq_errors(got, want, dtype)
        assert bool((err <= limit).all())


@pytest.mark.gpu
def test_decode_step_runs_through_kernel(card, smoke):
    """One paged decode step of the reduced config on the card calls the
    kernel once per layer and matches the same step on the CPU."""
    cfg = dataclasses.replace(get_config("llama3-8b").reduced(),
                              dtype="float32", kv_dtype="float32")
    params = transformer.init_params(cfg, torch.Generator().manual_seed(0),
                                     device="cpu")

    def to_card(tree):
        return {k: to_card(v) if isinstance(v, dict) else v.to(card)
                for k, v in tree.items()}

    gpu_params = to_card(params)
    kp, vp = PD.init_pages(cfg, 17, cfg.page_size, device="cpu")
    tables = torch.arange(1, 17, dtype=torch.int32).reshape(4, 4)
    pos = torch.tensor([3, 9, 17, 30], dtype=torch.int32)
    tok = torch.tensor([5, 7, 11, 13], dtype=torch.int32)
    kg, vg = kp.cuda(), vp.cuda()          # copies, before the CPU step
    cpu = PD.decode_step_paged(cfg, params, tok, kp, vp, tables, pos)
    before = PA.launches
    gpu = PD.decode_step_paged(cfg, gpu_params, tok.cuda(), kg, vg,
                               tables.cuda(), pos.cuda())
    torch.cuda.synchronize()
    assert PA.launches == before + cfg.n_layers * smoke.launches_per_call(
        tables.shape[1])
    torch.testing.assert_close(gpu[1].cpu(), cpu[1], rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(kg.cpu(), kp, rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [
    (8, 32, 8, 128, 16, 16),   # llama3-8b serving shape
    (8, 32, 8, 128, 16, 256),  # long: 256 pages (length up to 4096)
    (4, 4, 2, 64, 8, 5),       # reduced test config (page 8, D 64)
])
def test_paged_attention_int8_kernel_matches_plain(card, smoke, dtype,
                                                   shape):
    """The int8 kernel against its plain version on the same quantized pool
    (one all-zero token row, scale 1), with and without window starts."""
    q, kp, vp, bt, ln, st = _case(*shape, torch.float32)
    kp[0, 0, 0] = 0.0
    kq, ks = PA8.quantize_pages(kp)
    vq, vs = PA8.quantize_pages(vp)
    assert float(ks[0, 0, 0]) == 1.0
    q = q.to(dtype)
    for starts in (None, st):
        before = PA8.launches
        got = PA8.paged_attention_int8(q, kq, ks, vq, vs, bt, ln, starts)
        torch.cuda.synchronize()
        assert PA8.launches == before + smoke.launches_per_call(shape[-1])
        want = paged_attention_int8_ref(q, kq, ks, vq, vs, bt, ln, starts)
        assert got.dtype == dtype and got.shape == q.shape
        torch.testing.assert_close(got.float(), want.float(),
                                   rtol=TOL[dtype], atol=TOL[dtype])
        err, limit = smoke.seq_errors(got, want, dtype)
        assert bool((err <= limit).all())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("width", [16, 256])
@pytest.mark.parametrize("name", ["yi-9b", "deepseek-67b", "qwen1.5-0.5b",
                                  "qwen1.5-32b"])
def test_dense_config_head_geometries_match_plain(card, smoke, name, width,
                                                  dtype):
    """Both attention kernels at the decode head geometry of each dense
    config (rep 8: the 8-head tile; rep 1 at D 64 and D 128), B 8, page
    16, lengths up to 256 and 4096, against their plain versions."""
    cfg = get_config(name)
    shape = (8, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, 16, width)
    q, kp, vp, bt, ln, st = _case(*shape, torch.float32)
    (kq, ks), (vq, vs) = PA8.quantize_pages(kp), PA8.quantize_pages(vp)
    q = q.to(dtype)
    for kernel, plain, args in (
            (PA.paged_attention, paged_attention_ref,
             (q, kp.to(dtype), vp.to(dtype), bt, ln)),
            (PA8.paged_attention_int8, paged_attention_int8_ref,
             (q, kq, ks, vq, vs, bt, ln))):
        for starts in (None, st):
            got = kernel(*args, starts)
            torch.cuda.synchronize()
            want = plain(*args, starts)
            assert got.dtype == dtype and got.shape == q.shape
            err, limit = smoke.seq_errors(got, want, dtype)
            assert bool((err <= limit).all()), (name, width, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["bf16", "int8"])
@pytest.mark.parametrize("width", [16, 256])
def test_split_boundaries_length_1_and_masked_splits(card, smoke, kind,
                                                     width):
    """Both kernels against their plain versions at lengths around split
    boundaries, at length 1, and with window starts that mask whole splits
    (chip_smoke's edge cases, bf16 q, at the serving and the long table
    width)."""
    shape = smoke.SERVE_SHAPE if width == 16 else smoke.LONG_SHAPE
    dtype = torch.bfloat16
    q, kp, vp, bt, ln, st = smoke.edge_case(shape, torch.float32,
                                            seed=width)
    if kind == "int8":
        kernel, plain = PA8.paged_attention_int8, paged_attention_int8_ref
        args = (q.to(dtype), *smoke.quantized(kp, vp), bt, ln)
    else:
        kernel, plain = PA.paged_attention, paged_attention_ref
        args = (q.to(dtype), kp.to(dtype), vp.to(dtype), bt, ln)
    for starts in (None, st):
        smoke.check_against_plain(f"{kind} width {width}", kernel, plain,
                                  args, starts, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["bf16", "int8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_batch_invariance(card, smoke, kind, dtype):
    """One sequence's output is the same bits alone (B = 1), inside a batch
    of 8, and in another slot over other physical pages holding the same
    bytes; two calls on the same inputs are bit-identical."""
    if kind == "int8":
        smoke.batch_invariance(kind, PA8.paged_attention_int8,
                               smoke.quantized, dtype)
    else:
        smoke.batch_invariance(kind, PA.paged_attention,
                               lambda k, v: (k.to(dtype), v.to(dtype)),
                               dtype)


@pytest.mark.gpu
def test_quantize_pages_on_card_matches_cpu(card):
    x = torch.randn(8, 33, 16, 128, generator=torch.Generator()
                    .manual_seed(0)) * 7
    x[0, 0, 0] = 0.0
    q_cpu, s_cpu = PA8.quantize_pages(x)
    q_gpu, s_gpu = PA8.quantize_pages(x.to(card))
    assert torch.equal(q_gpu.cpu(), q_cpu)
    assert torch.equal(s_gpu.cpu().view(torch.int16), s_cpu.view(torch.int16))


@pytest.mark.gpu
def test_int8_decode_step_runs_through_kernel(card, smoke):
    """One paged decode step of the reduced config on an int8 pool on the
    card calls the int8 kernel once per layer (the bf16 kernel never)
    and matches the same step on the CPU."""
    cfg = dataclasses.replace(get_config("llama3-8b").reduced(),
                              dtype="float32", kv_dtype="float32")
    params = transformer.init_params(cfg, torch.Generator().manual_seed(0),
                                     device="cpu")

    def to_card(tree):
        return {k: to_card(v) if isinstance(v, dict) else v.to(card)
                for k, v in tree.items()}

    gpu_params = to_card(params)
    shape = (cfg.n_layers, cfg.n_kv_heads, 17, cfg.page_size, cfg.head_dim)
    pools = [PA8.quantize_pages(torch.randn(
        shape, generator=torch.Generator().manual_seed(s))) for s in (1, 2)]
    (kp, ks), (vp, vs) = pools
    tables = torch.arange(1, 17, dtype=torch.int32).reshape(4, 4)
    pos = torch.tensor([3, 9, 17, 30], dtype=torch.int32)
    tok = torch.tensor([5, 7, 11, 13], dtype=torch.int32)
    gpu_pool = [t.to(card) for t in (kp, vp, ks, vs)]   # copies
    cpu = PD.decode_step_paged(cfg, params, tok, kp, vp, tables, pos,
                               k_scales=ks, v_scales=vs)
    before, before_bf16 = PA8.launches, PA.launches
    kg, vg, ksg, vsg = gpu_pool
    gpu = PD.decode_step_paged(cfg, gpu_params, tok.to(card), kg, vg,
                               tables.to(card), pos.to(card), k_scales=ksg,
                               v_scales=vsg)
    torch.cuda.synchronize()
    assert PA8.launches == before + cfg.n_layers * \
        smoke.launches_per_call(tables.shape[1])
    assert PA.launches == before_bf16
    torch.testing.assert_close(gpu[1].cpu(), cpu[1], rtol=1e-4, atol=1e-4)
    # the rows this step wrote agree within one quantization step; every
    # other byte is the same
    step = torch.maximum(ksg.cpu().float(), ks.float())
    deq = lambda p, s: p.float() * s.float()  # noqa: E731
    assert ((deq(kg.cpu(), ksg.cpu()) - deq(kp, ks)).abs()
            <= step + 1e-6).all()
    assert (kg.cpu() != kp).any(dim=(1, 4)).sum() <= cfg.n_layers * 4


def _ssd_case(b, s, h, p, n, bc_dtype, seed=0, row_pad=5):
    """The reference sweep's input scales; B and C are strided slices of one
    (b, s, 2n + row_pad) tensor, as the model's are slices of the conv
    output. ``row_pad`` 5 starts no row on a 16-byte boundary (the wrapper
    copies B and C to aligned rows); 8 keeps every row aligned (B and C
    reach the kernels through TMA tensor maps as they stand, as the
    model's do)."""
    rng = np.random.default_rng(seed)
    f = lambda scale, *shape: torch.from_numpy(  # noqa: E731
        (rng.standard_normal(shape) * scale).astype(np.float32)).cuda()
    xdt = f(0.5, b, s, h, p)
    a = -f(0.3, b, s, h).abs()
    bc = f(0.3, b, s, 2 * n + row_pad).to(bc_dtype)
    h0 = f(1.0, b, h, p, n)
    return xdt, a, bc[..., :n], bc[..., n:2 * n], h0


SSD_SHAPES = [
    (2, 96, 16, 32, 32, 32),     # reduced mamba2-130m heads, 3 chunks
    (2, 512, 24, 64, 128, 256),  # full-width mamba2-130m heads, 2 chunks
    (2, 200, 24, 64, 128, 200),  # ragged: chunk = s = 200 (6 x 32 + 8)
]
SSD_EDGE_SHAPES = [
    (2, 128, 4, 24, 64, 64),     # p not a multiple of the 16-row P tile
    (2, 96, 3, 40, 128, 32),
    (2, 33, 4, 64, 128, 33),     # around a 32-position sub-chunk
    (2, 64, 4, 64, 128, 64),
    (2, 65, 4, 64, 128, 65),
    (2, 128, 8, 16, 128, 64),    # one P tile per head
    (2, 96, 4, 64, 256, 32),     # N 129-256: 8 state n-tiles per warp
    (2, 96, 4, 32, 200, 96),
    (2, 64, 4, 18, 20, 32),      # P and N padded by the wrapper
]


def _check_ssd_scan(shape, bc_dtype, with_h0, row_pad):
    b, s, h, p, n, chunk = shape
    xdt, a, B, C, h0 = _ssd_case(b, s, h, p, n, bc_dtype, row_pad=row_pad)
    h0 = h0 if with_h0 else None
    before = SSD.launches
    y, hf = SSD.ssd_scan(xdt, a, B, C, chunk=chunk, h0=h0)
    torch.cuda.synchronize()
    assert SSD.launches == before + SSD.KERNELS_PER_CALL
    ry, rh = ssd_scan_ref(xdt, a, B, C, h0)
    assert y.shape == (b, s, h, p) and hf.shape == (b, h, p, n)
    torch.testing.assert_close(y, ry, rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(hf, rh, rtol=2e-4, atol=2e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("row_pad", [5, 8])
@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("bc_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SSD_SHAPES + SSD_EDGE_SHAPES)
def test_ssd_scan_kernel_matches_plain(card, shape, bc_dtype, with_h0,
                                       row_pad):
    """The kernel against the sequential recurrence on the same inputs (the
    bf16 B and C widen exactly to f32 in both), within the reference's own
    kernel-vs-oracle tolerance: at the model's shapes and at the P-tile,
    sub-chunk and state-width edges, with B and C rows unaligned (copied by
    the wrapper) and aligned (through the TMA tensor maps as they are)."""
    _check_ssd_scan(shape, bc_dtype, with_h0, row_pad=row_pad)


@pytest.mark.gpu
@pytest.mark.parametrize("row_pad", [5, 8])
@pytest.mark.parametrize("bc_dtype", [torch.float32, torch.bfloat16])
def test_ssd_scan_kernel_is_deterministic(card, bc_dtype, row_pad):
    """No atomics: two calls on the same inputs give the same bits."""
    xdt, a, B, C, h0 = _ssd_case(2, 200, 24, 64, 128, bc_dtype,
                                 row_pad=row_pad)
    first = SSD.ssd_scan(xdt, a, B, C, chunk=200, h0=h0)
    second = SSD.ssd_scan(xdt, a, B, C, chunk=200, h0=h0)
    assert all(torch.equal(u, v) for u, v in zip(first, second))


@pytest.mark.gpu
def test_ssm_prefill_runs_through_kernel(card):
    """A reduced float32 Mamba-2 prefill on the card launches the scan's two
    kernels once per layer (40 tokens: padded to 64 at chunk 32) and matches
    the same prefill on the CPU (the plain chunked form)."""
    cfg = dataclasses.replace(get_config("mamba2-130m").reduced(),
                              dtype="float32")
    params = ssm.init_params(cfg, torch.Generator().manual_seed(0),
                             device="cpu")

    def to_card(tree):
        return {k: to_card(v) if isinstance(v, dict) else v.to(card)
                for k, v in tree.items()}

    toks = torch.from_numpy(np.random.default_rng(0).integers(
        2, cfg.vocab_size, (2, 40)).astype(np.int32))
    cpu = ssm.prefill(cfg, params, toks)
    before = SSD.launches
    gpu = ssm.prefill(cfg, to_card(params), toks.to(card))
    torch.cuda.synchronize()
    assert SSD.launches == before + SSD.KERNELS_PER_CALL * cfg.n_layers
    torch.testing.assert_close(gpu[0].cpu(), cpu[0], rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(gpu[1]["ssm"].cpu(), cpu[1]["ssm"],
                               rtol=1e-4, atol=1e-4)
