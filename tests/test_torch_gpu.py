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

from repro_torch import tracing  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import paged_attention as PA  # noqa: E402
from repro_torch.kernels import moe_mlp as MOE  # noqa: E402
from repro_torch.kernels import paged_attention_int8 as PA8  # noqa: E402
from repro_torch.kernels import ssd_scan as SSD  # noqa: E402
from repro_torch.kernels.ref import (paged_attention_int8_ref,  # noqa: E402
                                     paged_attention_ref,
                                     ssd_scan_backward_ref, ssd_scan_ref)
from repro_torch.models import api  # noqa: E402
from repro_torch.models import hybrid  # noqa: E402
from repro_torch.models import moe  # noqa: E402
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
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("width", [16, 128])
def test_recurrentgemma_head_geometry_matches_plain(card, smoke, width,
                                                    dtype):
    """Both attention kernels at recurrentgemma-9b's local attention: MQA
    H 16 / K 1 / D 256 (rep 16: two 8-head tiles of 32 lanes a row), B 8,
    page 16, lengths up to 256 and up to its 2048-token window, with and
    without window starts, against their plain versions."""
    cfg = get_config("recurrentgemma-9b")
    shape = (8, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, 16, width)
    assert shape[1:4] == (16, 1, 256)
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
            assert bool((err <= limit).all()), (width, dtype)


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


@pytest.mark.gpu
def test_moe_decode_step_runs_through_kernel(card, smoke):
    """One paged decode step of the reduced float32 mixtral on the card,
    past its 64-token window (base and starts > 0 on the last slot): the
    kernel once per layer, and the CPU step's logits and pages."""
    cfg = dataclasses.replace(get_config("mixtral-8x7b").reduced(),
                              dtype="float32", kv_dtype="float32")
    params = api.init_params(cfg, torch.Generator().manual_seed(0),
                             device="cpu")

    def to_card(tree):
        return {k: to_card(v) if isinstance(v, dict) else v.to(card)
                for k, v in tree.items()}

    width = PD.table_pages(cfg, 4 * cfg.sliding_window)      # the ring, 9
    kp, vp = PD.init_pages(cfg, 4 * width + 1, cfg.page_size, device="cpu")
    kp.normal_(generator=torch.Generator().manual_seed(1))
    vp.normal_(generator=torch.Generator().manual_seed(2))
    tables = torch.arange(1, 4 * width + 1, dtype=torch.int32).reshape(
        4, width)
    pos = torch.tensor([3, 9, 17, 80], dtype=torch.int32)
    base = torch.tensor([0, 0, 0, 16], dtype=torch.int32)
    tok = torch.tensor([5, 7, 11, 13], dtype=torch.int32)
    kg, vg = kp.to(card), vp.to(card)          # copies, before the CPU step
    cpu = PD.decode_step_paged(cfg, params, tok, kp, vp, tables, pos,
                               base=base)
    before = PA.launches
    gpu = PD.decode_step_paged(cfg, to_card(params), tok.to(card), kg, vg,
                               tables.to(card), pos.to(card),
                               base=base.to(card))
    torch.cuda.synchronize()
    assert PA.launches == before + cfg.n_layers * smoke.launches_per_call(
        width)
    torch.testing.assert_close(gpu[1].cpu(), cpu[1], rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(kg.cpu(), kp, rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["llama3-8b", "mixtral-8x7b"])
def test_chunked_prefill_bit_equal_to_monolithic_on_card(card, name):
    """Full width, 2 layers, bf16, a 200-token prompt in bucket 256: chunks
    of 64 give the monolithic prefill's K/V rows and logits bit for bit
    (products in 64-row blocks, attention in 64-row query chunks: the
    same cuBLAS shapes either way)."""
    cfg = dataclasses.replace(get_config(name), n_layers=2)
    params = api.init_params(cfg, torch.Generator(card).manual_seed(0),
                             device=card)
    n, bucket, chunk = 200, 256, 64
    toks = torch.zeros((1, bucket), dtype=torch.int32, device=card)
    toks[0, :n] = torch.randint(1, cfg.vocab_size, (n,),
                                generator=torch.Generator(card).manual_seed(1),
                                device=card)
    lm, km, vm = PD.prefill_bucketed(cfg, params, toks, n)
    kb, vb = PD.init_chunk_buffers(cfg, bucket, device=card)
    for c0 in range(0, n, chunk):
        logits, kb, vb = PD.prefill_chunk(cfg, params,
                                          toks[:, c0:c0 + chunk], c0,
                                          min(chunk, n - c0), kb, vb)
    assert torch.equal(logits, lm)
    assert torch.equal(km[:, :n], kb[:, :n].to(km.dtype))
    assert torch.equal(vm[:, :n], vb[:, :n].to(vm.dtype))


@pytest.mark.gpu
@pytest.mark.parametrize("kv_quant", [False, True])
def test_hybrid_decode_step_runs_through_kernel(card, smoke, kv_quant):
    """One paged decode step of the reduced float32 recurrentgemma on the
    card, past its 64-token window on the last slot: the kernel once per
    local-attention layer, and the CPU step's logits, pages and state blobs
    (int8: the pool and the blob stay int8)."""
    cfg = dataclasses.replace(get_config("recurrentgemma-9b").reduced(),
                              dtype="float32", kv_dtype="float32")
    params = api.init_params(cfg, torch.Generator().manual_seed(0),
                             device="cpu")

    def to_card(tree):
        if isinstance(tree, dict):
            return {k: to_card(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [to_card(v) for v in tree]
        return tree.to(card)

    width = PD.table_pages(cfg, 4 * cfg.sliding_window)      # the ring, 9
    kp, vp = PD.init_pages(cfg, 4 * width + 1, cfg.page_size, device="cpu")
    kp.normal_(generator=torch.Generator().manual_seed(1))
    vp.normal_(generator=torch.Generator().manual_seed(2))
    blobs = torch.randn((5, hybrid.state_blob_words(cfg)),
                        generator=torch.Generator().manual_seed(3))
    pool = [kp, vp, blobs]
    scales = {}
    if kv_quant:
        (kp, ks), (vp, vs), (blobs, bs) = (PA8.quantize_pages(t)
                                           for t in pool)
        pool = [kp, vp, blobs]
        scales = dict(k_scales=ks, v_scales=vs, blob_scales=bs)
    tables = torch.arange(1, 4 * width + 1, dtype=torch.int32).reshape(
        4, width)
    slots = torch.tensor([1, 2, 3, 4], dtype=torch.int32)
    pos = torch.tensor([3, 9, 17, 80], dtype=torch.int32)
    base = torch.tensor([0, 0, 0, 16], dtype=torch.int32)
    tok = torch.tensor([5, 7, 11, 13], dtype=torch.int32)
    on_card = [t.to(card) for t in pool]       # copies, before the CPU step
    card_scales = {k: v.to(card) for k, v in scales.items()}
    cpu = PD.decode_step_paged_hybrid(cfg, params, tok, *pool, tables, slots,
                                      pos, base=base, **scales)
    kernel = PA8 if kv_quant else PA
    before = kernel.launches
    gpu = PD.decode_step_paged_hybrid(
        cfg, to_card(params), tok.to(card), *on_card, tables.to(card),
        slots.to(card), pos.to(card), base=base.to(card), **card_scales)
    torch.cuda.synchronize()
    assert kernel.launches == before + len(PD.kv_layer_indices(cfg)) \
        * smoke.launches_per_call(width)
    torch.testing.assert_close(gpu[1].cpu(), cpu[1], rtol=1e-4, atol=1e-4)
    for got, want in zip(on_card, pool):
        assert got.dtype == want.dtype
        if kv_quant:       # an int8 word may round the other way
            assert (got.cpu().int() - want.int()).abs().max() <= 1
        else:
            torch.testing.assert_close(got.cpu(), want, rtol=1e-4,
                                       atol=1e-4)


@pytest.mark.gpu
def test_hybrid_chunked_prefill_bit_equal_to_monolithic_on_card(card):
    """Full width, 3 layers (rglru, rglru, local attention), bf16, a
    200-token prompt in bucket 256: chunks of 64 give the monolithic
    prefill's logits, K/V rows and state blob bit for bit (products in
    64-row blocks, the RG-LRU scan position by position)."""
    cfg = dataclasses.replace(get_config("recurrentgemma-9b"), n_layers=3)
    params = api.init_params(cfg, torch.Generator(card).manual_seed(0),
                             device=card)
    gates = hybrid.gate_tables(cfg, params)
    n, bucket, chunk = 200, 256, 64
    toks = torch.zeros((1, bucket), dtype=torch.int32, device=card)
    toks[0, :n] = torch.randint(1, cfg.vocab_size, (n,),
                                generator=torch.Generator(card).manual_seed(1),
                                device=card)
    lm, km, vm, bm = PD.prefill_hybrid_bucketed(cfg, params, toks, n,
                                                gates=gates)
    kb, vb = PD.init_chunk_buffers(cfg, bucket, device=card)
    st = PD.init_hybrid_chunk_state(cfg, device=card)
    for c0 in range(0, n, chunk):
        logits, kb, vb, st, blob = PD.prefill_hybrid_chunk(
            cfg, params, toks[:, c0:c0 + chunk], c0, min(chunk, n - c0), kb,
            vb, st, gates=gates)
    assert torch.equal(logits, lm)
    assert torch.equal(blob, bm)
    assert torch.equal(km[:, :n], kb[:, :n].to(km.dtype))
    assert torch.equal(vm[:, :n], vb[:, :n].to(vm.dtype))


@pytest.mark.gpu
def test_moe_decode_mlp_slot_is_batch_invariant_on_card(card):
    """Full-width mixtral layer, bf16, 8 slots: a slot's routed MLP output
    is the same bits whatever the other slots hold and wherever the token
    sits."""
    cfg = dataclasses.replace(get_config("mixtral-8x7b"), n_layers=1)
    params = api.init_params(cfg, torch.Generator(card).manual_seed(0),
                             device=card)
    p = transformer.layer_params(params["layers"], 0)
    gen = torch.Generator(card).manual_seed(3)
    x, other = (torch.randn((8, 1, cfg.d_model), generator=gen,
                            device=card).bfloat16() for _ in range(2))
    y = moe.decode_mlp(cfg, p, x)
    moved = other.clone()
    moved[5] = x[0]
    assert torch.equal(moe.decode_mlp(cfg, p, moved)[5], y[0])


def _moe_layer(card, name, seed=0):
    """One full-width MoE layer's router (f32, scale 0.02) and bf16 experts
    (1/sqrt(fan_in)), drawn on the card."""
    cfg = get_config(name)
    gen = torch.Generator(card).manual_seed(seed)
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts

    def draw(*shape):
        return (torch.randn(shape, generator=gen, device=card)
                * shape[-2] ** -0.5).bfloat16()

    p = {"router": torch.randn((d, e), generator=gen, device=card) * 0.02,
         "experts": {"w_gate": draw(e, d, f), "w_up": draw(e, d, f),
                     "w_down": draw(e, f, d)}}
    return cfg, p


def _moe_close(got, want):
    """The kernel against the plain version (``expert_mix``): the same
    exact products (bf16 x bf16, and the down projection's f32 operand
    split exactly into three bf16 parts) summed in another order, so the
    f32 sums differ by a few f32 steps and, after the one cast to bf16,
    an output differs by at most one bf16 step, or by 1e-5 of the largest
    output where the sum cancels to near 0, and few differ at all (a
    product rounded to bf16 would move most of them)."""
    assert got.dtype == want.dtype == torch.bfloat16
    g, w = got.float(), want.float()
    diff = (g - w).abs()
    bad = diff > w.abs() * 2.0 ** -7 + 1e-5 * float(w.abs().max())
    assert not bool(bad.any()), (g[bad][:8].tolist(), w[bad][:8].tolist())
    share = float((diff > 0).float().mean())
    assert share < 0.02, share


@pytest.mark.gpu
@pytest.mark.parametrize("tokens,decode", [(1, True), (8, True),
                                           (32, True), (64, False),
                                           (256, False), (1024, False)])
@pytest.mark.parametrize("name", ["mixtral-8x7b", "dbrx-132b"])
def test_moe_mlp_kernel_matches_plain(card, name, tokens, decode):
    """Full-width layer shapes, decode (B slots, one routing group) and
    serving prefill (T tokens in 64-row router blocks): the kernel path
    against ``expert_mix``, one call through the kernel each, and two
    calls the same bits."""
    cfg, p = _moe_layer(card, name)
    gen = torch.Generator(card).manual_seed(tokens)
    shape = (tokens, 1, cfg.d_model) if decode else (1, tokens, cfg.d_model)
    x = torch.randn(shape, generator=gen, device=card).bfloat16()
    run = (lambda **kw: moe.moe_mlp(
        cfg, p, x, group_size=tokens, capacity_factor=float(cfg.n_experts),
        **kw)[0]) if decode else (lambda **kw: moe.moe_mlp(
            cfg, p, x, capacity_factor=float(cfg.n_experts),
            rows=PD.PREFILL_ROWS, **kw)[0])
    before = MOE.launches
    got = run()
    assert MOE.launches == before + 1
    assert torch.equal(run(), got)
    _moe_close(got, run(kernel=False))


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["mixtral-8x7b", "dbrx-132b"])
def test_moe_mlp_tile_shapes_give_the_same_bits(card, name):
    """The decode (32-row) and prompt (128-row) down tiles run the same K
    order: the same bits for 300 tokens that share a direction, so that
    some experts get more rows than one tall tile holds."""
    cfg, p = _moe_layer(card, name, seed=2)
    t, k = 300, cfg.top_k
    gen = torch.Generator(card).manual_seed(6)
    x = (torch.randn((t, cfg.d_model), generator=gen, device=card) * 0.3
         + torch.randn(cfg.d_model, generator=gen, device=card)).bfloat16()
    _, topk_i, topk_p, _, _ = moe.route(cfg, p["router"], x[None], t * k)
    ex = p["experts"]
    args = (x, ex["w_gate"], ex["w_up"], ex["w_down"],
            topk_i[0].contiguous(), topk_p[0])
    short, rows = MOE.routed_mlp(*args)
    tall, _ = MOE.routed_mlp(*args, tall=True)
    assert max(rows.tolist()) > 128
    assert torch.equal(short, tall)


@pytest.mark.gpu
def test_moe_mlp_kernel_drops_what_plain_drops(card):
    """A finite capacity (cf 1.0 over 32 slots: 8 pairs an expert) drops
    pairs: the kernel runs exactly the kept ones, and its output is the
    plain version's, which weights the dropped pairs by 0."""
    cfg, p = _moe_layer(card, "mixtral-8x7b")
    t, k, d = 32, cfg.top_k, cfg.d_model
    x = torch.randn((t, d), generator=torch.Generator(card).manual_seed(2),
                    device=card).bfloat16()
    cap = int(t * k / cfg.n_experts)
    _, topk_i, topk_p, keep, onehot = moe.route(cfg, p["router"], x[None],
                                                cap)
    assert not bool(keep.all())
    ex = p["experts"]
    got, rows = MOE.routed_mlp(x, ex["w_gate"], ex["w_up"], ex["w_down"],
                               topk_i[0].contiguous(), topk_p[0], keep[0])
    kept = torch.zeros(cfg.n_experts, dtype=torch.long, device=card)
    kept.index_add_(0, topk_i[0][keep[0]], torch.ones_like(
        topk_i[0][keep[0]]))
    assert rows.tolist() == kept.tolist()
    assert max(rows.tolist()) <= cap
    combine = (onehot[0] * (topk_p[0] * keep[0])[..., None]).sum(dim=1)
    _moe_close(got, moe.expert_mix(ex, x.float(), combine).bfloat16())
    got2, _ = moe.moe_mlp(cfg, p, x[:, None], group_size=t,
                          capacity_factor=1.0)
    assert torch.equal(got2[:, 0], got)


@pytest.mark.gpu
def test_moe_mlp_kernel_refuses_what_it_does_not_take(card):
    """Wrong dtype, wrong shape, a tensor off the card, rows off 16 bytes,
    a width that is no multiple of the tiles: the wrapper raises and
    launches nothing."""
    cfg = get_config("mixtral-8x7b").reduced()          # d 256, f 512
    e, d, f, t, k = cfg.n_experts, cfg.d_model, cfg.d_ff, 4, cfg.top_k
    w = lambda *s: torch.zeros(s, device=card).bfloat16()  # noqa: E731
    x, wg, wu, wd = w(t, d), w(e, d, f), w(e, d, f), w(e, f, d)
    ti = torch.zeros((t, k), dtype=torch.int64, device=card)
    ti[:, 1] = 1
    tp = torch.full((t, k), 0.5, device=card)
    before = MOE.launches
    with pytest.raises(TypeError):
        MOE.routed_mlp(x.float(), wg, wu, wd, ti, tp)
    with pytest.raises(TypeError):
        MOE.routed_mlp(x, wg, wu, wd, ti.int(), tp)
    with pytest.raises(ValueError):
        MOE.routed_mlp(x, wg, wu, wd.transpose(1, 2), ti, tp)
    with pytest.raises(ValueError):
        MOE.routed_mlp(x, wg, wu, wd, ti.cpu(), tp)
    off = torch.zeros(t * d + 1, device=card).bfloat16()[1:].view(t, d)
    with pytest.raises(ValueError):
        MOE.routed_mlp(off, wg, wu, wd, ti, tp)
    with pytest.raises(ValueError):
        MOE.routed_mlp(x[:, :192].contiguous(), wg[:, :192].contiguous(),
                       wu[:, :192].contiguous(), wd[..., :192].contiguous(),
                       ti, tp)
    assert MOE.launches == before
    out, rows = MOE.routed_mlp(x, wg, wu, wd, ti, tp)
    assert MOE.launches == before + 1
    assert rows.tolist() == [t, t] + [0] * (e - 2)
    assert not bool(out.float().abs().sum())


@pytest.mark.gpu
def test_moe_kernel_path_annotates_its_span(card):
    """Inside a span, the kernel path adds ``pairs`` (drop-free) and
    ``expert_rows`` (the dispatch's device tensor, a list at export,
    summing to the pairs); a finite capacity leaves ``pairs`` out."""
    cfg, p = _moe_layer(card, "mixtral-8x7b", seed=3)
    x = torch.randn((1, 16, cfg.d_model),
                    generator=torch.Generator(card).manual_seed(3),
                    device=card).bfloat16()
    tracing.disable()
    tracing.reset()
    tracing.enable()
    try:
        with tracing.span("moe.routed_mlp", device=True):
            moe.moe_mlp(cfg, p, x, capacity_factor=float(cfg.n_experts),
                        aux=False)
        with tracing.span("moe.routed_mlp", device=True):
            moe.moe_mlp(cfg, p, x, capacity_factor=0.5)
    finally:
        tracing.disable()
    free, capped = tracing.export()["spans"]
    tracing.reset()
    pairs = 16 * cfg.top_k
    assert free["attrs"]["pairs"] == pairs
    assert len(free["attrs"]["expert_rows"]) == cfg.n_experts
    assert sum(free["attrs"]["expert_rows"]) == pairs
    assert "pairs" not in capped["attrs"]
    assert sum(capped["attrs"]["expert_rows"]) < pairs


@pytest.mark.gpu
def test_moe_serving_steps_run_through_kernel(card):
    """Full-width mixtral, 2 layers, bf16: a monolithic serving prefill and
    one paged decode step of 4 slots each call the kernel once a layer."""
    cfg = dataclasses.replace(get_config("mixtral-8x7b"), n_layers=2)
    params = api.init_params(cfg, torch.Generator(card).manual_seed(0),
                             device=card)
    n, bucket = 40, 64
    toks = torch.zeros((1, bucket), dtype=torch.int32, device=card)
    toks[0, :n] = torch.arange(1, n + 1, device=card)
    before = MOE.launches
    PD.prefill_bucketed(cfg, params, toks, n)
    assert MOE.launches == before + cfg.n_layers
    width = 4
    kp, vp = PD.init_pages(cfg, 4 * width + 1, cfg.page_size, device=card)
    tables = torch.arange(1, 4 * width + 1, dtype=torch.int32,
                          device=card).reshape(4, width)
    pos = torch.tensor([3, 9, 17, 30], dtype=torch.int32, device=card)
    tok = torch.tensor([5, 7, 11, 13], dtype=torch.int32, device=card)
    before = MOE.launches
    PD.decode_step_paged(cfg, params, tok, kp, vp, tables, pos)
    torch.cuda.synchronize()
    assert MOE.launches == before + cfg.n_layers


@pytest.mark.gpu
def test_moe_prefill_mlp_row_is_batch_invariant_on_card(card):
    """Full-width mixtral layer, bf16, serving prefill: a row's routed MLP
    output is the same bits in a 64-row and a 256-row prefill, and wherever
    the row sits."""
    cfg, p = _moe_layer(card, "mixtral-8x7b", seed=1)
    x = torch.randn((1, 256, cfg.d_model),
                    generator=torch.Generator(card).manual_seed(4),
                    device=card).bfloat16()
    rows = PD.PREFILL_ROWS
    y = moe.serving_prefill_mlp(cfg, p, x, rows)
    assert torch.equal(moe.serving_prefill_mlp(cfg, p, x[:, :64], rows),
                       y[:, :64])
    moved = torch.flip(x, [1])
    assert torch.equal(moe.serving_prefill_mlp(cfg, p, moved, rows),
                       torch.flip(y, [1]))


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
@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("bc_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SSD_SHAPES + SSD_EDGE_SHAPES[-3:])
def test_ssd_scan_backward_kernel_matches_plain(card, shape, bc_dtype,
                                                with_h0):
    """The backward kernel against its plain version run in float64 on the
    same inputs, with and without h0 and gh: f32 gradients within 1e-5 of
    their largest magnitude, bf16 dB and dC within one bf16 spacing of it
    (2^-7); two calls give the same bits; one call launches
    ``KERNELS_PER_BACKWARD`` kernels."""
    b, s, h, p, n, _ = shape
    xdt, a, B, C, h0 = _ssd_case(b, s, h, p, n, bc_dtype)
    g = torch.Generator(device="cuda").manual_seed(1)
    gy = torch.randn((b, s, h, p), generator=g, device="cuda")
    gh = torch.randn((b, h, p, n), generator=g, device="cuda")
    ins = (xdt, a, B, C, h0 if with_h0 else None, gy,
           gh if with_h0 else None)
    before = SSD.backward_launches
    got = SSD.ssd_scan_backward(*ins)
    torch.cuda.synchronize()
    assert SSD.backward_launches == before + SSD.KERNELS_PER_BACKWARD
    assert all(u is None and v is None or torch.equal(u, v)
               for u, v in zip(got, SSD.ssd_scan_backward(*ins)))
    want = ssd_scan_backward_ref(*(t.double() if t is not None and t.dtype
                                   == torch.float32 else t for t in ins))
    for name, u, w in zip("dxdt da dB dC dh0".split(), got, want):
        if w is None:
            assert u is None, name
            continue
        tol = 1e-5 if u.dtype == torch.float32 else 2.0 ** -7
        assert u.shape == w.shape and u.dtype == ins[2 if name in (
            "dB", "dC") else 0].dtype, name
        assert float((u.double() - w).abs().max()) <= \
            tol * float(w.abs().max()), name


@pytest.mark.gpu
def test_ssd_scan_backward_grid_and_scratch(card):
    """At mamba2-130m's train shape (b 4, s 256, h 24, p 64, n 128) the
    backward's grid reports its three kernels — the C·Bᵀ pass, the walk
    (one block per 16-row P tile, head and batch row) and the dB / dC / da
    kernel (head groups dividing h, up to 8, per sub-chunk and batch row) —
    with shared memory and blocks per SM, and its scratch: the entering
    states and the leaving gradients (b, n_sub, h, p, n) f32 each, C·Bᵀ and
    the dcum partials, 50.8 MB, within the 75.7 MB the kernel it replaced
    took."""
    b, s, h, p, n = 4, 256, 24, 64, 128
    grid = SSD.backward_grid(b, s, h, p, n)
    for k in ("cb_pass", "walk", "dbc"):
        assert grid[k] > 0 and grid[f"{k}_smem_bytes"] > 0
        assert grid[f"{k}_blocks_per_sm"] >= 1
    n_sub = s // 32
    assert grid["walk"] == b * h * (p // 16)
    groups = grid["dbc"] // (b * n_sub)
    assert grid["dbc"] == b * n_sub * groups and 1 <= groups <= 8
    assert h % groups == 0
    assert grid["scratch_bytes"] == 4 * (2 * b * n_sub * h * p * n
                                         + b * n_sub * 32 * 32
                                         + b * n_sub * 32 * h * (p // 16))
    assert grid["scratch_bytes"] <= 75.7e6


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


@pytest.mark.gpu
def test_ssm_gradient_through_kernel_matches_cpu(card):
    """A reduced float32 Mamba-2 loss on the card: its scans go through the
    forward and the backward kernels (``ssm.SSDScan``; no plain backward
    scan), and every param leaf's gradient
    matches the same loss on the CPU (plain autograd through the chunked
    form) — ``in_proj``, ``conv_w``, ``conv_b``, ``dt_bias`` and ``A_log``
    included, which reach the loss only through the scan. The raw kernel
    wrapper refuses an input that requires grad."""
    from repro_torch.training import tree
    cfg = dataclasses.replace(get_config("mamba2-130m").reduced(),
                              dtype="float32")
    params = ssm.init_params(cfg, torch.Generator().manual_seed(1),
                             device="cpu")
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        2, cfg.vocab_size, (2, 65)).astype(np.int32))

    def grads(device):
        flat = [p.detach().to(device).requires_grad_()
                for p in tree.leaves(params)]
        loss = api.loss(cfg, tree.unflatten(params, flat),
                        {"tokens": toks.to(device)})
        return [g.cpu() for g in torch.autograd.grad(loss, flat)]

    before, before_back = SSD.launches, SSD.backward_launches
    ssm.plain_backward_scans = 0
    got = grads(card)
    assert SSD.launches == before + SSD.KERNELS_PER_CALL * cfg.n_layers
    assert SSD.backward_launches == \
        before_back + SSD.KERNELS_PER_BACKWARD * cfg.n_layers
    assert ssm.plain_backward_scans == 0
    for path, g, w in zip(tree.leaves_with_paths(params), got, grads("cpu")):
        scale = float(w.abs().max())
        assert scale > 0, path[0]
        assert float((g - w).abs().max()) <= 1e-3 * scale, path[0]
    x = torch.zeros((1, 32, 2, 32), device=card, requires_grad=True)
    z = torch.zeros((1, 32, 2), device=card)
    bc = torch.zeros((1, 32, 32), device=card)
    with pytest.raises(RuntimeError, match="SSDScan"):
        SSD.ssd_scan(x, z, bc, bc, chunk=32)
