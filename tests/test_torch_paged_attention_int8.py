"""Int8 paged attention in the PyTorch port: ``quantize_pages`` /
``dequantize_pages`` bit for bit against the reference's, the plain version
against the reference's oracle and its Pallas kernel (interpret mode), the
dispatch rule (CPU tensor -> plain version; anything else -> the CUDA kernel
or an error, never a fallback), and the wrapper's input checks. The CUDA
kernel itself is held against the plain version in test_torch_gpu.py."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs in parallel workers on few
# cores, and idle OpenMP threads spin and starve the other workers
torch.set_num_threads(1)
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import paged_attention_int8 as JPA8  # noqa: E402
from repro.kernels.ref import paged_attention_int8_ref as jax_ref  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import paged_attention_int8 as PA8  # noqa: E402
from repro_torch.kernels.ref import paged_attention_int8_ref  # noqa: E402

# the reference's own tolerance for the int8 kernel against its oracle
# (tests/test_kernels.py): both sides dequantize the same int8 bytes with
# the same scales exactly, so only the f32 summation order differs
TOL = 2e-5


def _bits(scales) -> np.ndarray:
    """bf16 scales -> their 16-bit patterns (torch or JAX)."""
    if isinstance(scales, torch.Tensor):
        return scales.view(torch.int16).numpy().view(np.uint16)
    return np.array(scales).view(np.uint16)


def _rows(seed=0):
    """f32 rows over many magnitudes, one all-zero row, and rows whose
    quotients land exactly on .5 rounding boundaries (amax 127 -> scale 1;
    amax 254 -> scale 2 with odd integers)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((3, 11, 8, 64)).astype(np.float32)
    x *= (10.0 ** rng.uniform(-20, 20, (3, 11, 8, 1))).astype(np.float32)
    x[0, 0, 0] = 0.0
    x[0, 0, 1] = 0.0
    x[0, 0, 1, :8] = [127, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5]
    x[0, 0, 2] = np.linspace(-254, 254, 64, dtype=np.float32)
    x[0, 0, 2, :8] = [1, 3, 5, 7, -1, -3, -5, 253]
    return x


def test_quantize_pages_bit_exact_against_reference():
    x = _rows()
    tq, ts = PA8.quantize_pages(torch.from_numpy(x))
    jq, js = JPA8.quantize_pages(jnp.asarray(x))
    assert tq.dtype == torch.int8 and ts.dtype == PA8.SCALE_DTYPE
    assert ts.shape == x.shape[:-1] + (1,)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(_bits(ts), _bits(js))
    # the all-zero row: scale 1 and exact zeros back
    assert float(ts[0, 0, 0]) == 1.0 and not tq[0, 0, 0].any()
    # half to even on the boundaries, as jnp.round
    assert tq[0, 0, 1, :8].tolist() == [127, 0, 2, 2, 0, -2, -2, 126]
    assert tq[0, 0, 2, :8].tolist() == [0, 2, 2, 4, 0, -2, -2, 126]
    td = PA8.dequantize_pages(tq, ts)
    jd = JPA8.dequantize_pages(jq, js)
    assert td.dtype == torch.float32
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    assert not td[0, 0, 0].any()


def test_quantize_pages_bit_exact_from_bf16_rows():
    """The decode step quantizes bf16 K/V rows: same bits from bf16 input."""
    x = _rows(seed=1)
    tq, ts = PA8.quantize_pages(torch.from_numpy(x).bfloat16())
    jq, js = JPA8.quantize_pages(jnp.asarray(x, jnp.bfloat16))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(_bits(ts), _bits(js))


def _case(b, h, kheads, d, page, pps, seed=0):
    """numpy inputs as the reference's _paged_case draws them (ragged
    lengths), quantized by the reference so both sides read one payload."""
    rng = np.random.default_rng(seed)
    P = pps * b + 3                       # physical pool > logical need
    q = rng.standard_normal((b, h, d)).astype(np.float32)
    kp = rng.standard_normal((kheads, P, page, d)).astype(np.float32)
    vp = rng.standard_normal((kheads, P, page, d)).astype(np.float32)
    tables = rng.permutation(P)[: b * pps].reshape(b, pps).astype(np.int32)
    lengths = rng.integers(1, pps * page + 1, b).astype(np.int32)
    kq, ks = JPA8.quantize_pages(jnp.asarray(kp))
    vq, vs = JPA8.quantize_pages(jnp.asarray(vp))
    return q, kq, ks, vq, vs, tables, lengths


def _both(q, kq, ks, vq, vs, tables, lengths, *extra):
    """The same arrays as JAX and as torch tensors."""
    jargs = [jnp.asarray(q), kq, ks, vq, vs, jnp.asarray(tables),
             jnp.asarray(lengths)] + [jnp.asarray(e) for e in extra]
    targs = [torch.from_numpy(q), torch.from_numpy(np.array(kq)),
             torch.from_numpy(_bits(ks).view(np.int16)).view(torch.bfloat16),
             torch.from_numpy(np.array(vq)),
             torch.from_numpy(_bits(vs).view(np.int16)).view(torch.bfloat16),
             torch.from_numpy(tables), torch.from_numpy(lengths)] + \
        [torch.from_numpy(e) for e in extra]
    return jargs, targs


@pytest.mark.parametrize("b,h,kheads,d,page,pps", [
    (2, 8, 2, 64, 16, 3),
    (1, 4, 1, 128, 16, 2),
    (3, 16, 8, 128, 32, 2),
    (4, 4, 2, 64, 8, 5),       # reduced test config (page 8, D 64)
])
def test_plain_version_matches_reference(b, h, kheads, d, page, pps):
    """The reference's int8 sweep: the port's plain version agrees with the
    reference oracle AND the reference Pallas kernel (interpret mode)."""
    jargs, targs = _both(*_case(b, h, kheads, d, page, pps))
    got = paged_attention_int8_ref(*targs)
    assert got.dtype == torch.float32 and got.shape == (b, h, d)
    for want in (jax_ref(*jargs),
                 jops.paged_attention_int8(*jargs, interpret=True)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=TOL, atol=TOL)


def test_plain_version_bf16_q_matches_reference():
    """bf16 q: the output comes back in bf16, within the reference's bf16
    kernel tolerance of its oracle (3e-2)."""
    q, kq, ks, vq, vs, bt, ln = _case(2, 8, 2, 64, 16, 3, seed=4)
    jargs, targs = _both(q, kq, ks, vq, vs, bt, ln)
    jargs[0] = jargs[0].astype(jnp.bfloat16)
    targs[0] = targs[0].bfloat16()
    got = paged_attention_int8_ref(*targs)
    assert got.dtype == torch.bfloat16
    want = jops.paged_attention_int8(*jargs, interpret=True)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=3e-2, atol=3e-2)


def test_fully_masked_page_case_matches_reference():
    """The reference's regression case: window starts leave whole pages
    masked (sequence 0's page 0, sequence 2's pages 0-1). The port agrees
    with the reference kernel, and below-start tokens poisoned to 127 leave
    its output unchanged bit for bit."""
    page = 16
    q, kq, ks, vq, vs, bt, _ = _case(3, 4, 2, 64, page, 3)
    ln = np.array([40, 7, 44], np.int32)
    st = np.array([18, 0, 33], np.int32)
    jargs, targs = _both(q, kq, ks, vq, vs, bt, ln, st)
    clean = paged_attention_int8_ref(*targs)
    np.testing.assert_allclose(
        clean.numpy(),
        np.asarray(jops.paged_attention_int8(*jargs, interpret=True)),
        rtol=TOL, atol=TOL)
    kq2, vq2 = targs[1].clone(), targs[3].clone()
    for i, s in enumerate(st):
        for t in range(s):
            kq2[:, bt[i, t // page], t % page] = 127
            vq2[:, bt[i, t // page], t % page] = 127
    poisoned = paged_attention_int8_ref(targs[0], kq2, targs[2], vq2,
                                        *targs[4:])
    np.testing.assert_array_equal(poisoned.numpy(), clean.numpy())


def test_starts_none_equals_zeros():
    q, kq, ks, vq, vs, bt, ln = _case(2, 4, 2, 64, 16, 3, seed=2)
    _, targs = _both(q, kq, ks, vq, vs, bt, ln)
    none = paged_attention_int8_ref(*targs)
    zeros = paged_attention_int8_ref(*targs, torch.zeros_like(targs[6]))
    np.testing.assert_array_equal(none.numpy(), zeros.numpy())


def test_ops_dispatches_cpu_tensors_to_plain_version():
    _, targs = _both(*_case(2, 8, 2, 64, 8, 3, seed=1))
    before = PA8.launches
    np.testing.assert_array_equal(
        ops.paged_attention_int8(*targs).numpy(),
        paged_attention_int8_ref(*targs).numpy())
    assert PA8.launches == before          # the CUDA wrapper never ran


def _meta_args(b=2, h=8, kheads=2, d=64, page=8, pps=3, n_phys=9):
    meta = dict(device="meta")
    pages = (kheads, n_phys, page, d)
    scales = (kheads, n_phys, page, 1)
    return [torch.empty((b, h, d), **meta),
            torch.empty(pages, dtype=torch.int8, **meta),
            torch.empty(scales, dtype=torch.bfloat16, **meta),
            torch.empty(pages, dtype=torch.int8, **meta),
            torch.empty(scales, dtype=torch.bfloat16, **meta),
            torch.empty((b, pps), dtype=torch.int32, **meta),
            torch.empty((b,), dtype=torch.int32, **meta)]


def test_non_cpu_tensor_raises_without_library(monkeypatch):
    """A tensor that is not on the CPU goes to the CUDA wrapper; when the
    library cannot be loaded the call raises — the plain version is never
    taken as a fallback."""
    def absent():
        raise RuntimeError("kernel library absent")

    def forbidden(*a, **k):
        raise AssertionError("fell back to the plain version")

    monkeypatch.setattr(PA8, "_library", absent)
    monkeypatch.setattr(ops.ref, "paged_attention_int8_ref", forbidden)
    with pytest.raises(RuntimeError, match="library absent"):
        ops.paged_attention_int8(*_meta_args())


@pytest.mark.parametrize("bad,err", [
    ("q_dtype", TypeError), ("pages_dtype", TypeError),
    ("scale_dtype", TypeError), ("scale_shape", ValueError),
    ("head_dim", ValueError), ("ints", TypeError), ("strided", ValueError)])
def test_wrapper_rejects_inputs_the_kernel_does_not_take(bad, err):
    args = _meta_args()
    if bad == "head_dim":
        args = _meta_args(d=40)
    elif bad == "q_dtype":
        args[0] = args[0].half()
    elif bad == "pages_dtype":
        args[1] = args[1].to(torch.uint8)
    elif bad == "scale_dtype":
        args[2] = args[2].float()
    elif bad == "scale_shape":
        args[4] = torch.empty(args[4].shape[:-1] + (2,),
                              dtype=torch.bfloat16, device="meta")
    elif bad == "ints":
        args[6] = args[6].long()
    elif bad == "strided":
        args[3] = args[3].transpose(2, 3).contiguous().transpose(2, 3)
    with pytest.raises(err):
        PA8.paged_attention_int8(*args)
