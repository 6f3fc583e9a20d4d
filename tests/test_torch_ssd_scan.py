"""The port's SSD scan against the reference's: ``ref.ssd_scan_ref`` and
``ops.ssd_scan`` on CPU tensors against the reference's Pallas kernel (in
interpret mode) and its sequential oracle, on the same numpy inputs; and the
kernel wrapper's input checks, which run before any build."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs in parallel workers on few
# cores, and idle OpenMP threads spin and starve the other workers
torch.set_num_threads(1)
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels.ref import ssd_scan_ref as jax_ssd_scan_ref  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ssd_scan as SSD  # noqa: E402
from repro_torch.kernels.ref import ssd_scan_ref  # noqa: E402

# the reference's own kernel-vs-oracle sweep tolerance (tests/test_kernels.py)
TOL = dict(rtol=2e-4, atol=2e-4)

SHAPES = [                      # b, s, h, p, n, chunk (test_kernels.py sweep)
    (1, 32, 1, 8, 16, 8),
    (2, 64, 3, 16, 32, 16),
    (2, 128, 2, 64, 128, 32),   # mamba2-130m head geometry
    (1, 96, 4, 32, 64, 32),
]


def _case(b, s, h, p, n, seed=0):
    """The reference sweep's inputs: x * 0.5, a = -|N(0,1)| * 0.3, B and C
    * 0.3 (numpy f32)."""
    rng = np.random.default_rng(seed)
    xdt = (rng.standard_normal((b, s, h, p)) * 0.5).astype(np.float32)
    a = (-np.abs(rng.standard_normal((b, s, h))) * 0.3).astype(np.float32)
    B = (rng.standard_normal((b, s, n)) * 0.3).astype(np.float32)
    C = (rng.standard_normal((b, s, n)) * 0.3).astype(np.float32)
    return xdt, a, B, C


def _torch(*arrays):
    return [torch.from_numpy(x) for x in arrays]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("port", ["ssd_scan_ref", "ops.ssd_scan"])
def test_scan_matches_reference_kernel_and_oracle(shape, port):
    b, s, h, p, n, chunk = shape
    case = _case(b, s, h, p, n)
    jy, jh = jops.ssd_scan(*map(jnp.asarray, case), chunk=chunk,
                           interpret=True)
    ry, rh = jax_ssd_scan_ref(*map(jnp.asarray, case))
    if port == "ssd_scan_ref":
        y, hf = ssd_scan_ref(*_torch(*case))
    else:
        before = SSD.launches
        y, hf = ops.ssd_scan(*_torch(*case), chunk=chunk)
        assert SSD.launches == before          # the CPU takes the plain path
    assert y.shape == (b, s, h, p) and y.dtype == torch.float32
    assert hf.shape == (b, h, p, n) and hf.dtype == torch.float32
    for want_y, want_h in ((jy, jh), (ry, rh)):
        np.testing.assert_allclose(y.numpy(), np.asarray(want_y), **TOL)
        np.testing.assert_allclose(hf.numpy(), np.asarray(want_h), **TOL)


def test_scan_with_initial_state_matches_reference_oracle():
    xdt, a, B, C = _case(2, 48, 3, 16, 32, seed=3)
    h0 = np.random.default_rng(4).standard_normal(
        (2, 3, 16, 32)).astype(np.float32)
    ry, rh = jax_ssd_scan_ref(*map(jnp.asarray, (xdt, a, B, C)),
                              h0=jnp.asarray(h0))
    for fn in (ssd_scan_ref, lambda *t, h0: ops.ssd_scan(*t, chunk=16,
                                                         h0=h0)):
        y, hf = fn(*_torch(xdt, a, B, C), h0=torch.from_numpy(h0))
        np.testing.assert_allclose(y.numpy(), np.asarray(ry), **TOL)
        np.testing.assert_allclose(hf.numpy(), np.asarray(rh), **TOL)


def test_scan_with_bf16_projections_matches_reference_oracle():
    """B and C in bf16 (the full-width model's dtype), widened to f32 in
    both packages: the same bf16 values give the same f32 scan."""
    xdt, a, B, C = _case(2, 64, 2, 64, 128, seed=5)
    jB, jC = jnp.asarray(B, jnp.bfloat16), jnp.asarray(C, jnp.bfloat16)
    ry, rh = jax_ssd_scan_ref(jnp.asarray(xdt), jnp.asarray(a), jB, jC)
    tB = torch.from_numpy(B).to(torch.bfloat16)
    tC = torch.from_numpy(C).to(torch.bfloat16)
    assert np.array_equal(tB.float().numpy(), np.asarray(jB, np.float32))
    y, hf = ops.ssd_scan(torch.from_numpy(xdt), torch.from_numpy(a), tB, tC,
                         chunk=32)
    np.testing.assert_allclose(y.numpy(), np.asarray(ry), **TOL)
    np.testing.assert_allclose(hf.numpy(), np.asarray(rh), **TOL)


def test_chunk_contract_is_checked():
    t = _torch(*_case(1, 48, 1, 8, 16))
    with pytest.raises(ValueError, match="multiple of chunk"):
        ops.ssd_scan(*t, chunk=32)
    with pytest.raises(ValueError, match="multiple of chunk"):
        SSD.ssd_scan(*t, chunk=32)


@pytest.mark.parametrize("bad", ["x_dtype", "bc_dtype", "bc_mixed", "shape",
                                 "h0", "device", "state_dim"])
def test_kernel_wrapper_rejects_what_the_kernel_does_not_take(bad):
    """Checked before any build: no CUDA tensor, no library needed."""
    xdt, a, B, C = _torch(*_case(1, 32, 2, 8, 16))
    h0 = None
    err = ValueError
    if bad == "x_dtype":
        xdt, err = xdt.double(), TypeError
    elif bad == "bc_dtype":
        B, C, err = B.half(), C.half(), TypeError
    elif bad == "bc_mixed":
        B, err = B.to(torch.bfloat16), TypeError
    elif bad == "shape":
        a = a[:, :, :1]
    elif bad == "h0":
        h0 = torch.zeros(1, 2, 8, 8)
    elif bad == "state_dim":            # over the register-held state's 256
        B, C = (torch.zeros(1, 32, SSD.MAX_STATE + 8) for _ in range(2))
    before = SSD.launches
    with pytest.raises(err):
        SSD.ssd_scan(xdt, a, B, C, chunk=32, h0=h0)
    assert SSD.launches == before


def _aligned16(t):
    es = t.element_size()
    return (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and all(st * es % 16 == 0 for st in t.stride()[:-1]))


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("bc_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("p,n,row_pad", [
    (16, 32, 8),     # already the kernels' form: nothing copied
    (16, 32, 5),     # unaligned B/C rows: copied
    (18, 20, 0),     # P and N padded with zeros
    (6, 13, 3),
])
def test_kernel_operands_pad_and_align_without_changing_the_scan(
        p, n, row_pad, bc_dtype, with_h0):
    """The operands the wrapper hands the kernels: P a multiple of 4, N of
    8, every x, B and C row on 16 bytes; the zero padding leaves y and the
    live state as they were (the scan of the padded operands, cut back,
    equals the scan of the given ones)."""
    b, s, h = 2, 40, 3
    rng = np.random.default_rng(1)
    xdt, a, _, _ = _torch(*_case(b, s, h, p, n, seed=2))
    bc = torch.from_numpy((rng.standard_normal((b, s, 2 * n + row_pad))
                           * 0.3).astype(np.float32)).to(bc_dtype)
    B, C = bc[..., :n], bc[..., n:2 * n]
    h0 = (torch.from_numpy(rng.standard_normal((b, h, p, n))
                           .astype(np.float32)) if with_h0 else None)
    xk, ak, Bk, Ck, h0k = SSD.kernel_operands(xdt, a, B, C, h0)
    pk, nk = -(-p // 4) * 4, -(-n // 8) * 8
    assert xk.shape == (b, s, h, pk) and Bk.shape == Ck.shape == (b, s, nk)
    assert all(_aligned16(t) for t in (xk, Bk, Ck))
    assert xk.is_contiguous() and ak.is_contiguous()
    if (pk, nk, row_pad) == (p, n, 8):
        assert Bk.data_ptr() == B.data_ptr() and Ck.data_ptr() == C.data_ptr()
    if with_h0:
        assert h0k.shape == (b, h, pk, nk) and h0k.is_contiguous()
        assert torch.equal(h0k[:, :, :p, :n], h0)
    want_y, want_h = ssd_scan_ref(xdt, a, B, C, h0)
    got_y, got_h = ssd_scan_ref(xk, ak, Bk, Ck, h0k)
    torch.testing.assert_close(got_y[..., :p], want_y, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(got_h[:, :, :p, :n], want_h, rtol=1e-6,
                               atol=1e-6)
    assert not got_y[..., p:].any() and not got_h[:, :, p:].any()
    assert not got_h[..., n:].any()
