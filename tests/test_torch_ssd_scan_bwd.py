"""The backward of the ``ssd_scan`` kernel on the CPU: its plain version
``kernels/ref.py`` ``ssd_scan_backward_ref`` (the algorithm of
``csrc/ssd_scan_bwd.cu``: a state pass, then a reverse walk over
sub-chunks of 32 positions) against ``jax.vjp`` of the reference's
``ssm.ssd_chunked`` in f32 and against torch autograd of the port's
``ssd_chunked_plain`` in float64, with and without an initial state, zero
and non-zero gradients of the final state, sequences that are and are not
a multiple of the chunk, and P and N that the kernel's wrapper pads. Then
``SSDScan`` on CPU tensors (its backward takes that plain version and is
counted), the wrapper's padding, and what the wrapper refuses. On the card
chip_smoke.py phases 6 and 29 hold the kernel against the plain version."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs in parallel workers on few cores
torch.set_num_threads(1)
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import ssm as jssm  # noqa: E402
from repro_torch.kernels import ssd_scan as SSD  # noqa: E402
from repro_torch.kernels.ref import ssd_scan_backward_ref  # noqa: E402
from repro_torch.models import ssm  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)   # as test_torch_ssd_grad's jax.grad check


def _inputs(b, s, h, p, n, seed, dtype=np.float32):
    """The reference sweep's scales; gy and gh standard normal."""
    rng = np.random.default_rng(seed)
    f = lambda scale, *shape: (  # noqa: E731
        rng.standard_normal(shape) * scale).astype(dtype)
    return (f(0.5, b, s, h, p), (-np.abs(rng.standard_normal((b, s, h)))
                                 * 0.3).astype(dtype),
            f(0.3, b, s, n), f(0.3, b, s, n), f(0.3, b, h, p, n),
            f(1.0, b, s, h, p), f(1.0, b, h, p, n))


CASES = [   # b, s, h, p, n, chunk, h0, gh
    (2, 64, 3, 8, 16, 32, False, True),     # s a multiple of the chunk
    (2, 64, 3, 8, 16, 32, True, False),     # zero gh
    (2, 40, 2, 8, 16, 16, True, True),      # ragged: 40 = 2 x 16 + 8
    (1, 50, 2, 6, 10, 32, False, False),    # P, N padded by the wrapper
    (1, 96, 2, 5, 12, 96, True, True),      # one chunk, three sub-chunks
    (2, 33, 2, 18, 20, 33, True, False),
]


@pytest.mark.parametrize("b,s,h,p,n,chunk,with_h0,with_gh", CASES)
def test_backward_ref_matches_jax_vjp_of_reference(b, s, h, p, n, chunk,
                                                   with_h0, with_gh):
    xdt, a, B, C, h0, gy, gh = _inputs(b, s, h, p, n, seed=s + p)
    if not with_gh:
        gh = np.zeros_like(gh)
    ins = (xdt, a, B, C) + ((h0,) if with_h0 else ())

    def f(*args):
        return jssm.ssd_chunked(*args[:4], h0=args[4] if with_h0 else None,
                                chunk=chunk)

    want = jax.jit(lambda args, cot: jax.vjp(f, *args)[1](cot))(
        tuple(map(jnp.asarray, ins)), (jnp.asarray(gy), jnp.asarray(gh)))
    t = lambda x: torch.from_numpy(x)  # noqa: E731
    got = ssd_scan_backward_ref(t(xdt), t(a), t(B), t(C),
                                t(h0) if with_h0 else None, t(gy),
                                t(gh) if with_gh else None)
    assert (got[4] is None) == (not with_h0)
    for name, g, w in zip("dxdt da dB dC dh0".split(), got, want):
        assert g.dtype == torch.float32, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name,
                                   **TOL)


@pytest.mark.parametrize("b,s,h,p,n,chunk,with_h0,with_gh", CASES)
def test_backward_ref_matches_autograd_of_plain_chunked_float64(
        b, s, h, p, n, chunk, with_h0, with_gh):
    arrays = _inputs(b, s, h, p, n, seed=2 * s + n, dtype=np.float64)
    xdt, a, B, C, h0, gy, gh = map(torch.from_numpy, arrays)
    leaves = [t.clone().requires_grad_() for t in (xdt, a, B, C, h0)]
    y, hf = ssm.ssd_chunked_plain(*leaves[:4],
                                  leaves[4] if with_h0 else None, chunk)
    loss = (y * gy).sum() + ((hf * gh).sum() if with_gh else 0)
    wanted = leaves if with_h0 else leaves[:4]
    want = torch.autograd.grad(loss, wanted)
    got = ssd_scan_backward_ref(xdt, a, B, C, h0 if with_h0 else None, gy,
                                gh if with_gh else None)
    for name, g, w in zip("dxdt da dB dC dh0".split(), got, want):
        assert g.dtype == torch.float64, name
        torch.testing.assert_close(g, w, rtol=1e-10, atol=1e-10, msg=name)


@pytest.mark.parametrize("use_h", [True, False])
def test_function_backward_takes_the_plain_version_on_cpu(use_h):
    """SSDScan on CPU tensors: its backward is ``ssd_scan_backward_ref``
    on the saved inputs (the same bits), counted in plain_backward_scans;
    an unused final state passes no gradient (None = 0)."""
    xdt, a, B, C, h0, gy, gh = map(torch.from_numpy,
                                   _inputs(2, 48, 2, 4, 8, seed=5))
    leaves = [t.clone().requires_grad_() for t in (xdt, a, B, C, h0)]
    ssm.plain_scans = ssm.backward_scans = ssm.plain_backward_scans = 0
    y, hf = ssm.SSDScan.apply(*leaves, 16)
    ((y * gy).sum() + ((hf * gh).sum() if use_h else 0)).backward()
    assert ssm.plain_scans == ssm.backward_scans == 1
    assert ssm.plain_backward_scans == 1
    want = ssd_scan_backward_ref(xdt, a, B, C, h0, gy, gh if use_h else None)
    for name, leaf, w in zip("xdt a B C h0".split(), leaves, want):
        assert torch.equal(leaf.grad, w), name


@pytest.mark.parametrize("p,n", [(18, 20), (6, 10), (64, 128)])
def test_wrapper_padding_leaves_the_gradients_unchanged(p, n):
    """The kernel's operands as its wrapper pads them (P to a multiple of
    4, N of 8, with zero columns of x, gy, B, C, h0 and gh): the plain
    backward of the padded operands, cut back, equals that of the inputs."""
    xdt, a, B, C, h0, gy, gh = map(torch.from_numpy, _inputs(
        1, 40, 2, p, n, seed=p, dtype=np.float64))
    want = ssd_scan_backward_ref(xdt, a, B, C, h0, gy, gh)
    xk, ak, Bk, Ck, h0k = SSD.kernel_operands(xdt, a, B, C, h0)
    pk, nk = xk.shape[-1], Bk.shape[-1]
    assert pk % 4 == 0 and nk % 8 == 0
    gyk, ghk = SSD.backward_operands(gy, gh, pk, nk)
    assert gyk.shape[-1] == pk and ghk.shape[-2:] == (pk, nk)
    got = ssd_scan_backward_ref(xk, ak, Bk, Ck, h0k, gyk, ghk)
    cut = (got[0][..., :p], got[1], got[2][..., :n], got[3][..., :n],
           got[4][:, :, :p, :n])
    for name, g, w in zip("dxdt da dB dC dh0".split(), cut, want):
        torch.testing.assert_close(g, w, rtol=1e-12, atol=1e-12, msg=name)
    # the padded rows and columns get zero gradients
    assert not got[0][..., p:].any() and not got[4][:, :, p:].any()


def test_backward_wrapper_refuses_what_the_kernel_does_not_take():
    """As the forward's: N over 256, and any tensor that is not on one
    CUDA device (no fall back to the plain version)."""
    xdt, a, B, C, h0, gy, gh = map(torch.from_numpy,
                                   _inputs(1, 32, 2, 4, 8, seed=6))
    with pytest.raises(ValueError, match="CUDA device"):
        SSD.ssd_scan_backward(xdt, a, B, C, h0, gy, gh)
    wide = torch.zeros((1, 32, 264))
    with pytest.raises(ValueError, match="over 256"):
        SSD.ssd_scan_backward(xdt, a, wide, wide, None, gy, None)
