"""The gradient through the ``ssd_scan`` kernel: ``models.ssm.SSDScan``,
whose forward is the kernel and whose backward the backward kernel (on a
CPU tensor their plain versions, through ``ops.ssd_scan`` and
``ops.ssd_scan_backward``). Called directly on CPU tensors: its outputs
against the plain forms, ``torch.autograd.gradcheck`` in float64, and its
gradients against ``jax.grad`` through the reference's
``ssm.ssd_chunked`` (with and without an initial state). The raw kernel
wrapper refuses an input that requires grad; on the card, chip_smoke.py's
"train mamba2-130m" phase holds the kernel's gradients against the plain
path's."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs in parallel workers on few cores
torch.set_num_threads(1)
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import ssm as jssm  # noqa: E402
from repro_torch.kernels import ssd_scan as SSD  # noqa: E402
from repro_torch.models import ssm  # noqa: E402


def _inputs(b, s, h, p, n, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    xdt = (rng.standard_normal((b, s, h, p)) * 0.5).astype(dtype)
    a = (-np.abs(rng.standard_normal((b, s, h))) * 0.3).astype(dtype)
    B = (rng.standard_normal((b, s, n)) * 0.3).astype(dtype)
    C = (rng.standard_normal((b, s, n)) * 0.3).astype(dtype)
    h0 = (rng.standard_normal((b, h, p, n)) * 0.3).astype(dtype)
    wy = rng.standard_normal((b, s, h, p)).astype(dtype)
    wh = rng.standard_normal((b, h, p, n)).astype(dtype)
    return (xdt, a, B, C, h0), (wy, wh)


def _leaves(arrays, grad=True):
    return [torch.from_numpy(x).requires_grad_(grad) for x in arrays]


@pytest.mark.parametrize("with_h0", [False, True])
def test_function_forward_is_the_plain_scan_on_cpu(with_h0):
    (xdt, a, B, C, h0), _ = _inputs(2, 32, 3, 8, 16, seed=0)
    t = _leaves((xdt, a, B, C, h0), grad=False)
    h0_t = t[4] if with_h0 else None
    ssm.plain_scans = 0
    y, hf = ssm.SSDScan.apply(*t[:4], h0_t, 16)
    assert ssm.plain_scans == 1            # ops' plain version
    ry, rh = ssm.ssd_chunked_plain(*t[:4], h0_t, chunk=16)
    torch.testing.assert_close(y, ry, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(hf, rh, rtol=1e-5, atol=1e-5)


def test_gradcheck_float64():
    (xdt, a, B, C, h0), _ = _inputs(1, 8, 2, 3, 4, seed=1, dtype=np.float64)
    args = _leaves((xdt, a, B, C, h0))
    ssm.plain_backward_scans = 0
    assert torch.autograd.gradcheck(
        lambda *t: ssm.SSDScan.apply(*t, 4), args, eps=1e-6, atol=1e-6)
    assert torch.autograd.gradcheck(
        lambda *t: ssm.SSDScan.apply(*t, None, 8), args[:4], eps=1e-6,
        atol=1e-6)
    assert ssm.plain_backward_scans > 0     # the backward's plain version


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("s,chunk", [(64, 32), (32, 32)])
def test_gradients_match_jax_grad_of_reference(s, chunk, with_h0):
    """d/d(xdt, a, B, C[, h0]) of sum(y * wy) + sum(h * wh): the Function's
    backward against jax.grad through the reference's ssd_chunked."""
    (xdt, a, B, C, h0), (wy, wh) = _inputs(2, s, 3, 8, 16, seed=s + chunk)
    ins = (xdt, a, B, C) + ((h0,) if with_h0 else ())

    def jloss(*args):
        y, hf = jssm.ssd_chunked(*args[:4], h0=args[4] if with_h0 else None,
                                 chunk=chunk)
        return jnp.sum(y * wy) + jnp.sum(hf * wh)

    want = jax.grad(jloss, argnums=tuple(range(len(ins))))(
        *map(jnp.asarray, ins))
    t = _leaves(ins)
    ssm.plain_scans = ssm.backward_scans = 0
    y, hf = ssm.SSDScan.apply(*t[:4], t[4] if with_h0 else None, chunk)
    ((y * torch.from_numpy(wy)).sum() + (hf * torch.from_numpy(wh)).sum()
     ).backward()
    # one forward (ops' plain version on the CPU), one backward pass
    assert ssm.plain_scans == 1 and ssm.backward_scans == 1
    for name, leaf, w in zip("xdt a B C h0".split(), t, want):
        assert leaf.grad.dtype == torch.float32, name
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(w),
                                   rtol=1e-5, atol=1e-5, err_msg=name)


def test_gradients_only_for_inputs_that_need_them_in_their_dtype():
    """bf16 B and C get bf16 gradients; an input that needs none gets
    None; the gradients equal plain autograd through the chunked form."""
    (xdt, a, B, C, _), (wy, wh) = _inputs(1, 32, 2, 4, 8, seed=3)
    x = torch.from_numpy(xdt).requires_grad_()
    at = torch.from_numpy(a)
    Bt = torch.from_numpy(B).bfloat16().requires_grad_()
    Ct = torch.from_numpy(C).bfloat16().requires_grad_()
    y, hf = ssm.SSDScan.apply(x, at, Bt, Ct, None, 32)
    ((y * torch.from_numpy(wy)).sum() + (hf * torch.from_numpy(wh)).sum()
     ).backward()
    assert at.grad is None
    assert Bt.grad.dtype == Ct.grad.dtype == torch.bfloat16
    x2, B2, C2 = (t.detach().clone().requires_grad_() for t in (x, Bt, Ct))
    y2, h2 = ssm.ssd_chunked_plain(x2, at, B2, C2, None, chunk=32)
    ((y2 * torch.from_numpy(wy)).sum() + (h2 * torch.from_numpy(wh)).sum()
     ).backward()
    for got, want in ((x.grad, x2.grad), (Bt.grad, B2.grad),
                      (Ct.grad, C2.grad)):
        torch.testing.assert_close(got, want)


def test_raw_kernel_wrapper_refuses_inputs_that_require_grad():
    """The kernel's outputs have no autograd history, so its raw wrapper
    raises (before any device check) rather than drop the gradient; under
    no_grad the same inputs pass that check (and then need the card)."""
    (xdt, a, B, C, _), _ = _inputs(1, 32, 2, 4, 8, seed=4)
    t = _leaves((xdt, a, B, C))
    with pytest.raises(RuntimeError, match="SSDScan"):
        SSD.ssd_scan(*t, chunk=32)
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA device"):
        SSD.ssd_scan(*t, chunk=32)


def test_model_gradient_through_the_cpu_path_is_plain_autograd():
    """On the CPU ``ssd_chunked`` runs the plain form (no Function), so a
    Mamba-2 block's gradient reaches in_proj, conv_w, conv_b, dt_bias and
    A_log there too."""
    from repro_torch.configs import get_config
    import dataclasses
    cfg = dataclasses.replace(get_config("mamba2-130m").reduced(),
                              dtype="float32")
    p = ssm.init_layer(torch.Generator().manual_seed(0), cfg,
                       torch.float32, device="cpu")
    for v in p.values():
        v.requires_grad_()
    x = torch.randn((2, 40, cfg.d_model), generator=torch.Generator()
                    .manual_seed(1))
    out, _, _ = ssm.ssd_block(cfg, p, x)
    out.square().sum().backward()
    for name in ("in_proj", "conv_w", "conv_b", "dt_bias", "A_log", "D"):
        assert p[name].grad is not None and p[name].grad.abs().sum() > 0, \
            name
