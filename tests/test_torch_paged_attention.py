"""Paged attention in the PyTorch port: its plain version against the
reference's oracle and the reference's Pallas kernel (interpret mode), the
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
from repro.kernels.ref import paged_attention_ref as jax_ref  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import paged_attention as PA  # noqa: E402
from repro_torch.kernels.ref import paged_attention_ref  # noqa: E402

TOL = {"float32": 1e-5, "bfloat16": 3e-2}


def _case(b, h, kheads, d, page, pps, seed=0):
    """numpy inputs: ragged lengths, window starts below each length, and
    sequence 0 ending inside its first page so its later pages are fully
    masked (page 0 of the last sequence is fully below its start when the
    length allows)."""
    rng = np.random.default_rng(seed)
    P = pps * b + 3                       # physical pool > logical need
    q = rng.standard_normal((b, h, d)).astype(np.float32)
    kp = rng.standard_normal((kheads, P, page, d)).astype(np.float32)
    vp = rng.standard_normal((kheads, P, page, d)).astype(np.float32)
    tables = rng.permutation(P)[: b * pps].reshape(b, pps).astype(np.int32)
    lengths = rng.integers(1, pps * page + 1, b).astype(np.int32)
    lengths[0] = min(lengths[0], page - 1) or 1
    lengths[-1] = pps * page
    starts = rng.integers(0, lengths).astype(np.int32)
    starts[-1] = page + 1 if pps > 1 else starts[-1]
    return q, kp, vp, tables, lengths, starts


def _jax(dtype, *arrs):
    return [jnp.asarray(a, dtype) if a.dtype == np.float32 else jnp.asarray(a)
            for a in arrs]


def _torch(dtype, *arrs):
    return [torch.from_numpy(a).to(dtype) if a.dtype == np.float32
            else torch.from_numpy(a) for a in arrs]


@pytest.mark.parametrize("b,h,kheads,d,page,pps", [
    (1, 4, 4, 64, 16, 2),      # MHA
    (2, 8, 2, 64, 16, 4),      # GQA 4:1
    (3, 8, 1, 128, 16, 3),     # MQA
    (2, 16, 8, 128, 32, 2),    # bigger page
    (4, 4, 2, 256, 16, 5),     # rg-style head_dim 256
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_version_matches_reference(b, h, kheads, d, page, pps, dtype):
    """Ragged lengths, with and without window starts, a fully masked
    page: the port's plain version agrees with the reference oracle AND the
    reference Pallas kernel within the reference's own tolerance."""
    q, kp, vp, bt, ln, st = _case(b, h, kheads, d, page, pps)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    tol = TOL[dtype]
    for starts in (None, st):
        extra = () if starts is None else (starts,)
        jq, jk, jv, jbt, jln, *jst = _jax(jdt, q, kp, vp, bt, ln, *extra)
        tq, tk, tv, tbt, tln, *tst = _torch(tdt, q, kp, vp, bt, ln, *extra)
        got = paged_attention_ref(tq, tk, tv, tbt, tln, *tst)
        assert got.dtype == tdt and got.shape == (b, h, d)
        got = got.float().numpy()
        for want in (jax_ref(jq, jk, jv, jbt, jln, *jst),
                     jops.paged_attention(jq, jk, jv, jbt, jln, *jst,
                                          interpret=True)):
            np.testing.assert_allclose(got, np.asarray(want, np.float32),
                                       rtol=tol, atol=tol)


def test_ops_dispatches_cpu_tensors_to_plain_version():
    q, kp, vp, bt, ln, st = _case(2, 8, 2, 64, 8, 3, seed=1)
    args = _torch(torch.float32, q, kp, vp, bt, ln, st)
    before = PA.launches
    np.testing.assert_array_equal(ops.paged_attention(*args).numpy(),
                                  paged_attention_ref(*args).numpy())
    assert PA.launches == before          # the CUDA wrapper never ran


def test_non_cpu_tensor_raises_without_library(monkeypatch):
    """A tensor that is not on the CPU goes to the CUDA wrapper; when the
    library cannot be loaded the call raises — the plain version is never
    taken as a fallback."""
    def absent():
        raise RuntimeError("kernel library absent")

    def forbidden(*a, **k):
        raise AssertionError("fell back to the plain version")

    monkeypatch.setattr(PA, "_library", absent)
    monkeypatch.setattr(ops.ref, "paged_attention_ref", forbidden)
    b, h, kheads, d, page, pps = 2, 8, 2, 64, 8, 3
    meta = dict(device="meta")
    args = (torch.empty((b, h, d), **meta),
            torch.empty((kheads, 9, page, d), **meta),
            torch.empty((kheads, 9, page, d), **meta),
            torch.empty((b, pps), dtype=torch.int32, **meta),
            torch.empty((b,), dtype=torch.int32, **meta))
    with pytest.raises(RuntimeError, match="library absent"):
        ops.paged_attention(*args)


@pytest.mark.parametrize("bad,err", [
    ("dtype", TypeError), ("mixed", TypeError), ("shape", ValueError),
    ("ints", TypeError), ("strided", ValueError)])
def test_wrapper_rejects_inputs_the_kernel_does_not_take(bad, err):
    q, kp, vp, bt, ln, _ = _case(2, 8, 2, 64, 8, 3)
    q, kp, vp, bt, ln = _torch(torch.float32, q, kp, vp, bt, ln)
    if bad == "dtype":
        q, kp, vp = q.half(), kp.half(), vp.half()
    elif bad == "mixed":
        kp = kp.bfloat16()
    elif bad == "shape":
        q = q[:, :, :32].contiguous()
    elif bad == "ints":
        ln = ln.long()
    elif bad == "strided":
        kp = kp.transpose(2, 3).contiguous().transpose(2, 3)
    with pytest.raises(err):
        PA.paged_attention(q, kp, vp, bt, ln)

