"""The decomposition and the arithmetic of the port's SSD scan kernel
(``src/repro_torch/kernels/csrc/ssd_scan.cu``), written out as plain torch
and held against the reference's Pallas kernel (interpret mode) and its
sequential oracle, on the same numpy inputs.

The kernel cannot run on the CPU, so this file mirrors what it does:
  - C Bᵀ once per (batch, sub-chunk of 32 positions), lower triangle, in
    f32, shared by every head;
  - one scan per P tile of 16 state rows, walking sub-chunks of 32 with the
    ragged tail zero-filled (a = 0, x = B = C = 0 past the end);
  - y_off as partial products over each warp's state columns (n-tiles
    w, w + 4, ... of 8), summed in warp order;
  - every state-sized product in TF32 with the error-compensated split
    a = a_hi + a_lo: a_lo b_hi + a_hi b_lo + a_hi b_hi, f32 accumulation,
    the products with bf16 B or C (exact in TF32) in two terms.
a_hi is a rounded to TF32 (the low 13 mantissa bits rounded away to
nearest, ties away from zero, as ``cvt.rna.tf32.f32`` rounds); a_lo is the
exact remainder, which the tensor cores read truncated to TF32.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs in parallel workers on few
# cores, and idle OpenMP threads spin and starve the other workers
torch.set_num_threads(1)
import jax.numpy as jnp  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels.ref import ssd_scan_ref as jax_ssd_scan_ref  # noqa: E402
from repro_torch.kernels.ref import ssd_scan_ref  # noqa: E402

TOL = dict(rtol=2e-4, atol=2e-4)    # the reference's kernel-vs-oracle sweep
Q, P_TILE, WARPS, N_TILE = 32, 16, 4, 8   # the kernel's constants

SHAPES = [                      # b, s, h, p, n, chunk
    (1, 32, 1, 8, 16, 8),       # the reference sweep (test_kernels.py)
    (2, 64, 3, 16, 32, 16),
    (2, 128, 2, 64, 128, 32),
    (1, 96, 4, 32, 64, 32),
    (1, 512, 3, 64, 128, 64),   # mamba2-130m head geometry, 16 sub-chunks
    (1, 200, 2, 24, 32, 200),   # ragged tail (6 x 32 + 8); p not a tile
    (1, 65, 2, 40, 32, 65),     # one position past a sub-chunk; p 16+16+8
]


def tf32(x):
    """x rounded to TF32 (10 mantissa bits), to nearest, ties away."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_truncated(x):
    """x with its 13 low mantissa bits dropped: how the tensor cores read
    a TF32 operand that carries more bits."""
    return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def split(x):
    """x = hi + lo as the kernel splits it: hi rounded to TF32, lo the
    exact remainder, which the MMA reads truncated to TF32."""
    hi = tf32(x)
    return hi, tf32_truncated(x - hi)


def mm3(a, b, a_exact=False, b_exact=False, plain=False):
    """a @ b as the kernel's TF32 products. ``*_exact``: that operand is a
    TF32 value (a widened bf16) and has no low half; ``plain``: one TF32
    product, no compensation (what the kernel must not do)."""
    ah, al = split(a)
    bh, bl = split(b)
    if plain:
        return ah @ bh
    out = torch.zeros(ah.shape[:-1] + bh.shape[-1:])
    if a_exact:
        assert torch.equal(ah, a)
    else:
        out = out + al @ bh
    if b_exact:
        assert torch.equal(bh, b)
    else:
        out = out + ah @ bl
    return out + ah @ bh


def _padded(t, s_pad, dim=1):
    pad = [0, 0] * (t.ndim - 1 - dim) + [0, s_pad - t.shape[dim]]
    return F.pad(t.float(), pad)


def cb_pass(B, C):
    """The first kernel: lower triangle of C Bᵀ per (batch, sub-chunk) in
    f32, (b, n_sub, Q, Q); rows past the end are 0. No head enters."""
    b, s, n = B.shape
    n_sub = -(-s // Q)
    Bp = _padded(B, n_sub * Q).reshape(b, n_sub, Q, n)
    Cp = _padded(C, n_sub * Q).reshape(b, n_sub, Q, n)
    return torch.tril(Cp @ Bp.transpose(-1, -2))


def warp_columns(n):
    """State columns of each warp: its n-tiles w, w + 4, ... of 8."""
    return [[8 * j + k for j in range(w, n // N_TILE, WARPS)
             for k in range(N_TILE)] for w in range(WARPS)]


def scan_tiles(xdt, a, B, C, h0=None, plain=False, record=None):
    """The second kernel, one P tile at a time over sub-chunks of Q.
    Returns (y (b, s, h, p), h_final (b, h, p, n)) in f32. ``record``: a
    list that receives each C Bᵀ tile as the scan reads it."""
    b, s, h, p = xdt.shape
    n = B.shape[-1]
    exact = B.dtype == torch.bfloat16
    n_sub = -(-s // Q)
    cb = cb_pass(B, C)
    x = _padded(xdt, n_sub * Q)                       # (b, S', h, p)
    al = _padded(a, n_sub * Q)                        # (b, S', h)
    Bp, Cp = _padded(B, n_sub * Q), _padded(C, n_sub * Q)
    y = torch.zeros((b, n_sub * Q, h, p))
    hf = torch.zeros((b, h, p, n))
    cols = warp_columns(n)
    tri = torch.ones(Q, Q, dtype=torch.bool).tril()
    for p0 in range(0, p, P_TILE):
        pt = slice(p0, min(p0 + P_TILE, p))
        state = torch.zeros((b, h, pt.stop - p0, n)) if h0 is None \
            else h0[:, :, pt].float().clone()
        for c in range(n_sub):
            rows = slice(c * Q, (c + 1) * Q)
            xc = x[:, rows, :, pt].permute(0, 2, 1, 3)    # (b, h, Q, pt)
            cum = torch.cumsum(al[:, rows].permute(0, 2, 1), -1)  # (b, h, Q)
            total = cum[..., -1:]
            Bc, Cc = Bp[:, None, rows], Cp[:, None, rows]  # (b, 1, Q, n)
            # 1. y_off: partials over each warp's columns, in warp order
            off = torch.zeros_like(xc)
            for wc in cols:
                if wc:
                    off = off + mm3(Cc[..., wc], state[..., wc].transpose(
                        -1, -2), a_exact=exact, plain=plain)
            # 2. state update with the entering state decayed
            xd = xc * torch.exp(total - cum)[..., None]
            state = state * torch.exp(total)[..., None] + mm3(
                xd.transpose(-1, -2), Bc, b_exact=exact, plain=plain)
            # 3. y_diag: G = (C Bᵀ) o L, exp only on the lower triangle
            tile = cb[:, None, c]                         # (b, 1, Q, Q)
            if record is not None:
                record.append(tile)
            diff = torch.where(tri, cum[..., :, None] - cum[..., None, :],
                               torch.zeros(()))
            G = torch.where(tri, tile * torch.exp(diff), torch.zeros(()))
            yd = mm3(G, xc, plain=plain)
            y[:, rows, :, pt] = (yd + torch.exp(cum)[..., None] * off
                                 ).permute(0, 2, 1, 3)
        hf[:, :, pt] = state
    return y[:, :s], hf


def _case(b, s, h, p, n, seed=0):
    """The reference sweep's inputs: x * 0.5, a = -|N(0,1)| * 0.3, B and C
    * 0.3 (numpy f32)."""
    rng = np.random.default_rng(seed)
    xdt = (rng.standard_normal((b, s, h, p)) * 0.5).astype(np.float32)
    a = (-np.abs(rng.standard_normal((b, s, h))) * 0.3).astype(np.float32)
    B = (rng.standard_normal((b, s, n)) * 0.3).astype(np.float32)
    C = (rng.standard_normal((b, s, n)) * 0.3).astype(np.float32)
    return xdt, a, B, C


def _inputs(case, bc_dtype):
    """(torch tensors, jax arrays) of one case, B and C in ``bc_dtype``
    in both (the same bf16 values widen to the same f32)."""
    xdt, a, B, C = case
    tB = torch.from_numpy(B).to(bc_dtype)
    tC = torch.from_numpy(C).to(bc_dtype)
    jdt = jnp.bfloat16 if bc_dtype == torch.bfloat16 else jnp.float32
    jB, jC = jnp.asarray(B, jdt), jnp.asarray(C, jdt)
    assert np.array_equal(tB.float().numpy(), np.asarray(jB, np.float32))
    return ((torch.from_numpy(xdt), torch.from_numpy(a), tB, tC),
            (jnp.asarray(xdt), jnp.asarray(a), jB, jC))


def _excess(got, want):
    """max of |got - want| - (atol + rtol |want|): <= 0 inside the limit."""
    want = np.asarray(want, np.float64)
    return float((np.abs(got.double().numpy() - want)
                  - TOL["atol"] - TOL["rtol"] * np.abs(want)).max())


@pytest.mark.parametrize("bc_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SHAPES)
def test_tiles_match_reference_kernel_and_oracle(shape, bc_dtype):
    b, s, h, p, n, chunk = shape
    t, j = _inputs(_case(b, s, h, p, n), bc_dtype)
    jy, jh = jops.ssd_scan(*j, chunk=chunk, interpret=True)
    ry, rh = jax_ssd_scan_ref(*j)
    y, hf = scan_tiles(*t)
    assert y.shape == (b, s, h, p) and hf.shape == (b, h, p, n)
    for want_y, want_h in ((jy, jh), (ry, rh)):
        np.testing.assert_allclose(y.numpy(), np.asarray(want_y), **TOL)
        np.testing.assert_allclose(hf.numpy(), np.asarray(want_h), **TOL)


@pytest.mark.parametrize("bc_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 48, 3, 16, 32), (1, 512, 2, 64, 128),
                                   (1, 200, 2, 40, 32)])
def test_tiles_with_initial_state_match_oracles(shape, bc_dtype):
    """h0 enters every P tile's state (the reference kernel takes none, so
    both sequential oracles judge)."""
    b, s, h, p, n = shape
    t, j = _inputs(_case(b, s, h, p, n, seed=3), bc_dtype)
    h0 = np.random.default_rng(4).standard_normal(
        (b, h, p, n)).astype(np.float32)
    ry, rh = jax_ssd_scan_ref(*j, h0=jnp.asarray(h0))
    ty, th = ssd_scan_ref(*t, h0=torch.from_numpy(h0))
    y, hf = scan_tiles(*t, h0=torch.from_numpy(h0))
    for want_y, want_h in ((ry, rh), (ty, th)):
        np.testing.assert_allclose(y.numpy(), np.asarray(want_y), **TOL)
        np.testing.assert_allclose(hf.numpy(), np.asarray(want_h), **TOL)


@pytest.mark.parametrize("bc_dtype", [torch.float32, torch.bfloat16])
def test_cb_pass_is_shared_by_the_heads(bc_dtype):
    """Every head reads the same C Bᵀ tile of its (batch, sub-chunk), the
    one the first pass formed from B and C alone; other heads' x and a do
    not move a head's outputs by one bit."""
    b, s, h, p, n = 2, 96, 3, 32, 64
    xdt, a, B, C = _inputs(_case(b, s, h, p, n, seed=7), bc_dtype)[0]
    tiles = []
    y, hf = scan_tiles(xdt, a, B, C, record=tiles)
    cb = cb_pass(B, C)
    n_sub = s // Q
    assert len(tiles) == n_sub * (p // P_TILE)
    for i, tile in enumerate(tiles):
        assert tile.shape == (b, 1, Q, Q)       # broadcast over the heads
        assert torch.equal(tile[:, 0], cb[:, i % n_sub])
    ref = torch.tril(C.float().reshape(b, n_sub, Q, n) @ B.float().reshape(
        b, n_sub, Q, n).transpose(-1, -2))
    torch.testing.assert_close(cb, ref, rtol=1e-6, atol=1e-6)
    for keep in range(h):
        others = [k for k in range(h) if k != keep]
        x2, a2 = xdt.clone(), a.clone()
        x2[:, :, others] = -2 * x2[:, :, others] + 1
        a2[:, :, others] = a2[:, :, others] * 3
        y2, hf2 = scan_tiles(x2, a2, B, C)
        assert torch.equal(y2[:, :, keep], y[:, :, keep])
        assert torch.equal(hf2[:, keep], hf[:, keep])


def test_plain_tf32_misses_the_tolerance_and_the_split_keeps_it():
    """At mamba2-130m's head geometry one TF32 product per multiply-add
    falls outside the reference's 2e-4 limit; the compensated split is
    inside it (the reason the kernel takes two or three MMAs each)."""
    t, _ = _inputs(_case(1, 512, 2, 64, 128, seed=11), torch.float32)
    ry, rh = ssd_scan_ref(*t)
    plain_y, _ = scan_tiles(*t, plain=True)
    split_y, split_h = scan_tiles(*t)
    assert _excess(plain_y, ry) > 0
    assert _excess(split_y, ry) <= 0 and _excess(split_h, rh) <= 0


def test_bf16_is_exact_in_tf32_and_the_rounding_is_to_nearest():
    """The premise of the two-MMA products: a widened bf16 has no bits
    below TF32's 10-bit mantissa. ``tf32`` rounds to nearest with ties away
    from zero, as ``cvt.rna`` does, and hi + lo keeps 21 bits."""
    v = torch.from_numpy(np.random.default_rng(5).standard_normal(
        4096).astype(np.float32)).to(torch.bfloat16).float()
    assert torch.equal(tf32(v), v)
    one = torch.tensor([1.0, -1.0])
    ulp = 2.0 ** -10
    assert torch.equal(tf32(one * (1 + ulp / 2)), one * (1 + ulp))
    assert torch.equal(tf32(one * (1 + ulp / 2 - 2.0 ** -20)), one)
    x = torch.from_numpy(np.random.default_rng(6).standard_normal(
        4096).astype(np.float32))
    hi, lo = split(x)
    assert float(((hi - x).abs() / x.abs()).max()) <= 2.0 ** -11
    assert float(((hi + lo - x).abs() / x.abs()).max()) <= 2.0 ** -21
