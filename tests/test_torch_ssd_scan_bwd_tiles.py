"""The decomposition and the arithmetic of the port's SSD scan backward
kernels (``src/repro_torch/kernels/csrc/ssd_scan_bwd.cu``), written out as
plain torch and held against ``jax.vjp`` of the reference's
``ssm.ssd_chunked`` and against the port's plain version
``ssd_scan_backward_ref`` in float64, on the same numpy inputs.

The kernels cannot run on the CPU, so this file mirrors what they do:
  - C Bᵀ once per (batch, sub-chunk of 32 positions), lower triangle, in
    f32, shared by every head (kernel 1);
  - one walk per P tile of 16 state rows (kernel 2): a state pass that
    keeps each sub-chunk's entering state S_in, then a reverse walk that
    keeps each leaving gradient dS_out and forms y_off = C S_inᵀ and
    dx_off = B dS_outᵀ as partials over each warp's state columns (n-tiles
    w, w + 4, ... of 8) summed in warp order, dS_in = dS_out exp(total) +
    (gy o exp(cum))ᵀ C, y_diag = G x and dx_diag = Gᵀ gy with
    G = (C Bᵀ) o L; the decays' gy . y comes from C S_inᵀ and G x, so no
    per-head dC exists; the dcum partial of each P tile;
  - dB and dC as the stacked Q x hP x N products [diag(e_h) x_h] dS_out
    and [diag(exp cum_h) gy_h] S_in, cut into G head groups (heads r,
    r + G, ...; one block of a cluster each): each group sums its chunks
    (head, 32 state rows) in order, each chunk's product added to the
    group's sum, beside its part of sum_h M_h (each chunk's gy xᵀ masked
    by its head's L); the groups' parts are summed in rank order, and M is
    applied last as Mᵀ C and M B; da as the P tiles' dcum summed in order,
    then reverse-summed in the sub-chunk (kernel 3);
  - every product in TF32 with the error-compensated split
    a = a_hi + a_lo: a_lo b_hi + a_hi b_lo + a_hi b_hi, f32 accumulation,
    the products with a factor of bf16 B or C (exact in TF32) in two terms.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs in parallel workers on few cores
torch.set_num_threads(1)
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro.models import ssm as jssm  # noqa: E402
from repro_torch.kernels import ssd_scan as SSD  # noqa: E402
from repro_torch.kernels.ref import ssd_scan_backward_ref  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)   # as test_torch_ssd_scan_bwd's vjp check
Q, P_TILE, WARPS, N_TILE = 32, 16, 4, 8     # the walk's constants
K_CHUNK = 32                                # kernel 3's state rows a chunk
NAMES = "dxdt da dB dC dh0".split()


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
    """a @ b as the kernels' TF32 products. ``*_exact``: that operand is a
    TF32 value (a widened bf16) and has no low half, so the product takes
    two terms; ``plain``: one TF32 product, no compensation."""
    ah, al = split(a.float())
    bh, bl = split(b.float())
    if plain:
        return ah @ bh
    out = torch.zeros(torch.broadcast_shapes(ah.shape[:-2], bh.shape[:-2])
                      + (ah.shape[-2], bh.shape[-1]))
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


def warp_columns(n):
    """State columns of each warp: its n-tiles w, w + 4, ... of 8."""
    return [[8 * j + k for j in range(w, n // N_TILE, WARPS)
             for k in range(N_TILE)] for w in range(WARPS)]


def cb_pass(B, C):
    """Kernel 1: lower triangle of C Bᵀ per (batch, sub-chunk) in f32,
    (b, n_sub, Q, Q); rows past the end are 0. No head enters."""
    b, s, n = B.shape
    n_sub = -(-s // Q)
    Bp = _padded(B, n_sub * Q).reshape(b, n_sub, Q, n)
    Cp = _padded(C, n_sub * Q).reshape(b, n_sub, Q, n)
    return torch.tril(Cp @ Bp.transpose(-1, -2))


def walk(xdt, a, B, C, h0, gy, gh, plain=False):
    """Kernel 2, one P tile at a time. Returns (s_in, ds_out (b, n_sub, h,
    p, n), dx (b, s', h, p), dcum partials (b, n_sub, Q, h, n_pt), dh0)."""
    b, s, h, p = xdt.shape
    n = B.shape[-1]
    exact = B.dtype == torch.bfloat16
    n_sub = -(-s // Q)
    sp = n_sub * Q
    x, gyp = _padded(xdt, sp), _padded(gy, sp)
    cum = torch.cumsum(_padded(a, sp).reshape(b, n_sub, Q, h), 2
                       ).permute(0, 1, 3, 2)                # (b, c, h, Q)
    Bp, Cp = _padded(B, sp), _padded(C, sp)
    cb = cb_pass(B, C)
    n_pt = -(-p // P_TILE)
    s_in = torch.zeros((b, n_sub, h, p, n))
    ds_out = torch.zeros_like(s_in)
    dx = torch.zeros((b, sp, h, p))
    part = torch.zeros((b, n_sub, Q, h, n_pt))
    dh0 = torch.zeros((b, h, p, n))
    cols = [wc for wc in warp_columns(n) if wc]
    tri = torch.ones(Q, Q, dtype=torch.bool).tril()
    for k, p0 in enumerate(range(0, p, P_TILE)):
        pt = slice(p0, min(p0 + P_TILE, p))
        state = torch.zeros((b, h, pt.stop - p0, n)) if h0 is None \
            else h0[:, :, pt].float().clone()
        for c in range(n_sub):                      # the state pass
            rows = slice(c * Q, (c + 1) * Q)
            s_in[:, c, :, pt] = state
            xc = x[:, rows, :, pt].permute(0, 2, 1, 3)      # (b, h, Q, pt)
            total = cum[:, c, :, -1:]
            xd = xc * torch.exp(total - cum[:, c])[..., None]
            state = state * torch.exp(total)[..., None] + mm3(
                xd.transpose(-1, -2), Bp[:, None, rows], b_exact=exact,
                plain=plain)
        dS = torch.zeros_like(state) if gh is None \
            else gh[:, :, pt].float().clone()
        bdot = (state * dS).sum((-2, -1))                   # (b, h)
        for c in reversed(range(n_sub)):                # the reverse walk
            rows = slice(c * Q, (c + 1) * Q)
            q = min(Q, s - c * Q)
            S = s_in[:, c, :, pt]
            ds_out[:, c, :, pt] = dS
            xc = x[:, rows, :, pt].permute(0, 2, 1, 3)
            gyc = gyp[:, rows, :, pt].permute(0, 2, 1, 3)
            Bc, Cc = Bp[:, None, rows], Cp[:, None, rows]   # (b, 1, Q, n)
            cc = cum[:, c]                                  # (b, h, Q)
            total = cc[..., -1:]
            ecum, e = torch.exp(cc), torch.exp(total - cc)
            diff = torch.where(tri, cc[..., :, None] - cc[..., None, :],
                               torch.zeros(()))
            G = torch.where(tri, cb[:, None, c] * torch.exp(diff),
                            torch.zeros(()))
            y_off = torch.zeros_like(xc)
            dx_off = torch.zeros_like(xc)
            for wc in cols:                             # in warp order
                y_off = y_off + mm3(Cc[..., wc], S[..., wc].transpose(
                    -1, -2), a_exact=exact, plain=plain)
                dx_off = dx_off + mm3(Bc[..., wc], dS[..., wc].transpose(
                    -1, -2), a_exact=exact, plain=plain)
            dS = dS * torch.exp(total)[..., None] + mm3(
                (gyc * ecum[..., None]).transpose(-1, -2), Cc,
                b_exact=exact, plain=plain)
            y = mm3(G, xc, plain=plain) + ecum[..., None] * y_off
            dxc = mm3(G.transpose(-1, -2), gyc, plain=plain) + \
                e[..., None] * dx_off
            dx[:, rows, :, pt] = dxc.permute(0, 2, 1, 3)
            rs = (gyc * y - xc * dxc).sum(-1)               # (b, h, Q)
            rs[..., q - 1] += bdot
            part[:, c, :, :, k] = rs.transpose(1, 2)
            bdot = (S * dS).sum((-2, -1))
        dh0[:, :, pt] = dS
    return s_in, ds_out, dx, part, dh0


def heads_pass(xdt, a, B, C, gy, s_in, ds_out, part, groups=None,
               plain=False):
    """Kernel 3 with ``groups`` head groups (default min(8, h); the kernel
    takes the most, up to 8 and dividing h, whose clusters the card holds
    at once): dB and dC per sub-chunk over each group's chunks (head, 32
    state rows) in order, the groups' sums and sum_h M_h summed in rank
    order, M applied last; da from the dcum partials. Returns (da
    (b, s', h), dB, dC (b, s', n)) in f32."""
    b, s, h, p = xdt.shape
    n = B.shape[-1]
    exact = B.dtype == torch.bfloat16
    n_sub = -(-s // Q)
    sp = n_sub * Q
    G = groups or min(8, h)
    x, gyp = _padded(xdt, sp), _padded(gy, sp)
    cum = torch.cumsum(_padded(a, sp).reshape(b, n_sub, Q, h), 2
                       ).permute(0, 1, 3, 2)                # (b, c, h, Q)
    Bp, Cp = _padded(B, sp), _padded(C, sp)
    tri = torch.ones(Q, Q, dtype=torch.bool).tril()
    dB = torch.zeros((b, sp, n))
    dC = torch.zeros_like(dB)
    for c in range(n_sub):
        rows = slice(c * Q, (c + 1) * Q)
        cc = cum[:, c]
        total = cc[..., -1:]
        e, ecum = torch.exp(total - cc), torch.exp(cc)      # (b, h, Q)
        L = torch.where(tri, torch.exp(torch.where(
            tri, cc[..., :, None] - cc[..., None, :], torch.zeros(()))),
            torch.zeros(()))                                # (b, h, Q, Q)
        sums = []
        for r in range(G):                  # one block of the cluster
            db = torch.zeros((b, Q, n))
            dc = torch.zeros_like(db)
            m = torch.zeros((b, Q, Q))
            for hh in range(r, h, G):
                for r0 in range(0, p, K_CHUNK):
                    kr = slice(r0, min(r0 + K_CHUNK, p))
                    xk, gk = x[:, rows, hh, kr], gyp[:, rows, hh, kr]
                    db = db + mm3(e[:, hh, :, None] * xk,
                                  ds_out[:, c, hh, kr], plain=plain)
                    dc = dc + mm3(ecum[:, hh, :, None] * gk,
                                  s_in[:, c, hh, kr], plain=plain)
                    m = m + torch.where(
                        tri, mm3(gk, xk.transpose(-1, -2), plain=plain)
                        * L[:, hh], torch.zeros(()))
            sums.append((db, dc, m))
        db, dc, msum = (sum(t[k] for t in sums) for k in range(3))
        dB[:, rows] = db + mm3(msum.transpose(-1, -2), Cp[:, rows],
                               b_exact=exact, plain=plain)
        dC[:, rows] = dc + mm3(msum, Bp[:, rows], b_exact=exact, plain=plain)
    dcum = part.sum(-1)                                     # (b, c, Q, h)
    da = torch.flip(torch.cumsum(torch.flip(dcum, [2]), 2), [2])
    return da.reshape(b, sp, h), dB, dC


def backward_tiles(xdt, a, B, C, h0, gy, gh, plain=False, groups=None):
    """The three kernels in turn: (dxdt, da, dB, dC, dh0) in f32 (dh0 None
    when h0 is None)."""
    s = xdt.shape[1]
    s_in, ds_out, dx, part, dh0 = walk(xdt, a, B, C, h0, gy, gh, plain)
    da, dB, dC = heads_pass(xdt, a, B, C, gy, s_in, ds_out, part, groups,
                            plain)
    return (dx[:, :s], da[:, :s], dB[:, :s], dC[:, :s],
            None if h0 is None else dh0)


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
    (2, 64, 3, 32, 64, 32, False, True),    # two P tiles, three head groups
    (1, 96, 2, 16, 32, 96, True, False),    # zero gh; one P tile
    (2, 40, 2, 40, 48, 40, True, True),     # ragged; P 16 + 16 + 8
    (1, 33, 2, 64, 32, 33, True, True),     # one position past a sub-chunk
]
PADDED = [   # P and N that the wrapper pads (P to 4, N to 8)
    (1, 50, 2, 18, 20, 50, True, True),
    (2, 36, 2, 6, 10, 36, False, True),
]


def _mirror(ins, bc_dtype=torch.float32, plain=False, groups=None):
    """The mirror on the kernels' operands (the wrapper's padding), cut
    back to the inputs' shapes."""
    xdt, a, B, C, h0, gy, gh = ins
    p, n = xdt.shape[-1], B.shape[-1]
    xk, ak, Bk, Ck, h0k = SSD.kernel_operands(xdt, a, B.to(bc_dtype),
                                               C.to(bc_dtype), h0)
    gyk, ghk = SSD.backward_operands(gy, gh, xk.shape[-1], Bk.shape[-1])
    dx, da, dB, dC, dh0 = backward_tiles(xk, ak, Bk, Ck, h0k, gyk, ghk,
                                         plain, groups)
    return (dx[..., :p], da, dB[..., :n], dC[..., :n],
            None if dh0 is None else dh0[:, :, :p, :n])


@pytest.mark.parametrize("b,s,h,p,n,chunk,with_h0,with_gh", CASES + PADDED)
def test_tiles_match_jax_vjp_of_reference(b, s, h, p, n, chunk, with_h0,
                                          with_gh):
    xdt, a, B, C, h0, gy, gh = _inputs(b, s, h, p, n, seed=s + p + n)
    if not with_gh:
        gh = np.zeros_like(gh)
    ins = (xdt, a, B, C) + ((h0,) if with_h0 else ())

    def f(*args):
        return jssm.ssd_chunked(*args[:4], h0=args[4] if with_h0 else None,
                                chunk=chunk)

    want = jax.jit(lambda args, cot: jax.vjp(f, *args)[1](cot))(
        tuple(map(jnp.asarray, ins)), (jnp.asarray(gy), jnp.asarray(gh)))
    t = torch.from_numpy
    got = _mirror((t(xdt), t(a), t(B), t(C), t(h0) if with_h0 else None,
                   t(gy), t(gh) if with_gh else None))
    assert (got[4] is None) == (not with_h0)
    for name, g, w in zip(NAMES, got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name,
                                   **TOL)


@pytest.mark.parametrize("bc_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,p,n,chunk,with_h0,with_gh", CASES + PADDED)
def test_tiles_match_plain_version_in_float64(b, s, h, p, n, chunk, with_h0,
                                              with_gh, bc_dtype):
    """Against ``ssd_scan_backward_ref`` run in float64 on the same values
    (bf16 B and C widened exactly), before dB and dC are rounded to B's
    type."""
    arrays = list(_inputs(b, s, h, p, n, seed=3 * s + n))
    t = torch.from_numpy
    xdt, a, B, C, h0, gy, gh = map(t, arrays)
    B, C = B.to(bc_dtype).float(), C.to(bc_dtype).float()
    ins = (xdt, a, B, C, h0 if with_h0 else None, gy,
           gh if with_gh else None)
    got = _mirror(ins, bc_dtype)
    want = ssd_scan_backward_ref(*(None if v is None else v.double()
                                   for v in ins))
    for name, g, w in zip(NAMES, got, want):
        if w is None:
            assert g is None, name
            continue
        assert g.dtype == torch.float32 and g.shape == w.shape, name
        torch.testing.assert_close(g.double(), w, msg=name, **TOL)


def test_plain_tf32_misses_the_tolerance_and_the_split_keeps_it():
    """One TF32 product per multiply-add falls outside the 1e-5 limit
    against the float64 plain version, by hundreds of times; the
    compensated split is inside it, as the plain version in f32 is (the
    reason the kernels take two or three MMAs each). At p 32, n 64: at
    mamba2-130m's p 64, n 128 the f32 plain version's own da is already
    ~1e-5 beyond the limit, so the limit cannot tell f32 products apart."""
    t = torch.from_numpy
    xdt, a, B, C, h0, gy, gh = map(t, _inputs(1, 96, 2, 32, 64, seed=11))
    ins = (xdt, a, B, C, None, gy, gh)
    want = ssd_scan_backward_ref(*(None if v is None else v.double()
                                   for v in ins))

    def excess(got):
        return max(float(((g.double() - w).abs() - TOL["atol"]
                          - TOL["rtol"] * w.abs()).max())
                   for g, w in zip(got, want) if w is not None)

    assert excess(ssd_scan_backward_ref(*ins)) <= 0
    assert excess(_mirror(ins, plain=True)) > 100 * TOL["atol"]
    assert excess(_mirror(ins)) <= 0


def test_decays_need_no_per_head_dC():
    """The walk's gy . y: exp(cum) gy . (C S_inᵀ) + sum_j M[t, j] (C Bᵀ)[t, j],
    the second sum taken as gy . (G x), equals C . dC_h, the per-head dC
    that the plain version forms (float64, one head and sub-chunk)."""
    rng = np.random.default_rng(21)
    q, p, n = Q, 24, 40
    x, gy = (torch.from_numpy(rng.standard_normal((q, p))) for _ in range(2))
    B, C = (torch.from_numpy(rng.standard_normal((q, n)) * 0.3)
            for _ in range(2))
    S_in = torch.from_numpy(rng.standard_normal((p, n)))
    cum = torch.cumsum(-torch.from_numpy(np.abs(rng.standard_normal(q)))
                       * 0.3, 0)
    tri = torch.ones(q, q, dtype=torch.bool).tril()
    L = torch.where(tri, torch.exp(cum[:, None] - cum[None, :]),
                    torch.zeros((), dtype=torch.float64))
    CB = C @ B.T
    M = (gy @ x.T) * L
    dC_h = torch.exp(cum)[:, None] * (gy @ S_in) + M @ B
    want = (C * dC_h).sum(-1)
    via_m = torch.exp(cum) * (gy * (C @ S_in.T)).sum(-1) + (M * CB).sum(-1)
    via_gx = torch.exp(cum) * (gy * (C @ S_in.T)).sum(-1) + \
        (gy * ((CB * L) @ x)).sum(-1)
    torch.testing.assert_close(via_m, want, rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(via_gx, want, rtol=1e-12, atol=1e-12)


def test_dB_dC_over_the_heads_equal_the_per_head_sums():
    """dB and dC as one product over the stacked (head, state row) axis, with
    sum_h M_h applied once, equal the sum over heads of each head's own
    diag(e) x dS_out + M_hᵀ C and diag(exp cum) gy S_in + M_h B (float64,
    one sub-chunk)."""
    rng = np.random.default_rng(22)
    h, q, p, n = 3, Q, 8, 16
    r = lambda *shape: torch.from_numpy(  # noqa: E731
        rng.standard_normal(shape))
    x, gy, dS, S_in, B, C = r(h, q, p), r(h, q, p), r(h, p, n), r(h, p, n), \
        r(q, n), r(q, n)
    cum = torch.cumsum(-r(h, q).abs() * 0.3, -1)
    total = cum[:, -1:]
    e, ecum = torch.exp(total - cum), torch.exp(cum)
    tri = torch.ones(q, q, dtype=torch.bool).tril()
    L = torch.where(tri, torch.exp(cum[:, :, None] - cum[:, None, :]),
                    torch.zeros((), dtype=torch.float64))
    M = (gy @ x.transpose(-1, -2)) * L                      # (h, q, q)
    per_head_B = (e[..., None] * x @ dS + M.transpose(-1, -2) @ C).sum(0)
    per_head_C = (ecum[..., None] * gy @ S_in + M @ B).sum(0)
    stacked_x = (e[..., None] * x).permute(1, 0, 2).reshape(q, h * p)
    stacked_gy = (ecum[..., None] * gy).permute(1, 0, 2).reshape(q, h * p)
    dB = stacked_x @ dS.reshape(h * p, n) + M.sum(0).T @ C
    dC = stacked_gy @ S_in.reshape(h * p, n) + M.sum(0) @ B
    torch.testing.assert_close(dB, per_head_B, rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(dC, per_head_C, rtol=1e-12, atol=1e-12)


def test_scratch_is_the_states_and_their_gradients():
    """The walk's two scratch tensors are the state entering every
    sub-chunk and the gradient into the state leaving it: the last
    sub-chunk's leaving gradient is gh, and S_in of sub-chunk c + 1 is the
    recurrence's state after sub-chunk c (the plain sequential scan)."""
    from repro_torch.kernels.ref import ssd_scan_ref
    t = torch.from_numpy
    xdt, a, B, C, h0, gy, gh = map(t, _inputs(1, 80, 2, 16, 16, seed=23))
    s_in, ds_out, _, _, _ = walk(xdt, a, B, C, h0, gy, gh)
    assert s_in.shape == ds_out.shape == (1, 3, 2, 16, 16)
    torch.testing.assert_close(ds_out[:, -1], gh)
    torch.testing.assert_close(s_in[:, 0], h0)
    for c in (1, 2):
        _, want = ssd_scan_ref(xdt[:, :Q * c], a[:, :Q * c], B[:, :Q * c],
                               C[:, :Q * c], h0)
        torch.testing.assert_close(s_in[:, c], want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("groups", [1, 2, 3])
def test_head_groups_change_only_the_summation_order(groups):
    """Kernel 3's head groups (one block of a cluster each; the kernel picks
    their number from what the card holds at once) move dB and dC only by
    the order of f32 sums: within 1e-6 of their largest magnitude of the
    one-group result, and every other output bit for bit."""
    t = torch.from_numpy
    xdt, a, B, C, h0, gy, gh = map(t, _inputs(2, 64, 6, 16, 32, seed=24))
    ins = (xdt, a, B, C, h0, gy, gh)
    one = _mirror(ins, groups=1)
    got = _mirror(ins, groups=groups)
    for name, u, v in zip(NAMES, got, one):
        if name in ("dB", "dC"):
            torch.testing.assert_close(u, v, rtol=0, atol=1e-6 * float(
                v.abs().max()), msg=name)
        else:
            assert torch.equal(u, v), name
