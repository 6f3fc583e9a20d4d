"""The port's int8 KV pool against the reference's: message size, block
writes (int8 payload and scale bits), verbatim replication copies and
dequantizing reads, all from the same numpy blocks."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs in parallel workers on few
# cores, and idle OpenMP threads spin and starve the other workers
torch.set_num_threads(1)
import jax.numpy as jnp  # noqa: E402

from repro.serving.kvcache import PagedKVPool as JPool  # noqa: E402
from repro_torch.kernels.paged_attention_int8 import SCALE_DTYPE  # noqa: E402
from repro_torch.serving.kvcache import PagedKVPool  # noqa: E402

SHAPE = dict(n_layers=2, n_kv_heads=2, head_dim=64)


def _pools(n_blocks=9, page=8):
    ours = PagedKVPool(n_blocks, page, real=True, quantized=True,
                       device="cpu", **SHAPE)
    ref = JPool(n_blocks, page, real=True, quantized=True, **SHAPE)
    return ours, ref


def _np(x) -> np.ndarray:
    """Raw bits of a torch or JAX array: int8 as is, bf16 as uint16."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            x = x.view(torch.int16)
        return x.numpy().view(np.uint16) if x.dtype == torch.int16 \
            else x.numpy()
    a = np.array(x)
    return a.view(np.uint16) if a.dtype.itemsize == 2 else a


def _blocks(n, seed=0, page=8):
    """(L, K, n, page, D) f32 blocks with one all-zero token row."""
    rng = np.random.default_rng(seed)
    shape = (SHAPE["n_layers"], SHAPE["n_kv_heads"], n, page,
             SHAPE["head_dim"])
    k = rng.standard_normal(shape).astype(np.float32)
    v = (rng.standard_normal(shape) * 3).astype(np.float32)
    k[0, 1, 0, 2] = 0.0
    return k, v


@pytest.mark.parametrize("page", [8, 16])
def test_block_nbytes_matches_reference(page):
    ours, ref = _pools(page=page)
    rows = SHAPE["n_layers"] * SHAPE["n_kv_heads"] * page
    assert ours.block_nbytes == ref.block_nbytes == \
        2 * rows * SHAPE["head_dim"] + 2 * rows * 2
    bf16 = PagedKVPool(9, page, real=True, device="cpu", **SHAPE)
    assert 1.9 < bf16.block_nbytes / ours.block_nbytes <= 2.0


def test_fresh_pool_layout():
    """int8 payload, bf16 scales initialised to ONES so zeroed pages and the
    scratch block dequantize to exact zeros — as the reference."""
    ours, ref = _pools()
    assert ours.k.dtype == torch.int8 and ours.v.dtype == torch.int8
    assert ours.k_scale.dtype == SCALE_DTYPE
    assert ours.k_scale.shape == ours.k.shape[:-1] + (1,)
    for name in ("k", "v", "k_scale", "v_scale"):
        np.testing.assert_array_equal(_np(getattr(ours, name)),
                                      _np(getattr(ref, name)))
    k, v = ours.read_block(3)
    assert k.dtype == torch.float32 and not k.any() and not v.any()
    plain = PagedKVPool(9, 8, real=True, device="cpu", **SHAPE)
    assert plain.k_scale is None and plain.v_scale is None


def test_write_blocks_bit_exact_against_reference():
    """write_blocks quantizes per token row: the int8 payload and the scale
    bits equal the reference pool's, slot for slot."""
    ours, ref = _pools()
    k, v = _blocks(3)
    slots = [4, 1, 7]
    ours.write_blocks(slots, torch.from_numpy(k), torch.from_numpy(v))
    ref.write_blocks(slots, jnp.asarray(k), jnp.asarray(v))
    for name in ("k", "v", "k_scale", "v_scale"):
        np.testing.assert_array_equal(_np(getattr(ours, name)),
                                      _np(getattr(ref, name)), err_msg=name)
    for slot in slots + [0]:
        for got, want in zip(ours.read_block_quantized(slot),
                             ref.read_block_quantized(slot)):
            np.testing.assert_array_equal(_np(got), _np(want))
        for got, want in zip(ours.read_block(slot), ref.read_block(slot)):
            assert got.dtype == torch.float32
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the zero token row round-trips to exact zeros with scale 1
    rk, _ = ours.read_block(4)
    assert not rk[0, 1, 2].any()
    assert float(ours.k_scale[0, 1, 4, 2, 0]) == 1.0
    # quantization error at most half a step of the stored scale
    err = (rk - torch.from_numpy(k[:, :, 0])).abs()
    assert (err <= ours.k_scale[:, :, 4].float() * 0.5 + 1e-7).all()


def test_bf16_blocks_quantize_like_reference():
    """The engine writes bf16 rows into the pool: same bits as the
    reference from the same bf16 blocks."""
    ours, ref = _pools()
    k, v = _blocks(2, seed=3)
    ours.write_blocks([2, 5], torch.from_numpy(k).bfloat16(),
                      torch.from_numpy(v).bfloat16())
    ref.write_blocks([2, 5], jnp.asarray(k, jnp.bfloat16),
                     jnp.asarray(v, jnp.bfloat16))
    for name in ("k", "v", "k_scale", "v_scale"):
        np.testing.assert_array_equal(_np(getattr(ours, name)),
                                      _np(getattr(ref, name)), err_msg=name)


def test_copy_blocks_to_ships_payload_and_scales_verbatim():
    """Replication copies int8 bytes AND scales with no requantization: the
    hosted blocks are bit-identical to the primary's, as in the reference,
    and untouched target slots keep zeros with unit scales."""
    (a, ja), (b, jb) = _pools(), _pools()
    k, v = _blocks(3, seed=1)
    a.write_blocks([4, 1, 7], torch.from_numpy(k), torch.from_numpy(v))
    ja.write_blocks([4, 1, 7], jnp.asarray(k), jnp.asarray(v))
    a.copy_blocks_to(b, [1, 7], [0, 5])
    ja.copy_blocks_to(jb, [1, 7], [0, 5])
    for src, dst in ((1, 0), (7, 5)):
        for x, y in zip(a.read_block_quantized(src),
                        b.read_block_quantized(dst)):
            assert torch.equal(x, y)
    for name in ("k", "v", "k_scale", "v_scale"):
        np.testing.assert_array_equal(_np(getattr(b, name)),
                                      _np(getattr(jb, name)), err_msg=name)
    untouched = [s for s in range(9) if s not in (0, 5)]
    assert not b.k[:, :, untouched].any()
    assert (b.k_scale[:, :, untouched] == 1).all()


def test_peers_must_agree_on_quantization():
    quant, _ = _pools()
    plain = PagedKVPool(9, 8, real=True, device="cpu", **SHAPE)
    with pytest.raises(AssertionError, match="quantization"):
        quant.copy_blocks_to(plain, [1], [2])
