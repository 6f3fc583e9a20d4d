"""The routed-MLP kernel's exact three-way bf16 split of the down
projection's f32 operand (``kernels/ref.py`` ``moe_split3``, as the gate/up
kernel's epilogue splits h), which makes every down-projection product exact.
The kernels themselves are compared with the plain version on the card
(``tests/test_torch_gpu.py``)."""
import numpy as np
import pytest
import torch

from repro_torch.kernels.ref import moe_split3


@pytest.mark.parametrize("exponents", [(-20, 20), (-110, -90), (100, 127)])
def test_split3_is_exact(exponents):
    """hi + mid + lo == h bit for bit (summed in f64, where no sum rounds)
    over random f32 at the given binary exponents, with zeros and both
    signs; every part is a bf16."""
    rng = np.random.default_rng(sum(exponents) % 97)
    mant = rng.uniform(1.0, 2.0, 4096) * rng.choice([-1.0, 1.0], 4096)
    h = torch.from_numpy(np.ldexp(mant, rng.integers(
        *exponents, 4096)).astype(np.float32))
    h[:8] = 0.0
    h[8:16] = -0.0
    hi, mid, lo = moe_split3(h)
    assert hi.dtype == mid.dtype == lo.dtype == torch.bfloat16
    assert torch.equal(hi.double() + mid.double() + lo.double(), h.double())
    # hi keeps h's top 8 significant bits: |h - hi| < 2^-7 |h|
    assert ((h - hi.float()).abs() <= h.abs() * 2.0 ** -7).all()

