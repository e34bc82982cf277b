"""Split-TF32, the arithmetic of the flash backward kernels' products
(``paddle_tpu_torch/csrc/flash_bwd.cu``), emulated in torch on the CPU.

Each operand x is split into ``hi = rna(x)`` and ``lo = rna(x - hi)``,
where ``rna`` rounds to TF32 as ``cvt.rna.tf32.f32`` does: a 10-bit
mantissa, to nearest, ties away from zero. The kernel computes it as
here: add half a TF32 ulp to the bits and clear the 13 bits below the
mantissa. A product is ``a_hi b_hi + a_hi b_lo + a_lo b_hi`` (each TF32
product exact in fp32), summed in fp32. At head dims 16-128 that is
within 1e-6 of a float64 product (relative to the product's largest
entry), and a single-pass TF32 product is not: it keeps about three
decimal digits. This is what lets ``chip_smoke.py`` keep ``K1_TOL`` at
1e-4 for the kernels. Inputs come from seeded numpy.
"""

import numpy as np
import pytest
import torch

SPLIT_TOL = 1e-6
TF32_ULP = 2.0 ** -10  # relative spacing of TF32 values (10-bit mantissa)


def rna_tf32(x):
    """float32 ``x`` rounded to TF32, to nearest, ties away from zero."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split(x):
    hi = rna_tf32(x)
    return hi, rna_tf32(x - hi)


def split_matmul(a, b):
    """``a @ b`` as three TF32 products with fp32 sums."""
    ah, al = split(a)
    bh, bl = split(b)
    return (al @ bh + ah @ bl) + ah @ bh


def _normal(rng, *shape):
    return torch.from_numpy(rng.randn(*shape).astype("float32"))


def test_rna_is_the_nearest_tf32_value_ties_away_from_zero():
    rng = np.random.RandomState(0)
    x = _normal(rng, 20000) * torch.from_numpy(
        np.exp2(rng.randint(-20, 20, 20000)).astype("float32"))
    got = rna_tf32(x).double()
    bits = x.view(torch.int32)
    down = (bits & ~0x1FFF).view(torch.float32).double()  # toward zero
    up = ((bits & ~0x1FFF) + 0x2000).view(torch.float32).double()
    xd = x.double()
    # the nearer of the two neighbours, the one away from zero on a tie
    want = torch.where((xd - down).abs() < (up - xd).abs(), down, up)
    assert torch.equal(got, want)
    assert ((got.float().view(torch.int32) & 0x1FFF) == 0).all()
    # exact ties round away from zero, in both signs
    tie = torch.tensor([1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11),
                        1.0 + 3 * 2.0 ** -11], dtype=torch.float32)
    assert rna_tf32(tie).tolist() == [1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10),
                                      1.0 + 2.0 ** -9]


def test_hi_plus_lo_keeps_about_22_bits():
    rng = np.random.RandomState(1)
    x = _normal(rng, 20000)
    hi, lo = split(x)
    assert ((hi - rna_tf32(hi)) == 0).all() and ((lo - rna_tf32(lo)) == 0).all()
    rel = ((x.double() - hi.double() - lo.double()).abs()
           / x.double().abs()).max().item()
    assert rel <= TF32_ULP ** 2


@pytest.mark.parametrize("d", [16, 32, 64, 128])
def test_three_term_product_keeps_fp32_accuracy_one_pass_does_not(d):
    rng = np.random.RandomState(d)
    a, b = _normal(rng, 64, d), _normal(rng, d, 64)
    ref = a.double() @ b.double()
    scale = ref.abs().max().item()
    err3 = (split_matmul(a, b).double() - ref).abs().max().item() / scale
    err1 = (rna_tf32(a) @ rna_tf32(b) - ref).abs().max().item() / scale
    assert err3 <= SPLIT_TOL
    assert err1 > 100 * SPLIT_TOL
