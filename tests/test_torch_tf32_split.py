"""The numeric premise of K3 on the tensor cores (mdilss_tpu_torch/csrc/nb1d_train.cu):
a float32 product done as three TF32 products (3xTF32) is float32-accurate, one TF32
product is not.

TF32 keeps float32's exponent and 10 mantissa bits. `tf32_rna` emulates
cvt.rna.tf32.f32 (round to nearest, ties away from zero) on the float32 bits,
with the integer rounding the kernel itself uses. Each operand splits as
hi = rna(x), lo = rna(x - hi); a product of TF32 values is exact in float32
(11 x 11 significant bits), so float32 matmuls of the split operands give the
tensor cores' products, summed in float32. The shapes are those of one K3
weight-gradient product ([pixels x C]^T [pixels x C]) and of one tap-stacked
conv chunk ([pixels x 3C] @ [3C x C]), at small size. Held to float64 in
relative L2: 3xTF32 within 1e-6, one TF32 pass above 1e-5 (the card holds K3
to 1e-5).
"""
import numpy as np
import pytest
import torch


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest TF32 value (ties away from zero), as float32."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split(x: torch.Tensor):
    hi = tf32_rna(x)
    return hi, tf32_rna(x - hi)


def rel_l2(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got.double() - want).norm() / want.norm())


@pytest.mark.parametrize("x,want", [
    (1.0, 1.0),
    (1.0 + 2.0 ** -12, 1.0),                    # below half an ulp of TF32: down
    (1.0 + 2.0 ** -11, 1.0 + 2.0 ** -10),       # a tie: away from zero
    (-(1.0 + 2.0 ** -11), -(1.0 + 2.0 ** -10)),
    (1.0 + 3 * 2.0 ** -12, 1.0 + 2.0 ** -10),   # above half an ulp: up
    (2.0 - 2.0 ** -23, 2.0),                    # the carry reaches the exponent
    (0.0, 0.0),
])
def test_tf32_rna_rounds_to_ten_mantissa_bits(x, want):
    got = tf32_rna(torch.tensor([x], dtype=torch.float32))
    assert float(got[0]) == want


def test_split_keeps_22_bits():
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(100_000).astype(np.float32))
    hi, lo = split(x)
    assert torch.equal(tf32_rna(hi), hi) and torch.equal(tf32_rna(lo), lo)
    err = (x.double() - hi.double() - lo.double()).abs() / x.double().abs()
    assert float(err.max()) <= 2.0 ** -22


@pytest.mark.parametrize("kind,m,k,n", [
    ("wgrad", 64, 4096, 64),    # dw = u^T dc over 4096 pixels, C = 64
    ("wgrad", 16, 8192, 16),    # C = 16
    ("wgrad", 128, 1024, 128),  # C = 128
    ("conv", 64, 384, 128),     # 64 pixels of a row x 3 taps of 128 channels
    ("conv", 256, 48, 16),      # C = 16
])
def test_3xtf32_is_float32_accurate_and_one_tf32_pass_is_not(kind, m, k, n):
    rng = np.random.default_rng(m * 7 + k + n)
    if kind == "wgrad":  # [pixels x C]^T [pixels x C]
        a = torch.from_numpy(rng.standard_normal((k, m)).astype(np.float32)).t()
    else:  # [pixels x 3C] @ [3C x C], weights at torch's conv init scale
        a = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32))
    b = torch.from_numpy((rng.standard_normal((k, n)) / np.sqrt(k)).astype(np.float32))
    want = a.double() @ b.double()
    (ah, al), (bh, bl) = split(a), split(b)
    three = al @ bh + ah @ bl + ah @ bh  # small terms first, float32 sums
    one = ah @ bh
    assert rel_l2(three, want) <= 1e-6, rel_l2(three, want)
    assert rel_l2(one, want) > 1e-5, rel_l2(one, want)
