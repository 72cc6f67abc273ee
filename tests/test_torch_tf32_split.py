"""The numeric premise of the port's fp32 kernels on the tensor cores (K1's fp32
kernel, K2 and K3: mdilss_tpu_torch/csrc/tf32_pair.cuh): a float32 product done
as three TF32 products (3xTF32) is float32-accurate, one TF32 product is not.

The emulation of the kernels' arithmetic (`tf32_rna`, `split`, `pair_emulated`)
is in tests/_torch_port.py. The shapes are those of one K3 weight-gradient
product ([pixels x C]^T [pixels x C]) and of one tap-stacked conv chunk
([pixels x 3C] @ [3C x C]), at small size, and K2's whole pair in its kernel's
order. Held to float64 in relative L2: 3xTF32 within 1e-6, one TF32 pass above
1e-5 (the card holds K2 and K3 to 1e-5).
"""
import numpy as np
import pytest
import torch

from _torch_port import pair_emulated, split, tf32_rna


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


# ---- K2 (the training pair's forward) in its kernel's order ---------------------------------

@pytest.mark.parametrize("c,d", [(16, 1), (16, 2), (64, 1), (64, 2)])
def test_k2_order_is_float32_accurate_and_one_tf32_pass_is_not(c, d):
    from mdilss_tpu_torch.ops.nb1d_infer import unstack_taps
    from mdilss_tpu_torch.ops.nb1d_train import fwd_pair_plain

    rng = np.random.default_rng(c + d)
    n, h, w = 2, 6, 24

    def mk(*shape, scale=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32))

    x = mk(n, h, w, c)
    w31s, w13s = mk(3 * c, c, scale=(3 * c) ** -0.5), mk(3 * c, c, scale=(3 * c) ** -0.5)
    b31, rap = mk(c, scale=(3 * c) ** -0.5), mk(c, c, scale=c ** -0.5)
    pre = ((1.0 + mk(c, scale=0.2)).abs(), mk(c, scale=0.2))
    args = (unstack_taps(w31s, True), b31, unstack_taps(w13s, False), rap, pre, d)
    x_nchw = x.permute(0, 3, 1, 2)
    y64 = fwd_pair_plain(x_nchw.double(), *(a.double() if torch.is_tensor(a) else
                                            (a if a is None else tuple(t.double() for t in a))
                                            for a in args[:5]), d)[0].permute(0, 2, 3, 1)
    m64 = y64.mean((0, 1, 2))
    v64 = (y64 - m64).square().mean((0, 1, 2))

    def stats_err(st):
        mu = st[0] / (n * h * w)
        var = torch.clamp(st[1] / (n * h * w) - mu * mu, min=0.0)
        return float((mu - m64).norm() / v64.sqrt().norm()), float((var - v64).norm() / v64.norm())

    y, st = pair_emulated(x, w31s, b31, w13s, rap, pre, d)
    assert rel_l2(y, y64) <= 1e-6, rel_l2(y, y64)
    assert max(stats_err(st)) <= 1e-6, stats_err(st)
    y1, _ = pair_emulated(x, w31s, b31, w13s, rap, pre, d, one_pass=True)
    assert rel_l2(y1, y64) > 1e-5, rel_l2(y1, y64)
    yp, stp = fwd_pair_plain(x_nchw, *args[:5], d)
    assert rel_l2(yp.permute(0, 2, 3, 1), y64) <= 1e-6, rel_l2(yp.permute(0, 2, 3, 1), y64)
    assert max(stats_err(stp.double())) <= 1e-6, stats_err(stp.double())
