"""BatchNorm with the JAX package's numerics (mdilss_tpu/ops/norm.py).

Every BN is `nn.BatchNorm2d(eps=1e-3)` (the reference's eps) with torch's
momentum 0.1. Inference uses the running statistics; the affine is computed
in at least float32 whatever the activation type, then rounded back to it, as
`mdilss_tpu.ops.norm.batch_norm_apply(training=False)` does; bf16 serving
therefore rounds once per BN, not per arithmetic step. Training normalises
with the biased batch variance and updates the running statistics in place
with the unbiased one.
"""
from __future__ import annotations

import torch
from torch import nn

BN_EPS = 1e-3  # reference eps on every BN (models/erfnet.py:18)


def batch_norm_eval(x: torch.Tensor, bn: nn.BatchNorm2d) -> torch.Tensor:
    """BN over the channel dim (dim 1) of NCHW `x` with running stats."""
    cdt = torch.promote_types(x.dtype, torch.float32)
    inv = torch.rsqrt(bn.running_var.to(cdt) + bn.eps) * bn.weight.to(cdt)
    shift = bn.bias.to(cdt) - bn.running_mean.to(cdt) * inv
    out = x.to(cdt) * inv.view(1, -1, 1, 1) + shift.view(1, -1, 1, 1)
    return out.to(x.dtype)


def fold_bn(scale, bias, mean, var, pre_bias, eps: float = BN_EPS, dtype=torch.float32):
    """BN(running stats) o (+pre_bias) -> per-channel (a, b) in `dtype` (float32
    for the kernels) with BN(z + pre_bias) = z * a + b, exactly as
    mdilss_tpu/ops/pallas/nb1d.py `_fold_bn`: a = scale / sqrt(var + eps),
    b = bias - (mean - pre_bias) * a."""
    scale, bias, mean, var, pre_bias = (
        t.to(dtype) for t in (scale, bias, mean, var, pre_bias)
    )
    a = scale / torch.sqrt(var + eps)
    b = bias - (mean - pre_bias) * a
    return a, b


BN_MOMENTUM = 0.1  # reference momentum on every BN (torch's default)


@torch.no_grad()
def update_running_stats(bn: nn.BatchNorm2d, mean: torch.Tensor, var: torch.Tensor,
                         count: int) -> None:
    """In place: running = (1 - m) * running + m * batch, with the unbiased
    batch variance `var * count / (count - 1)` (mdilss_tpu/ops/norm.py:58-63)."""
    unbiased = var.detach() * (count / max(count - 1, 1))
    bn.running_mean.copy_((1.0 - BN_MOMENTUM) * bn.running_mean + BN_MOMENTUM * mean.detach())
    bn.running_var.copy_((1.0 - BN_MOMENTUM) * bn.running_var + BN_MOMENTUM * unbiased)


def batch_norm_train(x: torch.Tensor, bn: nn.BatchNorm2d) -> torch.Tensor:
    """Training-mode BN over (N, H, W) of NCHW `x`: normalise with the biased
    batch variance (two-pass, as mdilss_tpu/ops/norm.py:54-57) and update
    `bn`'s running statistics in place. Differentiable in x, weight and bias."""
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    mean = xf.mean((0, 2, 3))
    var = (xf - mean.view(1, -1, 1, 1)).square().mean((0, 2, 3))
    update_running_stats(bn, mean, var, x.numel() // x.shape[1])
    inv = torch.rsqrt(var + bn.eps) * bn.weight.to(xf.dtype)
    shift = bn.bias.to(xf.dtype) - mean * inv
    return (xf * inv.view(1, -1, 1, 1) + shift.view(1, -1, 1, 1)).to(x.dtype)
