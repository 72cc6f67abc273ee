"""Eval-mode BatchNorm with the JAX package's numerics (mdilss_tpu/ops/norm.py).

Inference uses the running statistics of `nn.BatchNorm2d(eps=1e-3)` (the
reference's eps on every BN). The affine is computed in at least float32
whatever the activation type, then rounded back to it, as
`mdilss_tpu.ops.norm.batch_norm_apply(training=False)` does; bf16 serving
therefore rounds once per BN, not per arithmetic step.
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


def fold_bn(scale, bias, mean, var, pre_bias, eps: float = BN_EPS):
    """BN(running stats) o (+pre_bias) -> per-channel float32 (a, b) with
    BN(z + pre_bias) = z * a + b, exactly as mdilss_tpu/ops/pallas/nb1d.py
    `_fold_bn`: a = scale / sqrt(var + eps), b = bias - (mean - pre_bias) * a."""
    scale, bias, mean, var, pre_bias = (
        t.to(torch.float32) for t in (scale, bias, mean, var, pre_bias)
    )
    a = scale / torch.sqrt(var + eps)
    b = bias - (mean - pre_bias) * a
    return a, b
