"""Scaled dot-product attention of the port's transformer models: one call
site, and its launch counters.

`attention(q, k, v, scale)` is softmax(q k^T * scale) v over
[B, heads, tokens, head_dim] operands, through
`F.scaled_dot_product_attention` pinned to one backend: on the card the
memory-efficient (CUTLASS) kernel, which takes float32 and keeps only the
output and its log-sum-exp for the backward; on the CPU the plain (math)
path, which also takes float64. A backend that cannot take the call raises;
nothing falls back silently.

Counters, as `ops.nb1d_train.LAUNCHES_*` count K2 and K3: `LAUNCHES_FWD`
counts every call, `LAUNCHES_GRAD` those made with grad enabled on an
operand that requires it, whose backward a training step runs. They count
on every device.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

LAUNCHES_FWD = 0
LAUNCHES_GRAD = 0


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float) -> torch.Tensor:
    """q [B, h, Nq, d], k and v [B, h, Nk, d] -> [B, h, Nq, d]."""
    global LAUNCHES_FWD, LAUNCHES_GRAD
    from torch.nn.attention import SDPBackend, sdpa_kernel

    cuda = q.device.type == "cuda"
    with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION if cuda else SDPBackend.MATH):
        out = F.scaled_dot_product_attention(q, k, v, scale=scale)
    LAUNCHES_FWD += 1
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        LAUNCHES_GRAD += 1
    return out
