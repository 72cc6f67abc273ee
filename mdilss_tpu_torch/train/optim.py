"""Torch-exact Adam with per-parameter learning rates and freeze masks.

Port of mdilss_tpu/train/optim.py:75-122. One step over every parameter,
as torch.optim.Adam(weight_decay=wd) computes it:

    g <- grad + wd * p                    (zero where lr == 0: frozen)
    m <- b1 * m + (1 - b1) * g
    v <- b2 * v + (1 - b2) * g^2
    p <- p - lr * lr_scale * (m / (1 - b1^t)) / (sqrt(v / (1 - b2^t)) + eps)

with one step count t shared by all parameters. A frozen parameter (lr 0)
keeps exactly its value and its moments stay exactly 0, as torch's "not in
any param group". A parameter with no gradient (None: not reached by the
loss, as the pre-BN biases the batch mean absorbs) counts as a zero gradient,
so weight decay still moves it where lr > 0, as in the JAX package.

The moments are one flat float32 vector over the parameters in the order of
the `params` dict, as in the JAX package; parameters are updated in place.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class AdamState(NamedTuple):
    m: torch.Tensor  # first moment, flat [P] float32
    v: torch.Tensor  # second moment, flat [P] float32
    count: int       # steps taken, shared by all parameters


def init(params: dict[str, torch.Tensor]) -> AdamState:
    first = next(iter(params.values()))
    n = sum(p.numel() for p in params.values())
    zeros = torch.zeros(n, dtype=torch.float32, device=first.device)
    return AdamState(m=zeros, v=zeros.clone(), count=0)


@torch.no_grad()
def apply_updates(params: dict[str, torch.Tensor], grads: dict[str, torch.Tensor | None],
                  state: AdamState, lr_tree: dict[str, float], *, lr_scale: float,
                  weight_decay: float = 1e-4, b1: float = 0.9, b2: float = 0.999,
                  eps: float = 1e-8) -> AdamState:
    """One Adam step, in place on `params`; returns the new state. `lr_tree`
    gives each parameter's base LR (0 = frozen), `lr_scale` the schedule
    factor applied to every parameter (`poly_lr_factor`)."""
    names = list(params)
    ps = [params[k] for k in names]
    dev = ps[0].device
    sizes = [p.numel() for p in ps]
    count = state.count + 1
    f32 = np.float32
    c1 = float(f32(1.0) - f32(b1) ** f32(count))
    c2 = float(f32(1.0) - f32(b2) ** f32(count))
    lr = torch.repeat_interleave(
        torch.tensor([float(lr_tree[k]) for k in names], dtype=torch.float32, device=dev),
        torch.tensor(sizes, device=dev),
    )
    p_flat = torch.cat([p.reshape(-1).float() for p in ps])
    g_flat = torch.cat([
        torch.zeros(p.numel(), dtype=torch.float32, device=dev) if grads.get(k) is None
        else grads[k].reshape(-1).float()
        for k, p in zip(names, ps)
    ])
    gf = (g_flat + weight_decay * p_flat) * (lr > 0).float()
    m = b1 * state.m + (1.0 - b1) * gf
    v = b2 * state.v + (1.0 - b2) * gf.square()
    new = p_flat - (lr * lr_scale) * (m / c1) / (torch.sqrt(v / c2) + eps)
    for p, chunk in zip(ps, new.split(sizes)):
        p.copy_(chunk.view_as(p))
    return AdamState(m=m, v=v, count=count)


def poly_lr_factor(epoch: int, num_epochs: int, power: float = 0.9) -> float:
    """The reference's LambdaLR factor (1 - (epoch-1)/E)^0.9, epoch in [1, E],
    in float32 as the JAX package computes it."""
    f32 = np.float32
    return float(np.power(f32(1.0) - (f32(epoch) - f32(1.0)) / f32(num_epochs), f32(power)))
