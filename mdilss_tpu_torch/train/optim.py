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

A step neither waits for the device nor walks the parameters in Python op
by op: what the LR dict gives (the per-element LR vector, its `lr > 0`
mask, the leaves' sizes, zero vectors for the None gradients) is built on
the parameters' device once by an `LrCache` that the caller keeps (one host
-> device copy, at its first step) and reused while the parameters' names,
sizes, LRs and device stay the same; the parameters and gradients are
flattened, and the result written back, by one call each
(`torch._utils._flatten_dense_tensors`, `_unflatten_dense_tensors`,
`torch._foreach_copy_`).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors


LR_BUILDS = 0  # per-element LR vectors built (`LrCache.get`): one per step maker and device


class AdamState(NamedTuple):
    m: torch.Tensor  # first moment, flat [P] float32
    v: torch.Tensor  # second moment, flat [P] float32
    count: int       # steps taken, shared by all parameters


def init(params: dict[str, torch.Tensor]) -> AdamState:
    first = next(iter(params.values()))
    n = sum(p.numel() for p in params.values())
    zeros = torch.zeros(n, dtype=torch.float32, device=first.device)
    return AdamState(m=zeros, v=zeros.clone(), count=0)


class LrCache:
    """What `apply_updates` takes from the LR dict, on the parameters'
    device: `lr` (each element's base LR, float32), `live` (`lr > 0` as
    float32) and `zeros` (per leaf, a zero vector of its size, all views
    of one buffer: what a None gradient reads as).
    Built at the first `get` and again only when the parameters' names,
    sizes, LRs or device change."""

    def __init__(self):
        self.key = None

    def get(self, names: list, ps: list, lr_tree: dict) -> "LrCache":
        global LR_BUILDS
        lrs = tuple(float(lr_tree[k]) for k in names)
        sizes = tuple(p.numel() for p in ps)
        dev = ps[0].device
        key = (tuple(names), sizes, lrs, dev)
        if key != self.key:
            host = torch.from_numpy(np.repeat(np.asarray(lrs, np.float32), sizes))
            self.lr = host.to(dev)  # the one copy: it waits for the queue to drain
            self.live = (self.lr > 0).float()
            zeros = torch.zeros(max(sizes), dtype=torch.float32, device=dev)
            self.zeros = [zeros[:n] for n in sizes]
            self.key = key
            LR_BUILDS += 1
        return self


@torch.no_grad()
def apply_updates(params: dict[str, torch.Tensor], grads: dict[str, torch.Tensor | None],
                  state: AdamState, lr_tree: dict[str, float], *, lr_scale: float,
                  weight_decay: float = 1e-4, b1: float = 0.9, b2: float = 0.999,
                  eps: float = 1e-8, cache: LrCache | None = None) -> AdamState:
    """One Adam step, in place on `params`; returns the new state. `lr_tree`
    gives each parameter's base LR (0 = frozen), `lr_scale` the schedule
    factor applied to every parameter (`poly_lr_factor`). `cache`: the
    caller's `LrCache`, reused across its steps (None: built for this one)."""
    names = list(params)
    ps = list(params.values())
    lc = (LrCache() if cache is None else cache).get(names, ps, lr_tree)
    count = state.count + 1
    f32 = np.float32
    c1 = float(f32(1.0) - f32(b1) ** f32(count))
    c2 = float(f32(1.0) - f32(b2) ** f32(count))
    # one flat copy each, cast after the concatenation: the same float32 values as each leaf
    # cast first, since a wider common type holds every leaf's values exactly
    p_flat = _flatten_dense_tensors(ps).float()
    g_flat = _flatten_dense_tensors([z if g is None else g
                                     for g, z in zip(map(grads.get, names), lc.zeros)]).float()
    gf = (g_flat + weight_decay * p_flat) * lc.live
    m = b1 * state.m + (1.0 - b1) * gf
    v = b2 * state.v + (1.0 - b2) * gf.square()
    new = p_flat - (lc.lr * lr_scale) * (m / c1) / (torch.sqrt(v / c2) + eps)
    torch._foreach_copy_(ps, _unflatten_dense_tensors(new, ps))
    return AdamState(m=m, v=v, count=count)


def poly_lr_factor(epoch: int, num_epochs: int, power: float = 0.9) -> float:
    """The reference's LambdaLR factor (1 - (epoch-1)/E)^0.9, epoch in [1, E],
    in float32 as the JAX package computes it: the float32 base raised to the
    float32 exponent, correctly rounded to float32 (XLA's float32 power on the
    CPU); numpy's float32 power is an ulp off it at some epochs."""
    f32 = np.float32
    base = f32(1.0) - (f32(epoch) - f32(1.0)) / f32(num_epochs)
    return float(f32(np.float64(base) ** np.float64(f32(power))))
