"""A frozen copy of `mdilss_tpu_torch.train.optim.apply_updates` as it was
before the LR vector, the zero gradients and the write-back were made
sync-free: the reference that the present one must equal bit for bit, on
the CPU (tests/test_torch_optim.py) and on the card (tests/test_torch_cuda.py).
Imports no JAX."""
from __future__ import annotations

import numpy as np
import torch

from mdilss_tpu_torch.train.optim import AdamState


@torch.no_grad()
def apply_updates_before(params: dict, grads: dict, state: AdamState, lr_tree: dict, *,
                         lr_scale: float, weight_decay: float = 1e-4, b1: float = 0.9,
                         b2: float = 0.999, eps: float = 1e-8) -> AdamState:
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


def adam_case(classes: list, count: int, device="cpu", seed: int = 0):
    """An ERFNetRAP parameter set of `classes` (the last task current, its
    RAP LR dict: frozen leaves at 0), Adam's state after `count - 1` steps
    (random moments; 0 at the frozen elements) and a gradient maker: every
    fifth leaf, and every frozen one of the first ten, without a gradient."""
    from mdilss_tpu_torch.models import ERFNetRAP
    from mdilss_tpu_torch.train.masks import rap_lr_tree

    torch.manual_seed(seed)
    model = ERFNetRAP(classes, len(classes), device="cpu")
    lrs = rap_lr_tree(model, current_task=len(classes) - 1, shared_lr=5e-6, ds_lr=5e-4)
    params = {k: p.detach().to(device) for k, p in model.named_parameters()}
    frozen = [k for k in params if lrs[k] == 0.0]
    n = sum(p.numel() for p in params.values())
    g = torch.Generator().manual_seed(seed + 1)
    m = torch.randn(n, generator=g) * 1e-3
    v = torch.rand(n, generator=g) * 1e-6
    live = torch.cat([torch.full((p.numel(),), float(lrs[k] > 0)) for k, p in params.items()])
    state = AdamState(m=(m * live).to(device), v=(v * live).to(device), count=count - 1)
    none = {k for i, k in enumerate(params) if i % 5 == 0} | set(frozen[:10])

    def grads():
        return {k: None if k in none else torch.randn(p.shape, generator=g).to(device)
                for k, p in params.items()}

    return params, lrs, state, grads, frozen
