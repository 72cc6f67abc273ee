"""BatchNorm with the JAX package's numerics (mdilss_tpu/ops/norm.py).

Every BN is `nn.BatchNorm2d(eps=1e-3)` (the reference's eps) with torch's
momentum 0.1. Inference uses the running statistics; the affine is computed
in at least float32 whatever the activation type, then rounded back to it, as
`mdilss_tpu.ops.norm.batch_norm_apply(training=False)` does; bf16 serving
therefore rounds once per BN, not per arithmetic step. Training normalises
with the biased batch variance and updates the running statistics in place
with the unbiased one, once per forward: while a rematerialised region
replays its forward in the backward (`replaying`, entered by
`models.topology._ckpt`), `update_running_stats` does nothing.

Under `synced(mesh)` (the sharded steps, `parallel.mesh`) training BN uses
the global batch's statistics, as the JAX package's BN does under a mesh
(mdilss_tpu/ops/norm.py:54-63 over the sharded batch): the mean is the mean
of the ranks' means over every rank of the mesh, data x spatial, then the
variance the mean of the ranks' mean squared deviations from it (equal
blocks of images and of rows, so these are the global two-pass statistics),
each a differentiable all-reduce, and the running statistics take the
unbiased variance at the global count. The training block's glue
(`ops.nb1d_train`) and the row halos of the convs (`parallel.halo`, through
`models.blocks` and the kernels' wrappers) read the same context.
"""
from __future__ import annotations

import contextlib
import threading

import torch
from torch import nn

from ..parallel.mesh import active, psum

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


class _Replay(threading.local):
    depth = 0  # rematerialised regions replaying their forward in this thread


_REPLAY = _Replay()


@contextlib.contextmanager
def replaying():
    """The recompute context of a rematerialised region: while it is entered
    (it nests, as the regions of a previous-task forward replay inside that
    forward's own replay), the running statistics stay as the forward left
    them. Per thread: the replay runs in the thread that enters it."""
    _REPLAY.depth += 1
    try:
        yield
    finally:
        _REPLAY.depth -= 1


class _Sync(threading.local):
    mesh = None  # the mesh whose batch statistics this thread's BN computes


_SYNC = _Sync()


@contextlib.contextmanager
def synced(mesh):
    """Training BN (and the training block's glue) in this thread computes
    the statistics of the global batch over `mesh` (a mesh without a group,
    or None: this rank's batch, as outside the context), and the convs
    exchange their row halos over a spatial mesh.
    Per thread: the backward of a region's replay re-enters it with the
    forward's mesh (`models.topology._ckpt`), and the training block keeps
    its mesh for its own backward."""
    saved = _SYNC.mesh
    _SYNC.mesh = active(mesh)
    try:
        yield
    finally:
        _SYNC.mesh = saved


def sync_mesh():
    """The mesh of the innermost `synced` of this thread, or None."""
    return _SYNC.mesh


def mean_over_ranks(t: torch.Tensor, mesh) -> torch.Tensor:
    """The mean over the mesh's ranks of each rank's `t` (differentiable);
    `t` itself without a mesh."""
    return t if mesh is None else psum(t, mesh) / mesh.size


@torch.no_grad()
def update_running_stats(bn: nn.BatchNorm2d, mean: torch.Tensor, var: torch.Tensor,
                         count: int) -> None:
    """In place: running = (1 - m) * running + m * batch, with the unbiased
    batch variance `var * count / (count - 1)` (mdilss_tpu/ops/norm.py:58-63);
    nothing while a region replays (`replaying`)."""
    if _REPLAY.depth:
        return
    unbiased = var.detach() * (count / max(count - 1, 1))
    bn.running_mean.copy_((1.0 - BN_MOMENTUM) * bn.running_mean + BN_MOMENTUM * mean.detach())
    bn.running_var.copy_((1.0 - BN_MOMENTUM) * bn.running_var + BN_MOMENTUM * unbiased)


def batch_norm_train(x: torch.Tensor, bn: nn.BatchNorm2d) -> torch.Tensor:
    """Training-mode BN over (N, H, W) of NCHW `x`: normalise with the biased
    batch variance (two-pass, as mdilss_tpu/ops/norm.py:54-57), of the global
    batch under `synced`, and update `bn`'s running statistics in place.
    Differentiable in x, weight and bias."""
    mesh = sync_mesh()
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    mean = mean_over_ranks(xf.mean((0, 2, 3)), mesh)
    var = mean_over_ranks((xf - mean.view(1, -1, 1, 1)).square().mean((0, 2, 3)), mesh)
    count = x.numel() // x.shape[1] * (1 if mesh is None else mesh.size)
    update_running_stats(bn, mean, var, count)
    inv = torch.rsqrt(var + bn.eps) * bn.weight.to(xf.dtype)
    shift = bn.bias.to(xf.dtype) - mean * inv
    return (xf * inv.view(1, -1, 1, 1) + shift.view(1, -1, 1, 1)).to(x.dtype)
