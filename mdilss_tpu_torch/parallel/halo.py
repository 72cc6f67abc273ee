"""Row halos of the spatial axis: the port's counterpart of the
collective-permutes that XLA inserts around every conv of an image whose
rows are sharded over the mesh's `spatial` axis (mdilss_tpu/parallel/mesh.py,
`P("data", "spatial")`).

A rank holds h rows of each image, rows s*h .. (s+1)*h - 1 for spatial index
s of S. A conv with vertical extent needs some rows of its neighbours above
and below: `exchange(x, top, bottom, mesh)` returns x with up to `top` true
rows above it and up to `bottom` below it, fewer where the image ends (there
the kernel or conv zero-pads, as it does at the edge of the whole image), and
the counts it added. A halo may be longer than a slab: it then takes rows of
ranks further away. `exchange_adjoint` is its backward: each halo row's
gradient goes back to the rank that owns the row and is added there. `halo`
is the differentiable form, and `pad_rows` the same with zero rows at the
image's edge, so that a conv with no vertical padding of its own sees the
whole image's zero padding.

Both directions are collectives over the spatial group of the rank's data
index, built on all-gather and all-reduce (which gloo runs on CUDA tensors
as well; it has no send / recv of them): the forward gathers a band of each
slab (its first `bottom` and last `top` rows, or the whole slab where a halo
reaches past a neighbour), the backward sums an [S, band] buffer of the
gradients each rank owes every other. Every rank of the group makes the
same calls in the same order, in the thread that runs the forward or the
backward, so a rematerialised region's replay issues them again in step.

`CALLS` and `BYTES` count the collectives and the bytes of their buffers
(the gathered bands, the summed gradient buffers) on this rank.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

CALLS = 0
BYTES = 0


def spatial_of(mesh):
    """`mesh` when it shards image rows (an active mesh with S > 1), else None."""
    return mesh if mesh is not None and mesh.active and mesh.spatial > 1 else None


def halo_rows(h: int, top: int, bottom: int, mesh) -> tuple[int, int]:
    """(rows above, rows below) that `exchange` adds to a slab of `h` rows:
    `top` and `bottom` clipped at the image's edges."""
    s, n = mesh.spatial_index, mesh.spatial
    return min(top, s * h), min(bottom, (n - 1 - s) * h)


def _band(h: int, top: int, bottom: int) -> tuple[int, int] | None:
    """(first rows, last rows) of each slab that the halos read, or None for
    the whole slab (a halo that reaches past the neighbour, or bands that
    cover the slab)."""
    kb, kt = min(bottom, h), min(top, h)
    return None if kb + kt >= h else (kb, kt)


def _count(nbytes: int) -> None:
    global CALLS, BYTES
    CALLS += 1
    BYTES += nbytes


def _gather(band: torch.Tensor, mesh) -> list[torch.Tensor]:
    band = band.contiguous()
    parts = [torch.empty_like(band) for _ in range(mesh.spatial)]
    dist.all_gather(parts, band, group=mesh.spatial_group)
    _count(mesh.spatial * band.numel() * band.element_size())
    return parts


def exchange(x: torch.Tensor, top: int, bottom: int, mesh):
    """x [N, C, h, W] (NCHW, any memory format) -> (x with its halo rows,
    channels_last; rows added above, rows added below). No gradient."""
    h = x.shape[2]
    up, down = halo_rows(h, top, bottom, mesh)
    s = mesh.spatial_index
    band = _band(h, top, bottom)
    with torch.no_grad():
        if band is None:
            full = torch.cat(_gather(x, mesh), dim=2)
            above = full[:, :, s * h - up:s * h]
            below = full[:, :, (s + 1) * h:(s + 1) * h + down]
        else:
            kb, kt = band
            parts = _gather(torch.cat([x[:, :, :kb], x[:, :, h - kt:]], dim=2), mesh)
            above = parts[s - 1][:, :, kb + kt - up:] if up else x[:, :, :0]
            below = parts[s + 1][:, :, :down] if down else x[:, :, :0]
        out = torch.cat([above, x, below], dim=2)
    return out.contiguous(memory_format=torch.channels_last), up, down


def exchange_adjoint(g: torch.Tensor, h: int, top: int, bottom: int, mesh) -> torch.Tensor:
    """The gradient of `exchange(x, top, bottom, mesh)[0]` for a slab x of
    `h` rows -> the gradient of x: g's own rows plus the gradients of this
    slab's rows that the other ranks' halos received (summed in at least
    float32, then rounded to g's type once), channels_last. No gradient."""
    n, c, _, w = g.shape
    up, down = halo_rows(h, top, bottom, mesh)
    s, ns = mesh.spatial_index, mesh.spatial
    band = _band(h, top, bottom)
    acc = torch.promote_types(g.dtype, torch.float32)
    with torch.no_grad():
        if band is None:  # the gradients owed to every row of the image, summed
            owed = torch.zeros(n, c, ns * h, w, dtype=acc, device=g.device)
            owed[:, :, s * h - up:s * h] = g[:, :, :up]
            owed[:, :, (s + 1) * h:(s + 1) * h + down] = g[:, :, up + h:]
        else:  # [S, the band of each slab]
            kb, kt = band
            owed = torch.zeros(ns, n, c, kb + kt, w, dtype=acc, device=g.device)
            if up:
                owed[s - 1, :, :, kb + kt - up:] = g[:, :, :up]
            if down:
                owed[s + 1, :, :, :down] = g[:, :, up + h:]
        dist.all_reduce(owed, group=mesh.spatial_group)
        _count(owed.numel() * owed.element_size())
        dx = g[:, :, up:up + h].to(acc)
        if band is None:
            dx = dx + owed[:, :, s * h:(s + 1) * h]
        else:
            kb, kt = band
            dx[:, :, :kb] += owed[s, :, :, :kb]
            dx[:, :, h - kt:] += owed[s, :, :, kb:]
    return dx.to(g.dtype).contiguous(memory_format=torch.channels_last)


class _Halo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, top, bottom, mesh):
        out, up, down = exchange(x, top, bottom, mesh)
        ctx.h, ctx.top, ctx.bottom, ctx.mesh = x.shape[2], top, bottom, mesh
        return out

    @staticmethod
    def backward(ctx, g):
        return exchange_adjoint(g, ctx.h, ctx.top, ctx.bottom, ctx.mesh), None, None, None


def halo(x: torch.Tensor, top: int, bottom: int, mesh) -> torch.Tensor:
    """Differentiable `exchange(x, top, bottom, mesh)[0]`: x with up to `top`
    true rows of its neighbours above and `bottom` below, none past the
    image's edge."""
    return _Halo.apply(x, top, bottom, mesh)


def pad_rows(x: torch.Tensor, top: int, bottom: int, mesh) -> torch.Tensor:
    """Differentiable: x with exactly `top` rows above and `bottom` below,
    its neighbours' where they exist and zeros past the image's edge, as the
    whole image's zero padding; channels_last."""
    up, down = halo_rows(x.shape[2], top, bottom, mesh)
    out = halo(x, top, bottom, mesh)
    if (up, down) != (top, bottom):
        out = torch.nn.functional.pad(out, (0, 0, top - up, bottom - down))
    return out.contiguous(memory_format=torch.channels_last)
