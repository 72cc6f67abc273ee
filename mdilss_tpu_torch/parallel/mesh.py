"""Data- and spatial-parallel training over processes: the port's
counterpart of mdilss_tpu/parallel/mesh.py's ('data', 'spatial') mesh.

The JAX package runs one jitted step over a device mesh: the batch is sharded
over the `data` axis, the parameters and optimizer state are replicated, and
XLA inserts the gradient all-reduce and the global BN statistics. The port
runs one process per card (launched by `torchrun`, which sets `RANK`,
`WORLD_SIZE` and `LOCAL_RANK`) and makes those collectives explicit:

  * `make_mesh` joins the process group (NCCL on the card, gloo on the CPU)
    and takes the first D * S ranks as the mesh, S = `spatial` and D =
    gcd(batch, world / S), as mdilss_tpu/train/loop.py:245-256 clamps the
    data axis to divide the batch; rank r sits at data index r // S and
    spatial index r % S, JAX's `reshape(data, spatial)` order;
  * `replicate` broadcasts a module's parameters and buffers from rank 0;
  * `shard_rows` takes the contiguous block of a global batch of this
    rank's data index, `shard_height` its spatial index's block of image
    rows (images and labels are sharded P("data", "spatial"));
  * `psum` is a differentiable all-reduce (SUM forward and backward) over
    every rank of the mesh, which the sync-BN of `ops.norm.synced` and the
    losses use;
  * `all_reduce_grads` sums the step's gradients over every rank in one
    coalesced collective;
  * the convs' row halos go over the spatial group of the rank's data index
    (`parallel.halo`).

The steps take their gradients with `torch.autograd.grad`, which bypasses
`DistributedDataParallel`'s hooks: the collectives here are the only ones.
Without `WORLD_SIZE` in the environment (and no process group made by the
caller) `make_mesh` returns D = 1 and no group, and every function here is
the identity: the single-process path, unchanged.
"""
from __future__ import annotations

import dataclasses
import functools
import math
import os

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The mesh of this process. `group` (every rank of the mesh, ranks 0 ..
    data * spatial - 1) is None for the single-process path (no
    collectives) and on the ranks outside the mesh (`member` False), which
    train nothing. `rank` is this process's rank in the world and in the
    mesh; `data` is D and `spatial` S. `spatial_group` holds the S ranks of
    this rank's data index (None for S = 1), `data_group` the D ranks of its
    spatial index (`group` itself for S = 1; None for D = 1). `checked`
    holds the patterns of None gradients every rank was seen to share
    (`all_reduce_grads`)."""

    group: object
    rank: int
    world: int
    data: int
    device: torch.device
    member: bool = True
    spatial: int = 1
    spatial_group: object = None
    data_group: object = None
    checked: set = dataclasses.field(default_factory=set, compare=False, repr=False)

    @property
    def active(self) -> bool:
        return self.group is not None

    @property
    def size(self) -> int:
        """The ranks of the mesh, D * S."""
        return self.data * self.spatial

    @property
    def data_index(self) -> int:
        return self.rank // self.spatial

    @property
    def spatial_index(self) -> int:
        return self.rank % self.spatial


def active(mesh: Mesh | None) -> Mesh | None:
    """`mesh` when its collectives run, else None."""
    return mesh if mesh is not None and mesh.active else None


def _device(device, local_rank: int) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", local_rank)
    return dev


def _check_spatial(spatial: int, world: int) -> None:
    if spatial < 1 or world % spatial:
        raise ValueError(f"--spatial-shards {spatial} must divide the device count "
                         f"({world} visible: one process per device)")


def make_mesh(batch_size: int, *, spatial: int = 1, device,
              backend: str | None = None) -> Mesh:
    """The (data, spatial) mesh of a global batch of `batch_size` on this
    process.

    Joins the process group from torchrun's environment (`RANK`,
    `WORLD_SIZE`, `LOCAL_RANK`, `MASTER_ADDR`, `MASTER_PORT`) unless the
    caller has made one already; `backend` None -> "nccl" for a CUDA device,
    "gloo" for the CPU. A CUDA `device` without an index becomes
    cuda:LOCAL_RANK. `spatial` must divide the world (JAX's ValueError);
    the mesh is the first D * S ranks, D = gcd(batch_size, world / S).
    Neither an environment nor a group -> a world of one: D = S = 1 and no
    group. Every rank makes the same groups in the same order."""
    if not dist.is_initialized():
        if "WORLD_SIZE" not in os.environ:
            _check_spatial(spatial, 1)
            return Mesh(None, 0, 1, 1, torch.device(device))
        _check_spatial(spatial, int(os.environ["WORLD_SIZE"]))
        rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
        dev = _device(device, int(os.environ.get("LOCAL_RANK", rank)))
        backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(backend, init_method="env://", rank=rank, world_size=world,
                                device_id=dev if backend == "nccl" else None)
    else:
        rank, world = dist.get_rank(), dist.get_world_size()
        _check_spatial(spatial, world)
        dev = _device(device, int(os.environ.get("LOCAL_RANK", 0)))
    data = math.gcd(batch_size, world // spatial)
    size = data * spatial
    group = dist.group.WORLD if size == world else dist.new_group(list(range(size)))
    member = rank < size
    spatial_group = data_group = None
    if spatial > 1:
        rows = [dist.new_group([i * spatial + j for j in range(spatial)]) for i in range(data)]
        cols = [dist.new_group([i * spatial + j for i in range(data)])
                for j in range(spatial)] if data > 1 else []
        if member:
            spatial_group = rows[rank // spatial]
            data_group = cols[rank % spatial] if data > 1 else None
    elif data > 1:
        data_group = group
    if not member:
        return Mesh(None, rank, world, data, dev, False, spatial)
    return Mesh(group, rank, world, data, dev, True, spatial, spatial_group, data_group)


def replicate(module: torch.nn.Module, mesh: Mesh | None) -> torch.nn.Module:
    """Broadcast `module`'s parameters and buffers from rank 0 over the
    mesh, in place (JAX's `replicate`); returns the module."""
    if active(mesh):
        with torch.no_grad():
            for t in [*module.parameters(), *module.buffers()]:
                dist.broadcast(t.data, src=0, group=mesh.group)
    return module


def _block(x, axis: int, i: int, parts: int, what: str):
    n = x.shape[axis]
    if n % parts:
        raise ValueError(f"{what} of {n} does not split over {parts} ranks")
    b = n // parts
    index = [slice(None)] * x.ndim
    index[axis] = slice(i * b, (i + 1) * b)
    return x[tuple(index)]


def shard_rows(x, mesh: Mesh | None, axis: int = 0):
    """The contiguous block of the global batch `x` (a tensor or a numpy
    array) along `axis` of this rank's data index, which D must divide."""
    if mesh is None or mesh.data == 1:
        return x
    return _block(x, axis, mesh.data_index, mesh.data, "a batch")


def shard_height(x, mesh: Mesh | None, axis: int):
    """The contiguous block of image rows of `x` along its height `axis` of
    this rank's spatial index, which S must divide (images [N, H, W, 3] and
    labels [N, H, W]: axis 1)."""
    if mesh is None or mesh.spatial == 1:
        return x
    return _block(x, axis, mesh.spatial_index, mesh.spatial, "a height")


def all_reduce_(t: torch.Tensor, mesh: Mesh | None, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """`op` (SUM) of `t` over the mesh, in place (no gradient); returns `t`."""
    if active(mesh):
        dist.all_reduce(t, op=op, group=mesh.group)
    return t


class _PSum(torch.autograd.Function):
    """y = sum over the ranks of x; the gradient of each rank's x is the sum
    over the ranks of the gradients of y (each rank's loss is its share of
    the global loss)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        return g, None


def psum(x: torch.Tensor, mesh: Mesh | None) -> torch.Tensor:
    """Differentiable SUM of `x` over the mesh (`x` itself without one)."""
    return _PSum.apply(x, mesh.group) if active(mesh) else x


def all_reduce_grads(grads: dict, mesh: Mesh | None) -> dict:
    """{name: grad or None} -> the same with every gradient summed over the
    mesh, in one collective over a flat buffer (of the gradients' widest
    type: float32 for the steps' float32 parameters). The first time
    a step shows a pattern of None gradients, a collective of that pattern
    comes first: every rank must hold the same one."""
    if not active(mesh):
        return grads
    live = [(k, g) for k, g in grads.items() if g is not None]
    pattern = tuple(g is not None for g in grads.values())
    dev = live[0][1].device
    if pattern not in mesh.checked:
        seen = all_reduce_(torch.tensor(pattern, dtype=torch.int32, device=dev), mesh).cpu()
        if not torch.equal(seen, torch.tensor(pattern, dtype=torch.int32) * mesh.size):
            raise RuntimeError("the ranks' gradients differ in which parameters the loss "
                               "reaches: their steps are not the same computation")
        mesh.checked.add(pattern)
    dt = functools.reduce(torch.promote_types, (g.dtype for _, g in live))
    flat = torch.cat([g.reshape(-1).to(dt) for _, g in live])
    dist.all_reduce(flat, group=mesh.group)
    out, o = dict(grads), 0
    for k, g in live:
        out[k] = flat[o:o + g.numel()].view(g.shape).to(g.dtype)
        o += g.numel()
    return out


def barrier(mesh: Mesh | None) -> None:
    """Wait until every rank of the mesh gets here."""
    if active(mesh):
        if mesh.device.type == "cuda" and dist.get_backend(mesh.group) == "nccl":
            dist.barrier(group=mesh.group, device_ids=[mesh.device.index])
        else:
            dist.barrier(group=mesh.group)


def broadcast_object(obj, mesh: Mesh | None):
    """Rank 0's `obj` on every rank of the world (the ranks outside the mesh
    included); `obj` itself in a single process."""
    if mesh is None or mesh.world == 1 or not dist.is_initialized():
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]
