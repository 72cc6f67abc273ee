from .mesh import (
    Mesh,
    active,
    all_reduce_,
    all_reduce_grads,
    barrier,
    broadcast_object,
    make_mesh,
    psum,
    replicate,
    shard_height,
    shard_rows,
)

__all__ = [
    "Mesh",
    "active",
    "make_mesh",
    "replicate",
    "shard_rows",
    "shard_height",
    "all_reduce_",
    "psum",
    "all_reduce_grads",
    "barrier",
    "broadcast_object",
]
