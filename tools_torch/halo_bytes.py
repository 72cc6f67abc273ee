#!/usr/bin/env python3
"""The row-halo traffic of one sharded fp32 step-2 step of the port, counted on
the CPU (gloo, one thread per rank) by `parallel/halo.py`'s counters.

    python -m torch.distributed.run --standalone --nproc_per_node 2 \\
        tools_torch/halo_bytes.py [--batch 6] [--height 512] [--width 64] [--scale-to 1024]

Runs `chip_smoke.py`'s step-2 cell (student [20, 20], eval-mode teacher [20],
BDD weights) on a mesh of `--spatial` 2 over the processes (2: 1x2; 4: 2x2)
at batch x height x width and prints, per rank, the halo collectives and the
bytes of their buffers (`halo.CALLS`, `halo.BYTES`) of the step. The buffers
are [N, C, rows, W] bands, so the bytes grow with N and W alone (not with H:
whether a halo takes bands or whole slabs depends on the rows); with
`--scale-to`, it also prints the bytes at that width. Run it from the
repository root.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

torch.set_num_threads(1)


def main(argv=None) -> int:
    from mdilss_tpu_torch.data.class_weights import CLASS_WEIGHTS
    from mdilss_tpu_torch.models import ERFNetRAP
    from mdilss_tpu_torch.models.topology import make_dropout_masks, shard_dropout_masks
    from mdilss_tpu_torch.parallel import halo as H
    from mdilss_tpu_torch.parallel import make_mesh, shard_height, shard_rows
    from mdilss_tpu_torch.train import steps
    from mdilss_tpu_torch.train.masks import rap_lr_tree

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=6)
    ap.add_argument("--height", type=int, default=512)
    ap.add_argument("--width", type=int, default=64)
    ap.add_argument("--spatial", type=int, default=2)
    ap.add_argument("--scale-to", type=int, default=None)
    args = ap.parse_args(argv)
    mesh = make_mesh(args.batch, spatial=args.spatial, device="cpu")
    torch.manual_seed(0)
    student = ERFNetRAP([20, 20], 2, device="cpu")
    teacher = ERFNetRAP([20], 1, device="cpu")
    rng = np.random.default_rng(0)
    n, h, w = args.batch, args.height, args.width
    x = torch.from_numpy(rng.random((n, h, w, 3), dtype=np.float32))
    y = torch.from_numpy(rng.integers(0, 20, (n, h, w)))
    masks = [shard_dropout_masks(make_dropout_masks(rng, n), mesh) for _ in range(2)]
    lr = rap_lr_tree(student, current_task=1, shared_lr=5e-6, ds_lr=5e-4)
    step = steps.make_distill_step(current_task=1, prev_tasks=(0,),
                                   class_weight=CLASS_WEIGHTS["BDD"], lr_tree=lr,
                                   num_epochs=150, mesh=mesh)
    H.CALLS = H.BYTES = 0
    step(steps.init_train_state(student), teacher, shard_height(shard_rows(x, mesh), mesh, 1),
         shard_height(shard_rows(y, mesh), mesh, 1), masks, 1)
    line = (f"rank {mesh.rank} of a {mesh.data}x{mesh.spatial} mesh, {n}x{h}x{w}: "
            f"{H.CALLS} halo collectives, {H.BYTES} bytes")
    if args.scale_to:
        line += f"; at width {args.scale_to}: {H.BYTES * args.scale_to // w} bytes"
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
