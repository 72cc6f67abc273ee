"""ERFNet-RAP: shared encoder convs + per-task RAP adapters and BN, and one
decoder per task (port of mdilss_tpu/models/erfnet_rap.py; reference
erfnet_RA_parallel.py:194-212).

The task is a plain int argument of `forward`; there is no module-global
`current_task`. In eval mode (the default) the forward runs under no_grad
on the inference kernel; in training mode (`model.train()`) it runs with
autograd, batch-statistics BN that updates the task's running statistics in
place, and dropout from host keep-masks.
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from .. import resolve_device
from .topology import Decoder, Encoder


class ERFNetRAP(nn.Module):
    """`ERFNetRAP([20, 20, 27], 3)` builds the 3-task model on the CUDA card
    (`device="cpu"` to build it on the CPU). Weights are torch's default
    initialisation from the global RNG, made on the CPU, so one seed gives
    the same weights on every device. The model starts in eval mode."""

    def __init__(self, num_classes: Sequence[int], nb_tasks: int, device=None):
        super().__init__()
        if len(num_classes) != nb_tasks:
            raise ValueError(f"{len(num_classes)} class counts for {nb_tasks} tasks")
        dev = resolve_device(device)
        self.encoder = Encoder(nb_tasks)
        self.decoder = nn.ModuleList([Decoder(nc) for nc in num_classes])
        self.to(dev)
        self.eval()

    def forward(self, x_nhwc: torch.Tensor, task: int, drop_masks: dict | None = None) -> torch.Tensor:
        """x [N, H, W, 3] -> logits [N, H, W, num_classes[task]] in x's type
        (H and W multiples of 8). `drop_masks` (training mode only):
        `topology.make_dropout_masks` output, or None for no dropout, as
        `erfnet_rap.apply(training=True, rng=None)`."""
        if not 0 <= task < len(self.decoder):
            raise IndexError(f"task {task} out of range for {len(self.decoder)} heads")
        if self.training:
            return self._forward(x_nhwc, task, drop_masks)
        with torch.no_grad():
            return self._forward(x_nhwc, task, None)

    def _forward(self, x_nhwc: torch.Tensor, task: int, drop_masks: dict | None) -> torch.Tensor:
        x = x_nhwc.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        feats = self.encoder(x, task, drop_masks)
        return self.decoder[task](feats).permute(0, 2, 3, 1)
