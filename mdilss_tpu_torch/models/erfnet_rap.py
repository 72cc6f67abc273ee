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

import contextlib
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
        self._assemble(num_classes, nb_tasks, None, device)

    def _assemble(self, num_classes, nb_tasks: int, variant: str | None, device) -> None:
        if len(num_classes) != nb_tasks:
            raise ValueError(f"{len(num_classes)} class counts for {nb_tasks} tasks")
        dev = resolve_device(device)
        self.encoder = Encoder(nb_tasks, variant)
        self.decoder = nn.ModuleList([Decoder(nc) for nc in num_classes])
        self.to(dev)
        self.eval()

    def forward(self, x_nhwc: torch.Tensor, task: int, drop_masks: dict | None = None,
                return_features: bool = False):
        """x [N, H, W, 3] -> logits [N, H, W, num_classes[task]] in x's type
        (H and W multiples of 8). `drop_masks` (training mode only):
        `topology.make_dropout_masks` output, or None for no dropout, as
        `erfnet_rap.apply(training=True, rng=None)`. `return_features=True`
        returns (logits, {"encoder": [N, H/8, W/8, 128], "penultimate":
        [N, H/2, W/2, 16]}), NHWC, as `erfnet_rap.apply(return_features=True)`
        (in eval mode the encoder features are the last nb1d kernel's output)."""
        if not 0 <= task < len(self.decoder):
            raise IndexError(f"task {task} out of range for {len(self.decoder)} heads")
        if self.training:
            return self._forward(x_nhwc, task, drop_masks, return_features)
        with grad_off():
            return self._forward(x_nhwc, task, None, return_features)

    def _forward(self, x_nhwc: torch.Tensor, task: int, drop_masks: dict | None,
                 return_features: bool):
        x = x_nhwc.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        feats = self.encoder(x, task, drop_masks)
        return head_output(self.decoder[task], feats, return_features)


def grad_off():
    """no_grad, or nothing when grad is already off (torch.export records every
    grad-mode switch, and a head is exported with grad off)."""
    return torch.no_grad() if torch.is_grad_enabled() else contextlib.nullcontext()


def head_output(head: nn.Module, feats: torch.Tensor, return_features: bool):
    """A decoder head on the encoder's features -> NHWC logits, or (logits,
    {"encoder", "penultimate"} NHWC) with `return_features`."""
    if not return_features:
        return head(feats).permute(0, 2, 3, 1)
    logits, penultimate = head(feats, return_penultimate=True)
    nhwc = lambda t: t.permute(0, 2, 3, 1)  # noqa: E731
    return nhwc(logits), {"encoder": nhwc(feats), "penultimate": nhwc(penultimate)}
