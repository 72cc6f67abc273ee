"""Channel-wise spatial dropout (torch.nn.Dropout2d) from host keep-masks.

Port of mdilss_tpu/ops/dropout.py: the training step draws the masks on the
host (models/topology.py `make_dropout_masks`), so the same numpy draw gives
the JAX package and the port the same dropped channels. A kept channel is
rescaled by 1/keep.
"""
from __future__ import annotations

import torch


def drop_scale(mask: torch.Tensor, rate: float, dtype=torch.float32) -> torch.Tensor:
    """Keep-mask [N, C] (bool) -> multiplier [N, C, 1, 1]: mask * (1/keep)."""
    return mask.to(dtype).view(mask.shape[0], mask.shape[1], 1, 1) * (1.0 / (1.0 - rate))


def dropout2d(x: torch.Tensor, rate: float, mask: torch.Tensor | None) -> torch.Tensor:
    """x [N, C, H, W] with the channels that `mask` [N, C] drops zeroed; no
    mask or rate 0 is the identity."""
    if mask is None or rate == 0.0:
        return x
    return x * drop_scale(mask, rate, x.dtype)
