"""ERFNet-RAP encoder/decoder assembly (port of mdilss_tpu/models/topology.py).

  Encoder: initial_block Down(3->16); layers = Down(16->64); 5x nb1d(64, d=1);
           Down(64->128); 2x [nb1d(128, d) for d in 2, 4, 8, 16]
  Decoder: layers = Up(128->64); 2x nb1d(64, 1); Up(64->16); 2x nb1d(16, 1);
           output_conv = ConvTranspose2d(16 -> num_classes, k2 s2)

The RAP encoder's blocks carry per-task adapters and BN. The layers are a
flat ModuleList in reference order (the JAX package's scan groups are a
compile-time device and are not ported), and the decoder returns spatial
logits (the JAX package's packed head is a TPU layout trick).

Training-mode dropout takes host keep-masks drawn by `make_dropout_masks`,
with the JAX package's shapes and numpy draws, so one np.random.Generator
gives both packages the same masks.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from .blocks import DownsamplerBlock, NonBottleneck1d, NonBottleneck1dRAP, UpsamplerBlock

# (kind, *args): ("down", nin, nout) | ("nb", ch, dropprob, dilated)
ENCODER_PLAN: tuple = (
    ("down", 16, 64),
    *[("nb", 64, 0.03, 1)] * 5,
    ("down", 64, 128),
    *[("nb", 128, 0.3, d) for _ in range(2) for d in (2, 4, 8, 16)],
)

DECODER_PLAN: tuple = (
    ("up", 128, 64),
    ("nb", 64, 0.0, 1),
    ("nb", 64, 0.0, 1),
    ("up", 64, 16),
    ("nb", 16, 0.0, 1),
    ("nb", 16, 0.0, 1),
)

GROUP128_DILATIONS = (2, 4, 8, 16)
KEEP64, KEEP128 = 1 - 0.03, 1 - 0.3  # keep probabilities of the two encoder groups


def dropout_mask_shapes(batch: int) -> dict:
    """Shapes of the encoder's host keep-masks (mdilss_tpu/models/topology.py:146-158):
    g64 for encoder.layers.1-5, g128[rep, j] for encoder.layers.{7 + 4*rep + j}."""
    return {
        "g64": (5, batch, 1, 1, 64),
        "g128": (2, len(GROUP128_DILATIONS), batch, 1, 1, 128),
    }


def make_dropout_masks(np_rng: np.random.Generator, batch: int) -> dict:
    """Bernoulli keep-masks for one training forward, drawn as the JAX package
    draws them (g64 first, then g128)."""
    shapes = dropout_mask_shapes(batch)
    return {
        "g64": np_rng.random(shapes["g64"]) < KEEP64,
        "g128": np_rng.random(shapes["g128"]) < KEEP128,
    }


def layer_drop_masks(drop_masks: dict, device) -> dict[int, torch.Tensor]:
    """`make_dropout_masks` output -> {encoder layer index: keep-mask [N, C]} on `device`."""
    g64 = torch.as_tensor(np.asarray(drop_masks["g64"])).to(device)
    g128 = torch.as_tensor(np.asarray(drop_masks["g128"])).to(device)
    out = {1 + i: g64[i].reshape(g64.shape[1], -1) for i in range(g64.shape[0])}
    for rep in range(g128.shape[0]):
        for j in range(g128.shape[1]):
            out[7 + 4 * rep + j] = g128[rep, j].reshape(g128.shape[2], -1)
    return out


class Encoder(nn.Module):
    """RAP encoder: every BN is per-task (`bn_ini` / `bns_*`)."""

    def __init__(self, nb_tasks: int):
        super().__init__()
        self.initial_block = DownsamplerBlock(3, 16, nb_tasks)
        self.layers = nn.ModuleList([
            DownsamplerBlock(spec[1], spec[2], nb_tasks) if spec[0] == "down"
            else NonBottleneck1dRAP(spec[1], spec[3], nb_tasks, spec[2])
            for spec in ENCODER_PLAN
        ])

    def forward(self, x: torch.Tensor, task: int, drop_masks: dict | None = None) -> torch.Tensor:
        """`drop_masks` (training only): `make_dropout_masks` output, or None
        for no dropout."""
        masks = {} if drop_masks is None or not self.training else layer_drop_masks(
            drop_masks, x.device)
        x = self.initial_block(x, task)
        for i, layer in enumerate(self.layers):
            if isinstance(layer, DownsamplerBlock):
                x = layer(x, task)
            else:
                x = layer(x, task, masks.get(i))
        return x


class Decoder(nn.Module):
    """Per-task decoder head; never carries RAP adapters."""

    def __init__(self, num_classes: int):
        super().__init__()
        self.layers = nn.ModuleList([
            UpsamplerBlock(spec[1], spec[2]) if spec[0] == "up"
            else NonBottleneck1d(spec[1], spec[3], spec[2])
            for spec in DECODER_PLAN
        ])
        self.output_conv = nn.ConvTranspose2d(16, num_classes, 2, stride=2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.layers:
            x = layer(x)
        dt = x.dtype
        return nn.functional.conv_transpose2d(
            x, self.output_conv.weight.to(dt), self.output_conv.bias.to(dt), stride=2
        )
