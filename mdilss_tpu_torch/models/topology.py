"""ERFNet-RAP encoder/decoder assembly (port of mdilss_tpu/models/topology.py).

  Encoder: initial_block Down(3->16); layers = Down(16->64); 5x nb1d(64, d=1);
           Down(64->128); 2x [nb1d(128, d) for d in 2, 4, 8, 16]
  Decoder: layers = Up(128->64); 2x nb1d(64, 1); Up(64->16); 2x nb1d(16, 1);
           output_conv = ConvTranspose2d(16 -> num_classes, k2 s2)

The RAP encoder's blocks carry per-task adapters and BN. The layers are a
flat ModuleList in reference order (the JAX package's scan groups are a
compile-time device and are not ported), and the decoder returns spatial
logits (the JAX package's packed head is a TPU layout trick).
"""
from __future__ import annotations

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


class Encoder(nn.Module):
    """RAP encoder: every BN is per-task (`bn_ini` / `bns_*`)."""

    def __init__(self, nb_tasks: int):
        super().__init__()
        self.initial_block = DownsamplerBlock(3, 16, nb_tasks)
        self.layers = nn.ModuleList([
            DownsamplerBlock(spec[1], spec[2], nb_tasks) if spec[0] == "down"
            else NonBottleneck1dRAP(spec[1], spec[3], nb_tasks)
            for spec in ENCODER_PLAN
        ])

    def forward(self, x: torch.Tensor, task: int) -> torch.Tensor:
        x = self.initial_block(x, task)
        for layer in self.layers:
            x = layer(x, task)
        return x


class Decoder(nn.Module):
    """Per-task decoder head; never carries RAP adapters."""

    def __init__(self, num_classes: int):
        super().__init__()
        self.layers = nn.ModuleList([
            UpsamplerBlock(spec[1], spec[2]) if spec[0] == "up"
            else NonBottleneck1d(spec[1], spec[3])
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
