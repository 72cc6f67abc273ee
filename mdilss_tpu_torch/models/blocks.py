"""ERFNet building blocks as nn.Modules in the reference state-dict grammar.

Port of mdilss_tpu/models/blocks.py (eval mode). Parameter and buffer names
follow the reference checkpoints (mdilss_tpu/ckpt/pth_converter.py:240-357),
so a released state dict loads with strict=True:

  * DownsamplerBlock: conv (3x3/s2, nout-nin ch) and a 2x2 max pool,
    concatenated conv first, then BN (per-task `bn_ini.{t}` or shared `bn`),
    relu. The JAX package's space-to-depth form (blocks.py:143-175) is a TPU
    layout trick and is not ported.
  * NonBottleneck1d / NonBottleneck1dRAP: the eval forward is
    ops.nb1d_infer (the hand-written kernel on CUDA tensors).
  * UpsamplerBlock: ConvTranspose2d(3, s2, p1, op1) -> BN -> relu.

Parameters live in float32; each op casts them to the activation type, as
the JAX convs do (`w.astype(x.dtype)`), so a bf16 forward needs no copy of
the model. Activations are NCHW in torch.channels_last memory format.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.nb1d_infer import nb1d_infer, prepare_operands
from ..ops.norm import BN_EPS, batch_norm_eval


def _bn(ch: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(ch, eps=BN_EPS)


def _task_bns(ch: int, nb_tasks: int) -> nn.ModuleList:
    return nn.ModuleList([_bn(ch) for _ in range(nb_tasks)])


def _conv(x: torch.Tensor, conv: nn.Conv2d) -> torch.Tensor:
    dt = x.dtype
    return F.conv2d(x, conv.weight.to(dt), conv.bias.to(dt), conv.stride, conv.padding,
                    conv.dilation)


def _conv_t(x: torch.Tensor, conv: nn.ConvTranspose2d) -> torch.Tensor:
    dt = x.dtype
    return F.conv_transpose2d(x, conv.weight.to(dt), conv.bias.to(dt), conv.stride,
                              conv.padding, conv.output_padding)


class DownsamplerBlock(nn.Module):
    """`nb_tasks=None`: one shared `bn`; else per-task `bn_ini`."""

    def __init__(self, nin: int, nout: int, nb_tasks: int | None):
        super().__init__()
        self.conv = nn.Conv2d(nin, nout - nin, 3, stride=2, padding=1)
        if nb_tasks is None:
            self.bn = _bn(nout)
        else:
            self.bn_ini = _task_bns(nout, nb_tasks)

    def forward(self, x: torch.Tensor, task: int | None = None) -> torch.Tensor:
        out = torch.cat([_conv(x, self.conv), F.max_pool2d(x, 2, 2)], dim=1)
        bn = self.bn if hasattr(self, "bn") else self.bn_ini[task]
        return F.relu(batch_norm_eval(out, bn))


class _Nb1dInfer(nn.Module):
    """Eval forward shared by the plain and RAP blocks: the hand-written
    kernel on CUDA tensors (ops.nb1d_infer)."""

    def forward(self, x: torch.Tensor, task: int | None = None) -> torch.Tensor:
        x = x.contiguous(memory_format=torch.channels_last)
        return nb1d_infer(x, prepare_operands(self, task, x.dtype), self.dilated)


class NonBottleneck1d(_Nb1dInfer):
    """non_bottleneck_1d (reference models/erfnet.py:26-62); decoders use it."""

    def __init__(self, ch: int, dilated: int):
        super().__init__()
        self.dilated = dilated
        self.conv3x1_1 = nn.Conv2d(ch, ch, (3, 1), padding=(1, 0))
        self.conv1x3_1 = nn.Conv2d(ch, ch, (1, 3), padding=(0, 1))
        self.bn1 = _bn(ch)
        self.conv3x1_2 = nn.Conv2d(ch, ch, (3, 1), padding=(dilated, 0), dilation=(dilated, 1))
        self.conv1x3_2 = nn.Conv2d(ch, ch, (1, 3), padding=(0, dilated), dilation=(1, dilated))
        self.bn2 = _bn(ch)


class NonBottleneck1dRAP(_Nb1dInfer):
    """non_bottleneck_1d_RAP (reference erfnet_RA_parallel.py:67-113): shared
    convs, per-task parallel 1x1 adapters and per-task BN."""

    def __init__(self, ch: int, dilated: int, nb_tasks: int):
        super().__init__()
        self.dilated = dilated
        self.conv3x1_1 = nn.Conv2d(ch, ch, (3, 1), padding=(1, 0))
        self.conv1x3_1 = nn.Conv2d(ch, ch, (1, 3), padding=(0, 1))
        self.parallel_conv_1 = nn.ModuleList([nn.Conv2d(ch, ch, 1) for _ in range(nb_tasks)])
        self.bns_1 = _task_bns(ch, nb_tasks)
        self.conv3x1_2 = nn.Conv2d(ch, ch, (3, 1), padding=(dilated, 0), dilation=(dilated, 1))
        self.conv1x3_2 = nn.Conv2d(ch, ch, (1, 3), padding=(0, dilated), dilation=(1, dilated))
        self.parallel_conv_2 = nn.ModuleList([nn.Conv2d(ch, ch, 1) for _ in range(nb_tasks)])
        self.bns_2 = _task_bns(ch, nb_tasks)


class UpsamplerBlock(nn.Module):
    def __init__(self, nin: int, nout: int):
        super().__init__()
        self.conv = nn.ConvTranspose2d(nin, nout, 3, stride=2, padding=1, output_padding=1)
        self.bn = _bn(nout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(batch_norm_eval(_conv_t(x, self.conv), self.bn))
