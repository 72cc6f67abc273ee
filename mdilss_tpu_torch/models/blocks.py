"""ERFNet building blocks as nn.Modules in the reference state-dict grammar.

Port of mdilss_tpu/models/blocks.py. Parameter and buffer names
follow the reference checkpoints (mdilss_tpu/ckpt/pth_converter.py:240-357),
so a released state dict loads with strict=True:

  * DownsamplerBlock: conv (3x3/s2, nout-nin ch) and a 2x2 max pool,
    concatenated conv first, then BN (per-task `bn_ini.{t}` or shared `bn`),
    relu. The JAX package's space-to-depth form (blocks.py:143-175) is a TPU
    layout trick and is not ported.
  * NonBottleneck1d / NonBottleneck1dRAP: the eval forward is
    ops.nb1d_infer (the inference kernel), the training forward
    ops.nb1d_train_apply (the training conv-pair kernels on CUDA tensors,
    batch-statistics BN, dropout from a host keep-mask).
  * UpsamplerBlock: ConvTranspose2d(3, s2, p1, op1) -> BN -> relu.

In training mode (`module.train()`) every BN normalises with the batch
statistics and updates its running statistics in place, in forward order.

Parameters live in float32; each op casts them to the activation type, as
the JAX convs do (`w.astype(x.dtype)`), so a bf16 forward needs no copy of
the model. Activations are NCHW in torch.channels_last memory format.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.nb1d_infer import nb1d_infer, prepare_operands
from ..ops.nb1d_train import nb1d_train_apply
from ..ops.norm import BN_EPS, batch_norm_eval, batch_norm_train


def _bn(ch: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(ch, eps=BN_EPS)


def _task_bns(ch: int, nb_tasks: int) -> nn.ModuleList:
    return nn.ModuleList([_bn(ch) for _ in range(nb_tasks)])


def _batch_norm(module: nn.Module, x: torch.Tensor, bn: nn.BatchNorm2d) -> torch.Tensor:
    return batch_norm_train(x, bn) if module.training else batch_norm_eval(x, bn)


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
        return F.relu(_batch_norm(self, out, bn))


class _Nb1d(nn.Module):
    """Forward shared by the plain and RAP blocks. Eval: the inference kernel
    (ops.nb1d_infer). Training: ops.nb1d_train_apply, with Dropout2d at
    `dropprob` from the keep-mask `drop_mask` [N, C]; no mask, no dropout."""

    def forward(self, x: torch.Tensor, task: int | None = None,
                drop_mask: torch.Tensor | None = None) -> torch.Tensor:
        if self.training:
            rate = self.dropprob if drop_mask is not None else 0.0
            return nb1d_train_apply(self, x, task, rate, drop_mask)
        x = x.contiguous(memory_format=torch.channels_last)
        return nb1d_infer(x, prepare_operands(self, task, x.dtype), self.dilated)


class NonBottleneck1d(_Nb1d):
    """non_bottleneck_1d (reference models/erfnet.py:26-62); decoders use it."""

    def __init__(self, ch: int, dilated: int, dropprob: float = 0.0):
        super().__init__()
        self.dilated = dilated
        self.dropprob = dropprob
        self.conv3x1_1 = nn.Conv2d(ch, ch, (3, 1), padding=(1, 0))
        self.conv1x3_1 = nn.Conv2d(ch, ch, (1, 3), padding=(0, 1))
        self.bn1 = _bn(ch)
        self.conv3x1_2 = nn.Conv2d(ch, ch, (3, 1), padding=(dilated, 0), dilation=(dilated, 1))
        self.conv1x3_2 = nn.Conv2d(ch, ch, (1, 3), padding=(0, dilated), dilation=(1, dilated))
        self.bn2 = _bn(ch)


class NonBottleneck1dRAP(_Nb1d):
    """non_bottleneck_1d_RAP (reference erfnet_RA_parallel.py:67-113): shared
    convs, per-task parallel 1x1 adapters and per-task BN."""

    def __init__(self, ch: int, dilated: int, nb_tasks: int, dropprob: float = 0.0):
        super().__init__()
        self.dilated = dilated
        self.dropprob = dropprob
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
        return F.relu(_batch_norm(self, _conv_t(x, self.conv), self.bn))
