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
  * NonBottleneck1dAblation: the four ablation variants' encoder block
    (mdilss_tpu/models/blocks.py:283-346), plain F.conv2d and BN in eval and
    in training: the JAX package runs them on XLA only, with no kernel.
  * UpsamplerBlock: ConvTranspose2d(3, s2, p1, op1) -> BN -> relu.

In training mode (`module.train()`) every BN normalises with the batch
statistics and updates its running statistics in place, in forward order.

On a spatial mesh (`ops.norm.synced` with S > 1, each rank a slab of each
image's rows) every plain conv with vertical extent takes the rows it reads
of its neighbours (`parallel.halo.pad_rows`, zero rows past the image's
edge) and convolves with no vertical padding of its own: the downsampler's
3x3 s2 conv 1 row above, the upsampler's transposed 3x3 s2 conv 1 row below,
an ablation block's 3x1 convs d rows each side. The nb1d kernels' wrappers
take their own halos (`ops.nb1d_infer`, `ops.nb1d_train`); the 2x2 max pool,
the 1x1 convs and the head's k2s2 transposed conv need none.

Parameters live in float32; each op casts them to the activation type, as
the JAX convs do (`w.astype(x.dtype)`), so a bf16 forward needs no copy of
the model. Activations are NCHW in torch.channels_last memory format.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.dropout import dropout2d
from ..ops.nb1d_infer import nb1d_infer, prepare_operands
from ..ops.nb1d_train import nb1d_train_apply
from ..ops.norm import BN_EPS, batch_norm_eval, batch_norm_train, sync_mesh
from ..parallel.halo import pad_rows, spatial_of


def _bn(ch: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(ch, eps=BN_EPS)


def _task_bns(ch: int, nb_tasks: int) -> nn.ModuleList:
    return nn.ModuleList([_bn(ch) for _ in range(nb_tasks)])


def _batch_norm(module: nn.Module, x: torch.Tensor, bn: nn.BatchNorm2d) -> torch.Tensor:
    return batch_norm_train(x, bn) if module.training else batch_norm_eval(x, bn)


def _conv(x: torch.Tensor, conv: nn.Conv2d) -> torch.Tensor:
    """`conv` in x's type; on a spatial mesh with the rows its output rows
    read above (its padding) and below the slab."""
    dt = x.dtype
    w, b = conv.weight.to(dt), conv.bias.to(dt)
    (kh, _), (sh, _), (ph, pw), (dh, _) = (conv.kernel_size, conv.stride, conv.padding,
                                           conv.dilation)
    sp = spatial_of(sync_mesh())
    bottom = (kh - 1) * dh - ph - sh + 1
    if sp is None or ph == bottom == 0:
        return F.conv2d(x, w, b, conv.stride, conv.padding, conv.dilation)
    return F.conv2d(pad_rows(x, ph, bottom, sp), w, b, conv.stride, (0, pw), conv.dilation)


def _conv_t(x: torch.Tensor, conv: nn.ConvTranspose2d) -> torch.Tensor:
    """`conv` in x's type; on a spatial mesh with the input rows above and
    below the slab that its output rows receive from, cropped to the
    slab's output rows."""
    dt = x.dtype
    w, b = conv.weight.to(dt), conv.bias.to(dt)
    (kh, _), (sh, _), (ph, _), (dh, _) = (conv.kernel_size, conv.stride, conv.padding,
                                          conv.dilation)
    sp = spatial_of(sync_mesh())
    top, bottom = max(0, ((kh - 1) * dh - ph) // sh), (ph - 1) // sh + 1
    if sp is None or top == bottom == 0:
        return F.conv_transpose2d(x, w, b, conv.stride, conv.padding, conv.output_padding)
    h = x.shape[2]
    out = F.conv_transpose2d(pad_rows(x, top, bottom, sp), w, b, conv.stride, conv.padding,
                             conv.output_padding)
    return out[:, :, top * sh:(top + h) * sh].contiguous(memory_format=torch.channels_last)


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


ABLATION_VARIANTS = ("bn", "onlyrap", "ras", "rcm")
# the variants whose BN (the downsamplers' `bn_ini` too) is per task; onlyrap's is shared
PER_TASK_BN_VARIANTS = ("bn", "ras", "rcm")


class NonBottleneck1dAblation(nn.Module):
    """An ablation variant's nb1d block (mdilss_tpu/models/blocks.py:240-346):
    the shared conv pairs of non_bottleneck_1d, and per variant

      bn       per-task BN `bns_{1,2}.{t}`, no adapter
      onlyrap  shared BN `bn1` / `bn2`; out + parallel_conv_k.{t}(segment input)
      ras      per-task BN; out + series_conv_k.{t}(out)
      rcm      per-task BN; out @ Wt_k.{t} over channels, Wt [C_in, C_out]
               (JAX's orientation), identity at init, no bias

    where each adapter acts on conv pair k's output before its BN, and the
    segment input is x for pair 1 and mid = relu(BN1(...)) for pair 2. Its
    forward is plain PyTorch (F.conv2d, ops.norm BN, dropout from the host
    keep-mask) in eval and in training: the JAX package has no kernel for
    these blocks (mdilss_tpu/models/topology.py:197-200)."""

    def __init__(self, ch: int, dilated: int, nb_tasks: int, variant: str,
                 dropprob: float = 0.0):
        super().__init__()
        if variant not in ABLATION_VARIANTS:
            raise ValueError(f"unknown ablation variant {variant!r}: one of {ABLATION_VARIANTS}")
        self.variant = variant
        self.dilated = dilated
        self.dropprob = dropprob
        self.conv3x1_1 = nn.Conv2d(ch, ch, (3, 1), padding=(1, 0))
        self.conv1x3_1 = nn.Conv2d(ch, ch, (1, 3), padding=(0, 1))
        self.conv3x1_2 = nn.Conv2d(ch, ch, (3, 1), padding=(dilated, 0), dilation=(dilated, 1))
        self.conv1x3_2 = nn.Conv2d(ch, ch, (1, 3), padding=(0, dilated), dilation=(1, dilated))
        if variant in PER_TASK_BN_VARIANTS:
            self.bns_1, self.bns_2 = _task_bns(ch, nb_tasks), _task_bns(ch, nb_tasks)
        else:
            self.bn1, self.bn2 = _bn(ch), _bn(ch)
        if variant in ("onlyrap", "ras"):
            name = "parallel_conv" if variant == "onlyrap" else "series_conv"
            for k in (1, 2):
                setattr(self, f"{name}_{k}",
                        nn.ModuleList([nn.Conv2d(ch, ch, 1) for _ in range(nb_tasks)]))
        elif variant == "rcm":
            for k in (1, 2):
                setattr(self, f"Wt_{k}", nn.ParameterList(
                    [nn.Parameter(torch.eye(ch)) for _ in range(nb_tasks)]))

    def _bn_of(self, k: int, task: int) -> nn.BatchNorm2d:
        if self.variant in PER_TASK_BN_VARIANTS:
            return getattr(self, f"bns_{k}")[task]
        return getattr(self, f"bn{k}")

    def _adapt(self, out: torch.Tensor, seg_in: torch.Tensor, k: int, task: int):
        if self.variant == "onlyrap":
            return out + _conv(seg_in, getattr(self, f"parallel_conv_{k}")[task])
        if self.variant == "ras":
            return out + _conv(out, getattr(self, f"series_conv_{k}")[task])
        if self.variant == "rcm":
            wt = getattr(self, f"Wt_{k}")[task]
            # out[n, c, h, w] @ wt[c, d]: a 1x1 conv whose weight [d, c] is wt's transpose
            return F.conv2d(out, wt.t().to(out.dtype)[:, :, None, None])
        return out

    def forward(self, x: torch.Tensor, task: int | None = None,
                drop_mask: torch.Tensor | None = None) -> torch.Tensor:
        """`drop_mask` [N, C] keep-mask (training only): Dropout2d at
        `dropprob`; no mask, no dropout."""
        if task is None:
            raise ValueError("an ablation block needs a task")
        out = _conv(F.relu(_conv(x, self.conv3x1_1)), self.conv1x3_1)
        mid = F.relu(_batch_norm(self, self._adapt(out, x, 1, task), self._bn_of(1, task)))
        out = _conv(F.relu(_conv(mid, self.conv3x1_2)), self.conv1x3_2)
        out = _batch_norm(self, self._adapt(out, mid, 2, task), self._bn_of(2, task))
        if self.training:
            out = dropout2d(out, self.dropprob, drop_mask)
        return F.relu(out + x)


class UpsamplerBlock(nn.Module):
    def __init__(self, nin: int, nout: int):
        super().__init__()
        self.conv = nn.ConvTranspose2d(nin, nout, 3, stride=2, padding=1, output_padding=1)
        self.bn = _bn(nout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(_batch_norm(self, _conv_t(x, self.conv), self.bn))
