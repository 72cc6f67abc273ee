"""Per-parameter learning rates: freeze masks and differential LR in one dict.

Port of `rap_lr_tree` (mdilss_tpu/train/masks.py:49-89) for the RAP model in
incremental step `current_task` (reference train_new_task_step2.py:95-106,
202-215, 229-239):
  * shared encoder convs                                   -> shared_lr
  * the current task's `parallel_conv_k`, `bns_k`, `bn_ini` slices and decoder -> ds_lr
  * every other task's slices and decoders                 -> 0 (frozen)
The port's per-task leaves are separate parameters (`.{t}.` in the name), so
the JAX tree's [T, 1, ...] columns become one number per parameter. The same
rule covers SegFormerRAP: its per-domain LayerNorms and adapters and the
current domain's head at ds_lr, the other domains' at 0, the rest of the
encoder at shared_lr.

And of `ablation_lr_tree` (mdilss_tpu/train/masks.py:92-157) for the four
ablation models: the same rule over each variant's per-task slices
(`bn_ini`, `bns_k`, `parallel_conv_k`, `series_conv_k`, `Wt_k`), with the JAX
package's two recorded judgment calls: onlyrap's shared BN moves at
shared_lr, as the shared convs do; ras's old-task adapters are frozen.

And of `multihead_lr_tree` (mdilss_tpu/train/masks.py:160-179) for the
shared-encoder multi-head models: the encoder at one LR, each head at its own
(the multitask baseline: encoder 5e-4 / nb_tasks, every head 5e-4,
train_multi_task.py:107-110, 210-217; FT: the old heads 0; FE: the encoder
too, main_ftp1_enc_newbn.py:228-242).
"""
from __future__ import annotations

import re

from torch import nn

# ERFNet-RAP's per-task slices, and SegFormerRAP's per-domain LayerNorms (`norm`, `norm1`,
# `norm2`, a stage's `norm1`-`norm4`) and adapters
_TASK_SLICE = re.compile(r"\.(?:parallel_conv_[12]|bns_[12]|bn_ini|norm\d?|adapter)\.(\d+)\.")
# the ablation models' per-task slices; RCM's `Wt_k.{t}` is a parameter with no suffix
_ABLATION_SLICE = re.compile(
    r"\.(?:parallel_conv_[12]|series_conv_[12]|Wt_[12]|bns_[12]|bn_ini)\.(\d+)(?:\.|$)")


def _task_lr_tree(model: nn.Module, task_slice: re.Pattern, current_task: int,
                  shared_lr: float, ds_lr: float) -> dict[str, float]:
    out = {}
    for name, _ in model.named_parameters():
        if name.startswith("decoder."):
            task = int(name.split(".")[1])
        else:
            m = task_slice.search(name)
            if m is None:
                out[name] = shared_lr
                continue
            task = int(m.group(1))
        out[name] = ds_lr if task == current_task else 0.0
    return out


def rap_lr_tree(model: nn.Module, *, current_task: int, shared_lr: float,
                ds_lr: float) -> dict[str, float]:
    """{parameter name: base LR} for every parameter of an ERFNetRAP or a
    SegFormerRAP."""
    return _task_lr_tree(model, _TASK_SLICE, current_task, shared_lr, ds_lr)


def ablation_lr_tree(model: nn.Module, *, variant: str, current_task: int, shared_lr: float,
                     ds_lr: float) -> dict[str, float]:
    """{parameter name: base LR} for every parameter of an ERFNetAblation of
    `variant`: its shared convs and shared BN at shared_lr, the current
    task's slices and decoder at ds_lr, every other task's at 0."""
    if getattr(model, "variant", None) != variant:
        raise ValueError(f"ablation_lr_tree(variant={variant!r}) of a model of variant "
                         f"{getattr(model, 'variant', None)!r}")
    return _task_lr_tree(model, _ABLATION_SLICE, current_task, shared_lr, ds_lr)


def multihead_lr_tree(model: nn.Module, *, encoder_lr: float,
                      decoder_lrs: list[float] | None = None,
                      decoder_lr: float | None = None) -> dict[str, float]:
    """{parameter name: base LR} for an ERFNetMultiHead: `encoder_lr` for the
    encoder, `decoder_lrs[t]` for head t (0 freezes it), or `decoder_lr` for
    every head."""
    prefixes = model.head_prefixes
    if decoder_lrs is None:
        decoder_lrs = [float(decoder_lr)] * len(prefixes)
    out = {}
    for name, _ in model.named_parameters():
        if name.startswith("encoder."):
            out[name] = encoder_lr
            continue
        t = next(t for t, p in enumerate(prefixes) if name.startswith(p + "."))
        out[name] = decoder_lrs[t]
    return out
