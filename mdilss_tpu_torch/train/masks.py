"""Per-parameter learning rates: freeze masks and differential LR in one dict.

Port of `rap_lr_tree` (mdilss_tpu/train/masks.py:49-89) for the RAP model in
incremental step `current_task` (reference train_new_task_step2.py:95-106,
202-215, 229-239):
  * shared encoder convs                                   -> shared_lr
  * the current task's `parallel_conv_k`, `bns_k`, `bn_ini` slices and decoder -> ds_lr
  * every other task's slices and decoders                 -> 0 (frozen)
The port's per-task leaves are separate parameters (`.{t}.` in the name), so
the JAX tree's [T, 1, ...] columns become one number per parameter.
"""
from __future__ import annotations

import re

from torch import nn

_TASK_SLICE = re.compile(r"\.(?:parallel_conv_[12]|bns_[12]|bn_ini)\.(\d+)\.")


def rap_lr_tree(model: nn.Module, *, current_task: int, shared_lr: float,
                ds_lr: float) -> dict[str, float]:
    """{parameter name: base LR} for every parameter of an ERFNetRAP."""
    out = {}
    for name, _ in model.named_parameters():
        if name.startswith("decoder."):
            task = int(name.split(".")[1])
        else:
            m = _TASK_SLICE.search(name)
            if m is None:
                out[name] = shared_lr
                continue
            task = int(m.group(1))
        out[name] = ds_lr if task == current_task else 0.0
    return out
