"""Train steps of the port (port of mdilss_tpu/train/steps.py:36-58, 143-207).

`make_distill_step` is the proposed method's step 2: the student's weighted
CE on the new head plus lambda_c times the faithful KLD against the frozen,
eval-mode teacher on each old head, one backward, then one torch-exact Adam
step over the per-parameter LR dict. The student runs every forward in
training mode (batch-statistics BN, dropout from host masks), the current
task first and then each previous task, so its BN running statistics update
in that order; the teacher runs under no_grad in eval mode (the inference
kernel). The previous-task forwards are not recomputed in the backward (the
JAX package's `remat_prev` saves memory on the TPU; a recompute here would
update the BN running statistics twice).
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Sequence

import numpy as np
import torch
from torch import nn

from ..losses import kld_faithful, weighted_cross_entropy
from . import optim
from .optim import AdamState


class TrainState(NamedTuple):
    model: nn.Module  # the student: parameters and BN running statistics
    opt: AdamState


def init_train_state(model: nn.Module) -> TrainState:
    return TrainState(model=model, opt=optim.init(dict(model.named_parameters())))


def distill_loss_and_grads(model: nn.Module, teacher: nn.Module, images: torch.Tensor,
                           labels: torch.Tensor, masks, *, current_task: int,
                           prev_tasks: Sequence[int], class_weight: torch.Tensor,
                           lambda_c: float = 0.1, kld_fn: Callable = kld_faithful):
    """The step-2 loss CE + lambda_c * sum KLD and its gradient; updates the
    student's BN running statistics. images [N,H,W,3] and labels [N,H,W] on
    the model's device; `masks` is one `make_dropout_masks` dict per student
    forward (current task first), one dict reused by every forward, or None
    (no dropout). Returns (loss, ce, kld, {parameter name: grad or None})."""
    mask_list = masks if isinstance(masks, (list, tuple)) else [masks] * (1 + len(prev_tasks))
    model.train()
    teacher.eval()
    logits = model(images, current_task, mask_list[0])
    ce = weighted_cross_entropy(logits, labels, class_weight)
    kld = torch.zeros((), dtype=torch.float32, device=images.device)
    for i, t in enumerate(prev_tasks):
        s_logits = model(images, t, mask_list[1 + i])
        kld = kld + kld_fn(s_logits, teacher(images, t))
    total = ce + lambda_c * kld
    params = dict(model.named_parameters())
    grads = torch.autograd.grad(total, list(params.values()), allow_unused=True)
    return total.detach(), ce.detach(), kld.detach(), dict(zip(params, grads))


def make_distill_step(*, current_task: int, prev_tasks: Sequence[int], class_weight,
                      lr_tree: dict[str, float], num_epochs: int, lambda_c: float = 0.1,
                      kld_fn: Callable = kld_faithful, weight_decay: float = 1e-4):
    """step(ts, teacher, images, labels, masks, epoch) -> (ts', metrics), with
    metrics {"loss", "ce", "kld"} as 0-d tensors on the device (reading them
    waits for the step)."""
    weight = torch.as_tensor(np.asarray(class_weight, np.float32))

    def step(ts: TrainState, teacher: nn.Module, images, labels, masks, epoch: int):
        total, ce, kld, grads = distill_loss_and_grads(
            ts.model, teacher, images, labels, masks, current_task=current_task,
            prev_tasks=prev_tasks, class_weight=weight, lambda_c=lambda_c, kld_fn=kld_fn,
        )
        opt = optim.apply_updates(
            dict(ts.model.named_parameters()), grads, ts.opt, lr_tree,
            lr_scale=optim.poly_lr_factor(epoch, num_epochs), weight_decay=weight_decay,
        )
        return TrainState(ts.model, opt), {"loss": total, "ce": ce, "kld": kld}

    return step
