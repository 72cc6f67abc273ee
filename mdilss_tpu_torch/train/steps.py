"""Train and eval steps of the port (port of mdilss_tpu/train/steps.py).

Each maker closes over its configuration (tasks, class weights, the LR dict,
the schedule length) and returns a step over an `nn.Module` student, which
it updates in place: its parameters by one torch-exact Adam step over the
per-parameter LR dict per backward, its BN running statistics by its
training forwards.

  * `make_ce_step`: weighted CE on one head, one backward (step 1, the
    multitask domain turns, FT and the single-task baselines).
  * `make_distill_step`: step 2, CE on the new head plus lambda_c times the
    faithful KLD against the frozen eval-mode teacher on each old head, one
    backward.
  * `make_two_phase_distill_step`: step 3 as the reference trains it, a CE
    backward and Adam step, then lambda_c * sum KLD against the updated
    weights and a second Adam step; the teacher runs in training mode by
    default (batch-statistics BN).
  * `make_eval_step`: eval-mode forward, weighted CE, argmax and the
    confusion matrix, all on the model's device.

The student runs every forward in training mode (batch-statistics BN,
dropout from host masks), the current task first and then each previous
task, newest first as the trainer passes them, so its BN running statistics
update in that order. The teacher runs under no_grad; after each step its
buffers are bitwise what they were (a training-mode forward writes its BN
running statistics, which the JAX package discards) and its mode is
restored. The previous-task forwards are not recomputed in the backward (the
JAX package's `remat_prev` saves memory on the TPU; a recompute here would
update the BN running statistics twice). `iou_train` adds the batch's
confusion matrix ("cm") from the current-task logits of the step. Every
step runs its float32 convs and matmuls with TF32 off (`ops.precision.no_tf32`),
whatever the process's flags are.
"""
from __future__ import annotations

import contextlib
from typing import Callable, NamedTuple, Sequence

import numpy as np
import torch
from torch import nn

from ..losses import kld_faithful, weighted_cross_entropy
from ..metrics import confusion_matrix
from ..ops.precision import no_tf32
from . import optim
from .optim import AdamState


class TrainState(NamedTuple):
    model: nn.Module  # the student: parameters and BN running statistics
    opt: AdamState


def init_train_state(model: nn.Module) -> TrainState:
    return TrainState(model=model, opt=optim.init(dict(model.named_parameters())))


def _class_weight(class_weight) -> torch.Tensor:
    return torch.as_tensor(np.asarray(class_weight, np.float32))


def _grads(model: nn.Module, loss: torch.Tensor) -> dict:
    """{parameter name: d loss / d parameter, or None where the loss does not
    reach it}; frees the graph."""
    params = dict(model.named_parameters())
    return dict(zip(params, torch.autograd.grad(loss, list(params.values()), allow_unused=True)))


def _train_cm(logits: torch.Tensor, labels: torch.Tensor, num_classes: int) -> torch.Tensor:
    """Confusion matrix of the training batch from the step's current-task
    logits (the reference's --iouTrain, train_RAPFT_step1.py:269-317): no
    extra forward."""
    return confusion_matrix(logits.detach().argmax(-1), labels, num_classes=num_classes)


def _mask_list(masks, n: int, *, need_list: bool = False) -> list:
    """`masks` as one dropout-mask dict per forward: a list of exactly `n`
    dicts, or one dict (or None) reused by every forward unless `need_list`."""
    if isinstance(masks, (list, tuple)):
        if len(masks) != n:
            raise ValueError(f"{len(masks)} dropout-mask dicts for {n} forwards")
        return list(masks)
    if need_list:
        raise ValueError(f"teacher_dropout needs a list of {n} dropout-mask dicts: the "
                         f"student's forwards first, then one per teacher forward")
    return [masks] * n


@contextlib.contextmanager
def _teacher_mode(teacher: nn.Module, training: bool):
    """The teacher in `training` mode for the block; afterwards its mode and
    every buffer are as before (a training forward updates BN running
    statistics in place)."""
    was = teacher.training
    saved = [(b, b.clone()) for b in teacher.buffers()] if training else []
    teacher.train(training)
    try:
        yield
    finally:
        with torch.no_grad():
            for b, v in saved:
                b.copy_(v)
        teacher.train(was)


def _kld_sum(model: nn.Module, teacher: nn.Module, images: torch.Tensor, masks,
             prev_tasks: Sequence[int], kld_fn: Callable, teacher_training: bool,
             teacher_masks=None) -> torch.Tensor:
    """sum over `prev_tasks` of kld_fn(student, teacher): one student training
    forward (mask dict `masks[i]`) and one no_grad teacher forward (train or
    eval mode; `teacher_masks[i]` or no dropout) per task."""
    kld = torch.zeros((), dtype=torch.float32, device=images.device)
    with _teacher_mode(teacher, teacher_training):
        for i, t in enumerate(prev_tasks):
            s_logits = model(images, t, masks[i])
            with torch.no_grad():
                t_logits = teacher(images, t, None if teacher_masks is None else teacher_masks[i])
            kld = kld + kld_fn(s_logits, t_logits)
    return kld


def ce_loss_and_grads(model: nn.Module, images: torch.Tensor, labels: torch.Tensor, masks, *,
                      task: int, class_weight: torch.Tensor):
    """Weighted CE of head `task` and its gradient; one training forward, which
    updates the student's BN running statistics. `masks`: one
    `make_dropout_masks` dict or None (no dropout). Returns (ce, logits
    detached, {parameter name: grad or None})."""
    model.train()
    logits = model(images, task, masks)
    ce = weighted_cross_entropy(logits, labels, class_weight)
    return ce.detach(), logits.detach(), _grads(model, ce)


def kd_loss_and_grads(model: nn.Module, teacher: nn.Module, images: torch.Tensor, masks, *,
                      prev_tasks: Sequence[int], lambda_c: float = 0.1,
                      kld_fn: Callable = kld_faithful, teacher_training: bool = True,
                      teacher_masks=None):
    """Step 3's second phase: lambda_c * sum KLD over `prev_tasks` and its
    gradient. `masks` holds one dropout-mask dict per student forward,
    `teacher_masks` one per teacher forward or None. The current head gets
    no gradient (None). Returns (lambda_c * kld, kld, grads)."""
    model.train()
    kld = _kld_sum(model, teacher, images, masks, prev_tasks, kld_fn, teacher_training,
                   teacher_masks)
    kd = lambda_c * kld
    return kd.detach(), kld.detach(), _grads(model, kd)


def distill_loss_and_grads(model: nn.Module, teacher: nn.Module, images: torch.Tensor,
                           labels: torch.Tensor, masks, *, current_task: int,
                           prev_tasks: Sequence[int], class_weight: torch.Tensor,
                           lambda_c: float = 0.1, kld_fn: Callable = kld_faithful):
    """The step-2 loss CE + lambda_c * sum KLD and its gradient; updates the
    student's BN running statistics. images [N,H,W,3] and labels [N,H,W] on
    the model's device; `masks` is one `make_dropout_masks` dict per student
    forward (current task first), one dict reused by every forward, or None
    (no dropout). Returns (loss, ce, kld, {parameter name: grad or None},
    current-task logits detached)."""
    mask_list = _mask_list(masks, 1 + len(prev_tasks))
    model.train()
    logits = model(images, current_task, mask_list[0])
    ce = weighted_cross_entropy(logits, labels, class_weight)
    kld = _kld_sum(model, teacher, images, mask_list[1:], prev_tasks, kld_fn,
                   teacher_training=False)
    total = ce + lambda_c * kld
    return total.detach(), ce.detach(), kld.detach(), _grads(model, total), logits.detach()


def make_ce_step(*, task: int, class_weight, lr_tree: dict[str, float], num_epochs: int,
                 weight_decay: float = 1e-4, iou_train: bool = False):
    """step(ts, images, labels, masks, epoch) -> (ts', metrics): weighted CE on
    head `task`, one Adam step. `masks`: one `make_dropout_masks` dict or
    None. metrics {"loss", "ce"} (+ "cm" [C, C] int64 with `iou_train`) as
    tensors on the device."""
    weight = _class_weight(class_weight)

    @no_tf32()
    def step(ts: TrainState, images, labels, masks, epoch: int):
        ce, logits, grads = ce_loss_and_grads(ts.model, images, labels, masks, task=task,
                                              class_weight=weight)
        metrics = {"loss": ce, "ce": ce}
        if iou_train:
            metrics["cm"] = _train_cm(logits, labels, len(weight))
        opt = optim.apply_updates(
            dict(ts.model.named_parameters()), grads, ts.opt, lr_tree,
            lr_scale=optim.poly_lr_factor(epoch, num_epochs), weight_decay=weight_decay,
        )
        return TrainState(ts.model, opt), metrics

    return step


def make_distill_step(*, current_task: int, prev_tasks: Sequence[int], class_weight,
                      lr_tree: dict[str, float], num_epochs: int, lambda_c: float = 0.1,
                      kld_fn: Callable = kld_faithful, weight_decay: float = 1e-4,
                      iou_train: bool = False):
    """step(ts, teacher, images, labels, masks, epoch) -> (ts', metrics), with
    metrics {"loss", "ce", "kld"} (+ "cm" with `iou_train`) as tensors on the
    device (reading them waits for the step)."""
    weight = _class_weight(class_weight)

    @no_tf32()
    def step(ts: TrainState, teacher: nn.Module, images, labels, masks, epoch: int):
        total, ce, kld, grads, logits = distill_loss_and_grads(
            ts.model, teacher, images, labels, masks, current_task=current_task,
            prev_tasks=prev_tasks, class_weight=weight, lambda_c=lambda_c, kld_fn=kld_fn,
        )
        metrics = {"loss": total, "ce": ce, "kld": kld}
        if iou_train:
            metrics["cm"] = _train_cm(logits, labels, len(weight))
        opt = optim.apply_updates(
            dict(ts.model.named_parameters()), grads, ts.opt, lr_tree,
            lr_scale=optim.poly_lr_factor(epoch, num_epochs), weight_decay=weight_decay,
        )
        return TrainState(ts.model, opt), metrics

    return step


def make_two_phase_distill_step(*, current_task: int, prev_tasks: Sequence[int], class_weight,
                                lr_tree: dict[str, float], num_epochs: int,
                                lambda_c: float = 0.1, kld_fn: Callable = kld_faithful,
                                weight_decay: float = 1e-4, iou_train: bool = False,
                                teacher_training: bool = True, teacher_dropout: bool = False):
    """Step 3 (train_new_task_step3.py:317-356): a CE backward and Adam step,
    then lambda_c * sum KLD against the updated weights, its backward and a
    second Adam step with the same schedule factor; `ts.opt.count` grows by 2.

    step(ts, teacher, images, labels, masks, epoch) -> (ts', metrics), metrics
    {"loss": ce + lambda_c * kld, "ce", "kld"} (+ "cm" from the CE phase's
    logits with `iou_train`).

    `teacher_training=True` (the default) is the reference's step-3 teacher,
    never switched to eval mode: batch-statistics BN, its running statistics
    left as they were. `teacher_dropout=True` also gives its forwards active
    dropout; `masks` must then be a list of 1 + 2 * len(prev_tasks) dicts, the
    student's forwards first, then one per teacher forward. Otherwise `masks`
    is a list of 1 + len(prev_tasks) dicts or one dict (or None) reused by
    every student forward."""
    if teacher_dropout and not teacher_training:
        raise ValueError("teacher_dropout=True requires teacher_training=True (dropout is a "
                         "train-mode behaviour; the eval-mode teacher has none)")
    weight = _class_weight(class_weight)
    n_prev = len(prev_tasks)
    n_masks = 1 + n_prev * (2 if teacher_dropout else 1)

    @no_tf32()
    def step(ts: TrainState, teacher: nn.Module, images, labels, masks, epoch: int):
        mask_list = _mask_list(masks, n_masks, need_list=teacher_dropout)
        lr_scale = optim.poly_lr_factor(epoch, num_epochs)
        params = dict(ts.model.named_parameters())
        ce, logits, grads = ce_loss_and_grads(ts.model, images, labels, mask_list[0],
                                              task=current_task, class_weight=weight)
        cm = _train_cm(logits, labels, len(weight)) if iou_train else None
        del logits
        opt = optim.apply_updates(params, grads, ts.opt, lr_tree, lr_scale=lr_scale,
                                  weight_decay=weight_decay)
        del grads
        kd, kld, grads = kd_loss_and_grads(
            ts.model, teacher, images, mask_list[1:1 + n_prev], prev_tasks=prev_tasks,
            lambda_c=lambda_c, kld_fn=kld_fn, teacher_training=teacher_training,
            teacher_masks=mask_list[1 + n_prev:] if teacher_dropout else None,
        )
        opt = optim.apply_updates(params, grads, opt, lr_tree, lr_scale=lr_scale,
                                  weight_decay=weight_decay)
        metrics = {"loss": ce + kd, "ce": ce, "kld": kld}
        if cm is not None:
            metrics["cm"] = cm
        return TrainState(ts.model, opt), metrics

    return step


def make_eval_step(*, task: int, class_weight, num_classes: int):
    """step(model, images, labels) -> (loss, cm): eval-mode forward of head
    `task`, weighted CE, argmax and the [C, C] int64 confusion matrix, all on
    the model's device. `labels` are prepared (`data.transforms.
    prepare_batch`: the void label as the last class, whose weight is 0)."""
    weight = _class_weight(class_weight)

    @no_tf32()
    def step(model: nn.Module, images, labels):
        model.eval()
        logits = model(images, task)
        loss = weighted_cross_entropy(logits, labels, weight)
        return loss, confusion_matrix(logits.argmax(-1), labels, num_classes=num_classes)

    return step
