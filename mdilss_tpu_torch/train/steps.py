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
restored. `iou_train` adds the batch's confusion matrix ("cm") from the
current-task logits of the step. Every step runs its float32 convs and
matmuls with TF32 off (`ops.precision.no_tf32`), whatever the process's
flags are.

After its first call a step waits for the device nowhere (but `iou_train`'s
confusion matrix, which reads back its counts): each maker walks the
student's parameters once a call, puts its class weights on the step's
device at its first call and reuses them, keeps Adam's `optim.LrCache`, and
saves and restores a training-mode teacher's buffers through copies
allocated once (`_BufferCopies`), one `torch._foreach_copy_` per buffer type
each way; a mode switch is skipped where every module is in that mode.

`remat=True` runs every student forward with its remat regions
(`models.topology._ckpt` over each group64 block, each group128 chain and
each decoder nb1d block), as the JAX package's Trainer passes `remat` to
`apply_fn`; `remat_prev=True` (the distillation makers) also makes each
previous-task student forward one region as a whole, as JAX's `remat_prev`
(mdilss_tpu/train/steps.py:189-190, :286), so its nested regions replay
again inside its own replay. Both trade the activations kept for the
backward against recomputing them: the losses, gradients and running
statistics are those of the step without them (a replay updates no running
statistic). Both default to False; JAX's `remat_prev` defaults to True.

`compute_dtype` ("float32", the default, or "bfloat16"): every forward of a
step, the student's and the teacher's, casts its images to it, as the JAX
package's `apply_fn` casts `x` (mdilss_tpu/train/loop.py:267-276), so the
activations and logits are in that type while the parameters, Adam's state,
the BN statistics, the weight gradients and the losses stay float32 (the
losses upcast the logits).

`mesh` (`parallel.make_mesh`; None, or a mesh without a group: one process)
makes every maker's step sharded, as the JAX package's steps are under
`jit_*_step(step, mesh)` with images and labels `P("data", "spatial")`: the
step takes this rank's block of the global batch (the images of its data
index, `parallel.shard_rows`, and of those the rows of its spatial index,
`parallel.shard_height`; the dropout masks by data index), every forward
runs under `ops.norm.synced(mesh)` (global BN statistics, the train-mode
teacher's too, and on a spatial mesh the convs' row halos), each rank's
losses are its share of the global batch's
(`losses.weighted_cross_entropy(mesh=)`, `losses.kld_share`), the gradients
are summed over the ranks before each Adam step (`all_reduce_grads`, once
per backward, so twice in the two-phase step), and the metrics are the
global batch's ("loss", "ce", "kld" summed in one collective, "cm" in
another), the same on every rank. The ranks start from the same weights
(`parallel.replicate`) and so keep the same weights, bit for bit. With one
rank the step is the one without a mesh, bit for bit.
"""
from __future__ import annotations

import contextlib
import functools
from typing import Callable, NamedTuple, Sequence

import numpy as np
import torch
from torch import nn

from ..losses import kld_faithful, kld_share, weighted_cross_entropy, weighted_nll_sums
from ..metrics import confusion_matrix
from ..models import topology
from ..ops.norm import synced
from ..ops.precision import no_tf32
from ..parallel.mesh import active, all_reduce_, all_reduce_grads
from ..utils.profiling import span, spanned
from . import optim
from .optim import AdamState


COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def compute_dtype_of(compute_dtype) -> torch.dtype:
    """"float32" / "bfloat16" (or that torch dtype) -> the torch dtype the
    forwards run in; anything else raises ValueError."""
    dt = COMPUTE_DTYPES.get(compute_dtype) if isinstance(compute_dtype, str) else compute_dtype
    if dt not in COMPUTE_DTYPES.values():
        raise ValueError(f"compute_dtype={compute_dtype!r}: float32 or bfloat16")
    return dt


class TrainState(NamedTuple):
    model: nn.Module  # the student: parameters and BN running statistics
    opt: AdamState


def init_train_state(model: nn.Module) -> TrainState:
    return TrainState(model=model, opt=optim.init(dict(model.named_parameters())))


def _class_weight(class_weight) -> torch.Tensor:
    return torch.as_tensor(np.asarray(class_weight, np.float32))


def _on_device(copies: dict, host: torch.Tensor, device: torch.device) -> torch.Tensor:
    """`host` on `device`: copied at the first request for that device (a
    copy that waits for the queue to drain), the same tensor after."""
    t = copies.get(device)
    if t is None:
        t = copies[device] = host.to(device)
    return t


def _params(model: nn.Module) -> dict:
    with span("step.modes"):
        return dict(model.named_parameters())


def _set_mode(model: nn.Module, training: bool) -> None:
    """`model.train(training)`, skipped where every module is in that mode
    already: reading the flags costs a third of setting them."""
    if any(m.training != training for m in model.modules()):
        model.train(training)


def _mode(model: nn.Module, training: bool) -> None:
    with span("step.modes"):
        _set_mode(model, training)


def _grads(params: dict, loss: torch.Tensor) -> dict:
    """{parameter name: d loss / d parameter, or None where the loss does not
    reach it} over `params` (`_params`); frees the graph."""
    with span("step.backward"):
        grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
    return dict(zip(params, grads))


def _adam(params: dict, grads: dict, opt: AdamState, lr_tree: dict, mesh,
          cache: optim.LrCache, **kw) -> AdamState:
    """One Adam step over `params` with `grads` summed over the mesh's ranks."""
    with span("step.optimizer"):
        return optim.apply_updates(params, all_reduce_grads(grads, mesh), opt, lr_tree,
                                   cache=cache, **kw)


def _train_cm(logits: torch.Tensor, labels: torch.Tensor, num_classes: int) -> torch.Tensor:
    """Confusion matrix of the training batch from the step's current-task
    logits (the reference's --iouTrain, train_RAPFT_step1.py:269-317): no
    extra forward."""
    with span("step.loss"):
        return confusion_matrix(logits.detach().argmax(-1), labels, num_classes=num_classes)


def _global_metrics(metrics: dict, mesh) -> dict:
    """The batch's metrics over the mesh: the scalars summed (each rank's is
    its share) in one collective, "cm" summed in another."""
    if mesh is None:
        return metrics
    keys = [k for k in metrics if k != "cm"]
    out = dict(zip(keys, all_reduce_(torch.stack([metrics[k] for k in keys]), mesh).unbind()))
    if "cm" in metrics:
        out["cm"] = all_reduce_(metrics["cm"], mesh)
    return out


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


class _BufferCopies:
    """Copies of a module's buffers, allocated at the first `save` and
    reused while the buffers keep their shapes, types and devices. `save`
    and `restore` copy one buffer type at a time, each in one
    `torch._foreach_copy_`."""

    def __init__(self):
        self.sig, self.groups, self.copies, self.pairs = None, {}, {}, []

    def save(self, bufs: list) -> None:
        sig = [(b.shape, b.dtype, b.device) for b in bufs]
        if sig != self.sig:
            self.groups = {}
            for i, b in enumerate(bufs):
                self.groups.setdefault(b.dtype, []).append(i)
            self.copies = {dt: [torch.empty_like(bufs[i]) for i in idx]
                           for dt, idx in self.groups.items()}
            self.sig = sig
        self.pairs = [([bufs[i] for i in idx], self.copies[dt])
                      for dt, idx in self.groups.items()]
        for live, saved in self.pairs:
            torch._foreach_copy_(saved, live)

    def restore(self) -> None:
        for live, saved in self.pairs:
            torch._foreach_copy_(live, saved)
        self.pairs = []


@contextlib.contextmanager
def _teacher_mode(teacher: nn.Module, training: bool, copies: _BufferCopies | None = None):
    """The teacher in `training` mode for the block; afterwards its mode and
    every buffer are as before (a training forward updates BN running
    statistics in place), restored from `copies` (the caller's, reused
    across its steps; None: allocated for this block)."""
    was = teacher.training
    copies = _BufferCopies() if copies is None else copies
    with span("step.modes"), torch.no_grad():
        copies.save(list(teacher.buffers()) if training else [])
        _set_mode(teacher, training)
    try:
        yield
    finally:
        with span("step.modes"), torch.no_grad():
            copies.restore()
            _set_mode(teacher, was)


def _kld_sum(model: nn.Module, teacher: nn.Module, images: torch.Tensor, masks,
             prev_tasks: Sequence[int], kld_fn: Callable, teacher_training: bool,
             teacher_masks=None, remat: bool = False, remat_prev: bool = False,
             mesh=None, teacher_copies: _BufferCopies | None = None) -> torch.Tensor:
    """sum over `prev_tasks` of kld_fn(student, teacher): one student training
    forward (mask dict `masks[i]`; its remat regions with `remat`, itself one
    region with `remat_prev`) and one no_grad teacher forward (train or eval
    mode; `teacher_masks[i]` or no dropout) per task; with `mesh`, this
    rank's share of the global batch's sum. `teacher_copies`: where a
    training-mode teacher's buffers are saved (`_teacher_mode`)."""
    kld = torch.zeros((), dtype=torch.float32, device=images.device)
    student = functools.partial(model, remat=remat)
    with _teacher_mode(teacher, teacher_training, teacher_copies):
        for i, t in enumerate(prev_tasks):
            with span("step.forward", task=t):
                if remat_prev:
                    s_logits = topology._ckpt(student, images, t, masks[i])
                else:
                    s_logits = student(images, t, masks[i])
            with span("step.teacher", task=t), torch.no_grad():
                t_logits = teacher(images, t, None if teacher_masks is None else teacher_masks[i])
            with span("step.loss"):
                kld = kld + kld_share(kld_fn(s_logits, t_logits), mesh)
    return kld


def ce_loss_and_grads(model: nn.Module, images: torch.Tensor, labels: torch.Tensor, masks, *,
                      task: int, class_weight: torch.Tensor, remat: bool = False, mesh=None,
                      params: dict | None = None):
    """Weighted CE of head `task` and its gradient; one training forward (with
    its remat regions under `remat`), which updates the student's BN running
    statistics. `masks`: one `make_dropout_masks` dict or None (no dropout).
    Returns (ce, logits detached, {parameter name: grad or None}); with
    `mesh`, this rank's share of the CE and its gradient (not yet summed).
    `params`: the model's `named_parameters` as a dict, if the caller has it."""
    params = _params(model) if params is None else params
    _mode(model, True)
    with span("step.forward", task=task):
        logits = model(images, task, masks, remat=remat)
    with span("step.loss"):
        ce = weighted_cross_entropy(logits, labels, class_weight, mesh)
    return ce.detach(), logits.detach(), _grads(params, ce)


def kd_loss_and_grads(model: nn.Module, teacher: nn.Module, images: torch.Tensor, masks, *,
                      prev_tasks: Sequence[int], lambda_c: float = 0.1,
                      kld_fn: Callable = kld_faithful, teacher_training: bool = True,
                      teacher_masks=None, remat: bool = False, remat_prev: bool = False,
                      mesh=None, params: dict | None = None,
                      teacher_copies: _BufferCopies | None = None):
    """Step 3's second phase: lambda_c * sum KLD over `prev_tasks` and its
    gradient. `masks` holds one dropout-mask dict per student forward,
    `teacher_masks` one per teacher forward or None; `remat`, `remat_prev`,
    `teacher_copies` as `_kld_sum`'s, `params` as `ce_loss_and_grads`'. The
    current head gets no gradient (None). Returns (lambda_c * kld, kld,
    grads)."""
    params = _params(model) if params is None else params
    _mode(model, True)
    kld = _kld_sum(model, teacher, images, masks, prev_tasks, kld_fn, teacher_training,
                   teacher_masks, remat, remat_prev, mesh, teacher_copies)
    kd = lambda_c * kld
    return kd.detach(), kld.detach(), _grads(params, kd)


def distill_loss_and_grads(model: nn.Module, teacher: nn.Module, images: torch.Tensor,
                           labels: torch.Tensor, masks, *, current_task: int,
                           prev_tasks: Sequence[int], class_weight: torch.Tensor,
                           lambda_c: float = 0.1, kld_fn: Callable = kld_faithful,
                           remat: bool = False, remat_prev: bool = False, mesh=None,
                           params: dict | None = None):
    """The step-2 loss CE + lambda_c * sum KLD and its gradient; updates the
    student's BN running statistics. images [N,H,W,3] and labels [N,H,W] on
    the model's device; `masks` is one `make_dropout_masks` dict per student
    forward (current task first), one dict reused by every forward, or None
    (no dropout); `remat`, `remat_prev` as `_kld_sum`'s, `params` as
    `ce_loss_and_grads`'. Returns (loss, ce, kld, {parameter name: grad or
    None}, current-task logits detached)."""
    mask_list = _mask_list(masks, 1 + len(prev_tasks))
    params = _params(model) if params is None else params
    _mode(model, True)
    with span("step.forward", task=current_task):
        logits = model(images, current_task, mask_list[0], remat=remat)
    with span("step.loss"):
        ce = weighted_cross_entropy(logits, labels, class_weight, mesh)
    kld = _kld_sum(model, teacher, images, mask_list[1:], prev_tasks, kld_fn,
                   teacher_training=False, remat=remat, remat_prev=remat_prev, mesh=mesh)
    total = ce + lambda_c * kld
    return total.detach(), ce.detach(), kld.detach(), _grads(params, total), logits.detach()


def make_ce_step(*, task: int, class_weight, lr_tree: dict[str, float], num_epochs: int,
                 weight_decay: float = 1e-4, iou_train: bool = False,
                 compute_dtype="float32", remat: bool = False, mesh=None):
    """step(ts, images, labels, masks, epoch) -> (ts', metrics): weighted CE on
    head `task`, one Adam step. `masks`: one `make_dropout_masks` dict or
    None. metrics {"loss", "ce"} (+ "cm" [C, C] int64 with `iou_train`) as
    tensors on the device. `remat`: the student forward's remat regions.
    `mesh`: data-parallel over its ranks (the module docstring)."""
    weight, weights, lr_cache = _class_weight(class_weight), {}, optim.LrCache()
    dt = compute_dtype_of(compute_dtype)
    mesh = active(mesh)

    @spanned("step", kind="ce")
    @no_tf32()
    @synced(mesh)
    def step(ts: TrainState, images, labels, masks, epoch: int):
        params = _params(ts.model)
        ce, logits, grads = ce_loss_and_grads(
            ts.model, images.to(dt), labels, masks, task=task,
            class_weight=_on_device(weights, weight, images.device), remat=remat, mesh=mesh,
            params=params)
        metrics = {"loss": ce, "ce": ce}
        if iou_train:
            metrics["cm"] = _train_cm(logits, labels, len(weight))
        metrics = _global_metrics(metrics, mesh)
        opt = _adam(params, grads, ts.opt, lr_tree, mesh, lr_cache,
                    lr_scale=optim.poly_lr_factor(epoch, num_epochs), weight_decay=weight_decay)
        return TrainState(ts.model, opt), metrics

    return step


def make_distill_step(*, current_task: int, prev_tasks: Sequence[int], class_weight,
                      lr_tree: dict[str, float], num_epochs: int, lambda_c: float = 0.1,
                      kld_fn: Callable = kld_faithful, weight_decay: float = 1e-4,
                      iou_train: bool = False, compute_dtype="float32",
                      remat: bool = False, remat_prev: bool = False, mesh=None):
    """step(ts, teacher, images, labels, masks, epoch) -> (ts', metrics), with
    metrics {"loss", "ce", "kld"} (+ "cm" with `iou_train`) as tensors on the
    device (reading them waits for the step). `remat`: every student
    forward's remat regions; `remat_prev`: each previous-task student forward
    one region as well; `mesh`: data-parallel (the module docstring)."""
    weight, weights, lr_cache = _class_weight(class_weight), {}, optim.LrCache()
    dt = compute_dtype_of(compute_dtype)
    mesh = active(mesh)

    @spanned("step", kind="distill")
    @no_tf32()
    @synced(mesh)
    def step(ts: TrainState, teacher: nn.Module, images, labels, masks, epoch: int):
        params = _params(ts.model)
        total, ce, kld, grads, logits = distill_loss_and_grads(
            ts.model, teacher, images.to(dt), labels, masks, current_task=current_task,
            prev_tasks=prev_tasks, class_weight=_on_device(weights, weight, images.device),
            lambda_c=lambda_c, kld_fn=kld_fn, remat=remat, remat_prev=remat_prev, mesh=mesh,
            params=params,
        )
        metrics = {"loss": total, "ce": ce, "kld": kld}
        if iou_train:
            metrics["cm"] = _train_cm(logits, labels, len(weight))
        metrics = _global_metrics(metrics, mesh)
        opt = _adam(params, grads, ts.opt, lr_tree, mesh, lr_cache,
                    lr_scale=optim.poly_lr_factor(epoch, num_epochs), weight_decay=weight_decay)
        return TrainState(ts.model, opt), metrics

    return step


def make_two_phase_distill_step(*, current_task: int, prev_tasks: Sequence[int], class_weight,
                                lr_tree: dict[str, float], num_epochs: int,
                                lambda_c: float = 0.1, kld_fn: Callable = kld_faithful,
                                weight_decay: float = 1e-4, iou_train: bool = False,
                                teacher_training: bool = True, teacher_dropout: bool = False,
                                compute_dtype="float32", remat: bool = False,
                                remat_prev: bool = False, mesh=None):
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
    every student forward. `remat`, `remat_prev` as `make_distill_step`'s
    (JAX's KD phase always makes each previous-task forward a region,
    mdilss_tpu/train/steps.py:286). `mesh`: data-parallel, each phase's
    gradients summed before its own Adam step (the module docstring)."""
    if teacher_dropout and not teacher_training:
        raise ValueError("teacher_dropout=True requires teacher_training=True (dropout is a "
                         "train-mode behaviour; the eval-mode teacher has none)")
    weight, weights, lr_cache = _class_weight(class_weight), {}, optim.LrCache()
    teacher_copies = _BufferCopies()
    dt = compute_dtype_of(compute_dtype)
    n_prev = len(prev_tasks)
    n_masks = 1 + n_prev * (2 if teacher_dropout else 1)
    mesh = active(mesh)

    @spanned("step", kind="two_phase")
    @no_tf32()
    @synced(mesh)
    def step(ts: TrainState, teacher: nn.Module, images, labels, masks, epoch: int):
        images = images.to(dt)
        mask_list = _mask_list(masks, n_masks, need_list=teacher_dropout)
        lr_scale = optim.poly_lr_factor(epoch, num_epochs)
        params = _params(ts.model)
        ce, logits, grads = ce_loss_and_grads(
            ts.model, images, labels, mask_list[0], task=current_task,
            class_weight=_on_device(weights, weight, images.device), remat=remat, mesh=mesh,
            params=params)
        cm = _train_cm(logits, labels, len(weight)) if iou_train else None
        del logits
        opt = _adam(params, grads, ts.opt, lr_tree, mesh, lr_cache, lr_scale=lr_scale,
                    weight_decay=weight_decay)
        del grads
        kd, kld, grads = kd_loss_and_grads(
            ts.model, teacher, images, mask_list[1:1 + n_prev], prev_tasks=prev_tasks,
            lambda_c=lambda_c, kld_fn=kld_fn, teacher_training=teacher_training,
            teacher_masks=mask_list[1 + n_prev:] if teacher_dropout else None,
            remat=remat, remat_prev=remat_prev, mesh=mesh, params=params,
            teacher_copies=teacher_copies,
        )
        opt = _adam(params, grads, opt, lr_tree, mesh, lr_cache, lr_scale=lr_scale,
                    weight_decay=weight_decay)
        metrics = {"loss": ce + kd, "ce": ce, "kld": kld}
        if cm is not None:
            metrics["cm"] = cm
        return TrainState(ts.model, opt), _global_metrics(metrics, mesh)

    return step


def make_eval_step(*, task: int, class_weight, num_classes: int, compute_dtype="float32",
                   mesh=None):
    """step(model, images, labels) -> (loss, cm): eval-mode forward of head
    `task` in `compute_dtype` (bfloat16: K1's bf16 kernel on the card),
    weighted CE, argmax and the [C, C] int64 confusion matrix, all on the
    model's device. `labels` are prepared (`data.transforms.prepare_batch`:
    the void label as the last class, whose weight is 0). `mesh`: the images
    and labels are this rank's block (its images, its rows of them), the
    forward takes its row halos on a spatial mesh, and the CE (its numerator
    and denominator summed over the ranks) and the confusion matrix are the
    global batch's."""
    weight, weights = _class_weight(class_weight), {}
    dt = compute_dtype_of(compute_dtype)
    mesh = active(mesh)

    @spanned("step", kind="eval")
    @no_tf32()
    @synced(mesh)
    def step(model: nn.Module, images, labels):
        w = _on_device(weights, weight, images.device)
        _mode(model, False)
        with span("step.forward", task=task):
            logits = model(images.to(dt), task)
        with span("step.loss"):
            cm = confusion_matrix(logits.argmax(-1), labels, num_classes=num_classes)
            if mesh is None:
                return weighted_cross_entropy(logits, labels, w), cm
            num, den = all_reduce_(torch.stack(weighted_nll_sums(logits, labels, w)), mesh)
            return num / den, all_reduce_(cm, mesh)

    return step
