"""Plain training and evaluation of ERFNet-RAP for the comparison that decides
`correct`: the augment, the losses, the masked Adam, the step-2 and step-3
steps and the eval step of MDIL-SS (Garg et al., WACV 2022;
train_new_task_step2.py, train_new_task_step3.py), written with plain torch
ops and autograd on a state dict (`erfnet_rap.Forward`).

  * augment: per image a horizontal flip where drawn, a translate by
    (tx, ty) pixels (content moves right / down for positive shifts), then
    x / 255 and the void label 255 -> classes - 1. Pixels that come in from
    the top or left take 0 in the image and 255 in the label, those from
    the bottom or right 0 in both (PIL's expand + crop).
  * CE: `F.cross_entropy` with the class weights (the void class weighs 0),
    the weighted mean over the pixels.
  * KLD: `F.kl_div(softmax(student), softmax(teacher))`, mean reduction: the
    reference trainers' KLDivLoss with probabilities as its input.
  * Adam: torch.optim.Adam's update with weight decay 1e-4 added to the
    gradient, one step count for all parameters, per parameter its base LR
    (0 freezes it: no update and no moments), a parameter the loss does
    not reach taken as a zero gradient (the reference trainers zero their
    gradients in place, so weight decay still moves it).
  * LRs (train_new_task_step2.py:202-239): the current task's decoder and
    its `parallel_conv_k`, `bns_k` and `bn_ini` slices at the new-task LR,
    every other task's at 0, the rest (the shared convs) at the shared LR.
  * step 2: CE on the current head plus lambda * KLD against the eval-mode
    teacher on each previous head, one backward and one Adam step.
  * step 3: a CE backward and Adam step, then lambda * sum KLD against the
    teacher in training mode (batch statistics, its buffers untouched) on
    the updated weights, a backward and a second Adam step.

The student's running buffers are updated by every student forward, in
forward order. Each step returns its losses and its raw gradients (before
weight decay), which the comparison reads. Imports torch and numpy only.
"""
from __future__ import annotations

import re

import numpy as np
import torch
import torch.nn.functional as F

from .erfnet_rap import Forward, float32_exact

B1, B2, ADAM_EPS = 0.9, 0.999, 1e-8
_TASK_SLICE = re.compile(r"\.(?:parallel_conv_[12]|bns_[12]|bn_ini)\.(\d+)\.")


def augment(images_u8, labels_u8, flip, tx, ty, num_classes: int):
    """uint8 [N, H, W, 3] and [N, H, W], the draws [N] -> (float32 images in
    [0, 1], int64 labels)."""
    n, h, w = labels_u8.shape
    imgs, lbls = [], []
    for i in range(n):
        img, lbl = images_u8[i], labels_u8[i]
        if bool(flip[i]):
            img, lbl = img.flip(1), lbl.flip(1)
        dy, dx = int(ty[i]), int(tx[i])
        img, lbl = img.roll((dy, dx), (0, 1)).clone(), lbl.roll((dy, dx), (0, 1)).clone()
        top = slice(0, dy) if dy > 0 else slice(0, 0)
        left = slice(0, dx) if dx > 0 else slice(0, 0)
        bottom = slice(h + dy, h) if dy < 0 else slice(h, h)
        right = slice(w + dx, w) if dx < 0 else slice(w, w)
        for rows, cols, fill in ((top, slice(None), 255), (slice(None), left, 255),
                                 (bottom, slice(None), 0), (slice(None), right, 0)):
            img[rows, cols] = 0
            lbl[rows, cols] = fill
        imgs.append(img)
        lbls.append(lbl)
    return prepare(torch.stack(imgs), torch.stack(lbls), num_classes)


def prepare(images_u8, labels_u8, num_classes: int):
    """uint8 images and labels -> float32 images / 255, int64 labels with 255
    as the void class, num_classes - 1."""
    labels = labels_u8.long()
    return images_u8.float() / 255.0, torch.where(labels == 255, num_classes - 1, labels)


def cross_entropy(logits_nhwc, labels, weight):
    return F.cross_entropy(logits_nhwc.permute(0, 3, 1, 2), labels, weight=weight)


def kld(student_logits, teacher_logits):
    """KLDivLoss()'s mean over every element, taken as the sum over the count."""
    p_s = F.softmax(student_logits, -1)
    return F.kl_div(p_s, F.softmax(teacher_logits, -1), reduction="sum") / p_s.numel()


def base_lrs(names, *, current_task: int, shared_lr: float, ds_lr: float) -> dict:
    """{parameter name: base LR} (the module docstring)."""
    out = {}
    for name in names:
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


class State:
    """The reference's student: parameters (leaves with grad), running
    buffers, Adam's moments and step count."""

    def __init__(self, sd: dict, lrs: dict, *, weight_decay: float):
        self.params = {k: v.detach().clone().requires_grad_(True) for k, v in sd.items()
                       if k in lrs}
        self.buffers = {k: v.detach().clone() for k, v in sd.items() if k not in lrs}
        self.lrs, self.weight_decay = lrs, weight_decay
        self.m = {k: torch.zeros_like(p) for k, p in self.params.items()}
        self.v = {k: torch.zeros_like(p) for k, p in self.params.items()}
        self.count = 0

    def sd(self) -> dict:
        return {**self.params, **self.buffers}

    @torch.no_grad()
    def adam(self, grads: dict, lr_scale: float) -> None:
        self.count += 1
        c1, c2 = 1.0 - B1 ** self.count, 1.0 - B2 ** self.count
        for k, p in self.params.items():
            lr = self.lrs[k]
            if lr == 0.0:
                continue
            g = grads.get(k)
            g = (torch.zeros_like(p) if g is None else g) + self.weight_decay * p
            self.m[k].mul_(B1).add_(g, alpha=1.0 - B1)
            self.v[k].mul_(B2).addcmul_(g, g, value=1.0 - B2)
            p.sub_(lr * lr_scale * (self.m[k] / c1) / ((self.v[k] / c2).sqrt() + ADAM_EPS))

    def grads(self, loss) -> dict:
        names = list(self.params)
        gs = torch.autograd.grad(loss, [self.params[k] for k in names], allow_unused=True)
        return {k: g for k, g in zip(names, gs)}


def _forward(sd, images, task, **kw):
    return Forward(sd, task, **kw)(images)


def distill_step(state: State, teacher_sd: dict, images, labels, keep_masks: list, *,
                 current_task: int, prev_tasks, class_weight, lambda_c: float,
                 lr_scale: float, tf32: bool = False):
    """Step 2 (the module docstring). Returns ({"loss", "ce", "kld"} floats,
    raw gradients)."""
    with float32_exact():
        logits = _forward(state.sd(), images, current_task, train=True, update_running=True,
                          keep_masks=keep_masks[0], tf32=tf32)
        ce = cross_entropy(logits, labels, class_weight)
        kl = torch.zeros((), device=images.device)
        for i, t in enumerate(prev_tasks):
            s = _forward(state.sd(), images, t, train=True, update_running=True,
                         keep_masks=keep_masks[1 + i], tf32=tf32)
            with torch.no_grad():
                tl = _forward(teacher_sd, images, t, train=False, tf32=tf32)
            kl = kl + kld(s, tl)
        total = ce + lambda_c * kl
        grads = state.grads(total)
        state.adam(grads, lr_scale)
    return {"loss": total.item(), "ce": ce.item(), "kld": kl.item()}, grads


def two_phase_step(state: State, teacher_sd: dict, images, labels, keep_masks: list, *,
                   current_task: int, prev_tasks, class_weight, lambda_c: float,
                   lr_scale: float, tf32: bool = False):
    """Step 3 (the module docstring). Returns ({"loss", "ce", "kld"} floats,
    the two phases' raw gradients summed)."""
    with float32_exact():
        logits = _forward(state.sd(), images, current_task, train=True, update_running=True,
                          keep_masks=keep_masks[0], tf32=tf32)
        ce = cross_entropy(logits, labels, class_weight)
        g_ce = state.grads(ce)
        del logits
        state.adam(g_ce, lr_scale)
        kl = torch.zeros((), device=images.device)
        for i, t in enumerate(prev_tasks):
            s = _forward(state.sd(), images, t, train=True, update_running=True,
                         keep_masks=keep_masks[1 + i], tf32=tf32)
            with torch.no_grad():
                tl = _forward(teacher_sd, images, t, train=True, tf32=tf32)
            kl = kl + kld(s, tl)
        kd = lambda_c * kl
        g_kd = state.grads(kd)
        state.adam(g_kd, lr_scale)
    grads = {k: g_ce[k] if g_kd[k] is None else g_kd[k] if g_ce[k] is None else g_ce[k] + g_kd[k]
             for k in g_ce}
    return {"loss": ce.item() + kd.item(), "ce": ce.item(), "kld": kl.item()}, grads


STEPS = {"distill": distill_step, "two_phase": two_phase_step}


@torch.no_grad()
def eval_batch(sd: dict, images, labels, *, task: int, class_weight, num_classes: int,
               tf32: bool = False):
    """Eval-mode forward of head `task`: (weighted CE, [C, C] int64 confusion
    matrix cm[label, prediction])."""
    with float32_exact():
        logits = _forward(sd, images, task, train=False, tf32=tf32)
        loss = cross_entropy(logits, labels, class_weight)
        pred = logits.argmax(-1)
    cm = torch.bincount((labels.reshape(-1) * num_classes + pred.reshape(-1)),
                        minlength=num_classes * num_classes)
    return loss.item(), cm.reshape(num_classes, num_classes)


def poly_lr(epoch: int, num_epochs: int, power: float = 0.9) -> float:
    """The reference trainers' LambdaLR factor (1 - (epoch - 1) / E) ** 0.9."""
    return float(np.float64(1.0 - (epoch - 1) / num_epochs) ** power)
