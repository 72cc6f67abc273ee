"""Faults planted under the timed path, for the calibration of the limits
(`calibrate.py`) and the tests that see `correct` come out false. Each is
a context manager that wraps one of the port's step makers in
`mdilss_tpu_torch.train.steps` while it is entered, so a loop built
inside it runs the broken step through its own call and feed:

  unchanged    the step computes as usual but returns the state it was
               given: the parameters put back, Adam's state unchanged;
  half_batch   the step sees the first half of the batch (and of each
               dropout mask), its losses the mean over that half;
  altered      the eval step's answer altered where it is made: each
               batch's confusion matrix with the predictions shifted by
               one class;
  new_lr_on_shared  the training step takes the new task's base LR for the
               shared leaves too (the other LR groups as they are);
  shared_lr_on_new  the training step takes the shared leaves' base LR for
               the new task's leaves.
"""
from __future__ import annotations

import contextlib

import torch

from mdilss_tpu_torch.train import steps

TRAIN_MAKERS = ("make_distill_step", "make_two_phase_distill_step")


def _half_masks(masks):
    if isinstance(masks, (list, tuple)):
        return [_half_masks(m) for m in masks]
    return {k: (v[:, : v.shape[1] // 2] if k == "g64" else v[:, :, : v.shape[2] // 2])
            for k, v in masks.items()}


def _unchanged(make):
    def maker(**kw):
        step = make(**kw)

        def broken(ts, *args):
            saved = {k: p.detach().clone() for k, p in ts.model.named_parameters()}
            _, metrics = step(ts, *args)
            with torch.no_grad():
                for k, p in ts.model.named_parameters():
                    p.copy_(saved[k])
            return ts, metrics
        return broken
    return maker


def _half_batch(make):
    def maker(**kw):
        step = make(**kw)

        def broken(ts, teacher, x, y, masks, epoch):
            h = x.shape[0] // 2
            return step(ts, teacher, x[:h], y[:h], _half_masks(masks), epoch)
        return broken
    return maker


def _half_batch_eval(make):
    def maker(**kw):
        step = make(**kw)

        def broken(model, x, y):
            h = x.shape[0] // 2
            return step(model, x[:h], y[:h])
        return broken
    return maker


def _altered(make):
    def maker(**kw):
        step = make(**kw)

        def broken(model, x, y):
            loss, cm = step(model, x, y)
            return loss, cm.roll(1, dims=1)
        return broken
    return maker


def _lr_moved(to_new: bool):
    """The step maker with one LR group's base LR replaced by the other's:
    the shared leaves' by the new task's (to_new), or the reverse."""
    def wrap(make):
        def maker(**kw):
            tree = kw["lr_tree"]
            shared, new = min(v for v in tree.values() if v > 0), max(tree.values())
            src, dst = (shared, new) if to_new else (new, shared)
            return make(**{**kw, "lr_tree": {k: dst if v == src else v for k, v in tree.items()}})
        return maker
    return wrap


FAULTS = {
    "unchanged": {m: _unchanged for m in TRAIN_MAKERS},
    "half_batch": {**{m: _half_batch for m in TRAIN_MAKERS}, "make_eval_step": _half_batch_eval},
    "altered": {"make_eval_step": _altered},
    "new_lr_on_shared": {m: _lr_moved(True) for m in TRAIN_MAKERS},
    "shared_lr_on_new": {m: _lr_moved(False) for m in TRAIN_MAKERS},
}


@contextlib.contextmanager
def planted(name: str):
    """The step makers of `steps` broken by fault `name` while entered."""
    saved = {m: getattr(steps, m) for m in FAULTS[name]}
    try:
        for m, wrap in FAULTS[name].items():
            setattr(steps, m, wrap(saved[m]))
        yield
    finally:
        for m, f in saved.items():
            setattr(steps, m, f)
