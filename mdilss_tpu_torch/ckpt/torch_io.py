"""Checkpoint files of the port, written with torch.save.

  * `load_pth_tar`: a reference checkpoint ({epoch, arch, state_dict,
    best_acc, optimizer}, `module.`-prefixed keys; train_RAPFT_step1.py:364-370)
    -> its state dict without the prefix.
  * `save` / `latest_epoch` / `restore` / `infer_num_classes`: the trainer's
    checkpoints with true resume, in place of the JAX package's Orbax
    manager (mdilss_tpu/ckpt/orbax_io.py). One file `<directory>/<epoch>.pt`
    per epoch, written to a temporary name and renamed into place; the two
    newest are kept, as Orbax's manager keeps them (max_to_keep=2). A file
    holds the student's state dict in the reference grammar under
    "state_dict" (so `load_pth_tar` and `load_state_dict(strict=True)` read
    it), Adam's moments and step count, the epoch, the best metric and the
    state of the trainer's augment generator.
"""
from __future__ import annotations

import os
import re

import torch

from ..train.optim import AdamState
from ..train.steps import TrainState

MAX_TO_KEEP = 2
_FILE = re.compile(r"^(\d+)\.pt$")
_HEAD = re.compile(r"\.(\d+)\.output_conv\.bias$")


def load_pth_tar(path: str) -> dict[str, torch.Tensor]:
    """The state dict of a reference checkpoint (or of one of `save`'s
    files) on the CPU, keys without the `module.` prefix that
    nn.DataParallel adds."""
    blob = torch.load(path, map_location="cpu", weights_only=False)
    sd = blob.get("state_dict", blob) if isinstance(blob, dict) else blob
    return {k.removeprefix("module."): v for k, v in sd.items()}


def _epochs(directory: str) -> list[int]:
    if not os.path.isdir(directory):
        return []
    return sorted(int(m.group(1)) for f in os.listdir(directory) if (m := _FILE.match(f)))


def _path(directory: str, epoch: int) -> str:
    return os.path.join(directory, f"{epoch}.pt")


def save(directory: str, epoch: int, ts: TrainState, *, best_acc: float, aug_state) -> None:
    """Write the full training state of `epoch`; keep the MAX_TO_KEEP newest
    epochs' files."""
    os.makedirs(directory, exist_ok=True)
    payload = {
        "epoch": int(epoch),
        "best_acc": float(best_acc),
        "state_dict": ts.model.state_dict(),
        "opt_m": ts.opt.m,
        "opt_v": ts.opt.v,
        "opt_count": int(ts.opt.count),
        "aug_rng": aug_state,
    }
    tmp = os.path.join(directory, f".{epoch}.pt.tmp{os.getpid()}")
    torch.save(payload, tmp)
    os.replace(tmp, _path(directory, epoch))
    for old in _epochs(directory)[:-MAX_TO_KEEP]:
        os.unlink(_path(directory, old))


def latest_epoch(directory: str) -> int | None:
    epochs = _epochs(directory)
    return epochs[-1] if epochs else None


def _load(directory: str, epoch: int | None, device="cpu") -> dict:
    step = epoch if epoch is not None else latest_epoch(directory)
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {directory}")
    return torch.load(_path(directory, step), map_location=device, weights_only=True)


def heads_num_classes(state_dict, where: str) -> list[int]:
    """Per-head class counts from the `.{i}.output_conv.bias` shapes of a
    state dict (digit-indexed heads, the RAP model's `decoder.{i}`)."""
    heads = {int(m.group(1)): int(v.shape[0])
             for k, v in state_dict.items() if (m := _HEAD.search(k))}
    if not heads:
        raise ValueError(f"no digit-indexed output_conv heads found in {where}")
    return [heads[i] for i in sorted(heads)]


def infer_num_classes(directory: str, *, epoch: int | None = None) -> list[int]:
    """Per-head class counts of a checkpoint directory, read from the saved
    heads' bias shapes without building a model."""
    return heads_num_classes(_load(directory, epoch)["state_dict"], directory)


def restore(directory: str, ts: TrainState, *, epoch: int | None = None):
    """Load the newest (or `epoch`'s) checkpoint into `ts.model` in place
    (strict) -> (ts with the saved Adam state, epoch, best_acc, augment
    generator state)."""
    dev = next(ts.model.parameters()).device
    blob = _load(directory, epoch, dev)
    ts.model.load_state_dict(blob["state_dict"], strict=True)
    opt = AdamState(m=blob["opt_m"].to(dev), v=blob["opt_v"].to(dev), count=blob["opt_count"])
    return TrainState(ts.model, opt), blob["epoch"], blob["best_acc"], blob["aug_rng"].cpu()
