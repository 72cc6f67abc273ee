"""Checkpoint files of the port, written with torch.save.

  * `load_pth_tar`: a reference checkpoint ({epoch, arch, state_dict,
    best_acc, optimizer}, `module.`-prefixed keys; train_RAPFT_step1.py:364-370)
    -> its state dict without the prefix; `load_state`: the state dict of
    a `.pth.tar` or of a checkpoint directory for a model kind, the heads
    renamed to the kind's grammar.
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

from ..config import ABLATION_MODELS
from ..models.erfnet_multihead import KINDS as MULTIHEAD_KINDS
from ..models.erfnet_multihead import head_prefixes
from ..train.optim import AdamState
from ..train.steps import TrainState

MAX_TO_KEEP = 2
_FILE = re.compile(r"^(\d+)\.pt$")
_HEAD = re.compile(r"^(decoder(?:\.\d+|_old|_new|_old1|_old2)?)\.output_conv\.bias$")
# task order of the named heads (erfnet.py `decoder`; erfnet_ftp1.py:139-141 decoder_old,
# decoder_new; erfnet_ftp2.py:139-143 decoder_old1, decoder_old2, decoder_new)
_HEAD_RANK = {"decoder": 0, "decoder_old": 0, "decoder_old1": 0, "decoder_old2": 1,
              "decoder_new": 9}


def load_pth_tar(path: str, *, strip_module: bool = True) -> dict[str, torch.Tensor]:
    """The state dict of a reference checkpoint (or of one of `save`'s
    files) on the CPU, keys without the `module.` prefix that
    nn.DataParallel adds (kept with `strip_module=False`: the ImageNet
    encoder's `module.features.*` keys are renamed as a whole)."""
    blob = torch.load(path, map_location="cpu", weights_only=False)
    sd = blob.get("state_dict", blob) if isinstance(blob, dict) else blob
    return {(k.removeprefix("module.") if strip_module else k): v for k, v in sd.items()}


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


def heads(state_dict) -> list[tuple[str, int]]:
    """(prefix, class count) of every decoder head of a state dict, in task
    order: digit-indexed (`decoder.{t}`: the RAP and multi-task models) or
    named (`decoder`, `decoder_old`, ... : erfnet, ftp1, ftp2)."""
    found = {m.group(1): int(v.shape[0]) for k, v in state_dict.items()
             if (m := _HEAD.match(k.removeprefix("module.")))}

    def order(prefix: str):
        tail = prefix.split(".")[-1]
        return (int(tail), "") if tail.isdigit() else (_HEAD_RANK.get(prefix, 0), prefix)

    return [(p, found[p]) for p in sorted(found, key=order)]


def heads_num_classes(state_dict, where: str) -> list[int]:
    """Per-head class counts from the heads' `output_conv.bias` shapes."""
    found = heads(state_dict)
    if not found:
        raise ValueError(f"no output_conv heads found in {where}")
    return [nc for _, nc in found]


def infer_num_classes(directory: str, *, epoch: int | None = None) -> list[int]:
    """Per-head class counts of a checkpoint directory, read from the saved
    heads' bias shapes without building a model."""
    return heads_num_classes(_load(directory, epoch)["state_dict"], directory)


def load_state(path: str, kind: str) -> dict[str, torch.Tensor]:
    """The reference-grammar state dict of a checkpoint for a `kind` model:
    a reference `.pth.tar` (`load_pth_tar`), or the newest file of one of the
    port's checkpoint directories. For the shared-encoder kinds (multi_task,
    erfnet, ftp1, ftp2) the heads are renamed, in task order, to the kind's
    grammar, so a one-head `decoder.0.*` run (the single-task baseline) loads
    as kind "erfnet" (`decoder.*`), as the JAX package's Orbax runs load as
    any of those kinds (mdilss_tpu/train/protocols.py:65-70). An ablation
    kind loads from a checkpoint directory only: no reference checkpoint or
    torch grammar exists for those models, so a file raises, as the JAX
    package's `load_checkpoint` does (mdilss_tpu/evaluate.py:142-146)."""
    if kind in ABLATION_MODELS and not os.path.isdir(path):
        raise ValueError(
            f"{path} is not a checkpoint directory of this package, and kind {kind!r} has "
            f"no torch checkpoint grammar (a reconstructed ablation model: no reference "
            f".pth.tar exists); it loads from the port's checkpoint directories "
            f"(<savedir>/best) only")
    if os.path.isdir(path):
        if latest_epoch(path) is None:
            raise ValueError(
                f"{path} holds no checkpoint of this package (<epoch>.pt). A checkpoint "
                f"directory of the JAX package (Orbax) is not read here: convert it with "
                f"`python -m mdilss_tpu convert {path} out.pth.tar --export --kind {kind}` "
                f"and pass out.pth.tar")
        sd = _load(path, None)["state_dict"]
    else:
        sd = load_pth_tar(path)
    if kind not in MULTIHEAD_KINDS:
        return sd
    return rename_heads(sd, head_prefixes(kind, len(heads(sd))))


def rename_heads(sd: dict, prefixes: list[str]) -> dict[str, torch.Tensor]:
    """`sd` with its heads, in task order, renamed to `prefixes`."""
    found = [p for p, _ in heads(sd)]
    if len(found) != len(prefixes):
        raise ValueError(f"{len(found)} heads {found} for {len(prefixes)} names {prefixes}")
    rename = dict(zip(found, prefixes))
    out = {}
    for k, v in sd.items():
        src = next((p for p in found if k.startswith(p + ".")), None)
        out[k if src is None else rename[src] + k[len(src):]] = v
    return out


def restore(directory: str, ts: TrainState, *, epoch: int | None = None):
    """Load the newest (or `epoch`'s) checkpoint into `ts.model` in place
    (strict) -> (ts with the saved Adam state, epoch, best_acc, augment
    generator state)."""
    dev = next(ts.model.parameters()).device
    blob = _load(directory, epoch, dev)
    ts.model.load_state_dict(blob["state_dict"], strict=True)
    opt = AdamState(m=blob["opt_m"].to(dev), v=blob["opt_v"].to(dev), count=blob["opt_count"])
    return TrainState(ts.model, opt), blob["epoch"], blob["best_acc"], blob["aug_rng"].cpu()
