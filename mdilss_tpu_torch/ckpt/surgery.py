"""Incremental-learning checkpoint surgery on reference-grammar state dicts
(port of mdilss_tpu/ckpt/surgery.py).

The port's modules use the reference's state-dict grammar, so this is the
reference's own load-time key surgery (train_new_task_step2.py:499-530,
train_new_task_step3.py:562-595, train_RAPFT_step1.py:482-491) done on the
state dict:

  * `extend_for_new_task` (step t > 1): every key of the previous model is
    kept; the new task's encoder slots (`bn_ini.{t}`, `bns_{1,2}.{t}`,
    `parallel_conv_{1,2}.{t}`, and the ablation models' `series_conv_{1,2}.{t}`
    and `Wt_{1,2}.{t}`) take their weight and bias (RCM's matrix) from slot
    t-1, their BN running statistics start fresh (mean 0, var 1,
    `num_batches_tracked` 0; the reference copies only weight and bias keys);
    shared BN (onlyrap's `bn`, `bn1`, `bn2`) is left as it is;
    `decoder.{t}` is a copy of `decoder.{t-1}` with its running statistics,
    except `output_conv`, which is freshly initialised (the class count
    differs). It covers ERFNet-RAP and the ablation models, as
    mdilss_tpu/ckpt/surgery.py:47-127 does, and SegFormerRAP, whose slots
    are its per-domain LayerNorms (`norm`, `norm1`, `norm2`, ...) and
    `adapter`s and whose output conv is a 1x1 conv.
  * `merge_state_dict`: torch's `load_state_dict(strict=False)`, `module.`
    stripped: only keys that exist with the same shape are taken.
  * `load_imagenet_encoder` (step 1): `module.features.*` renamed to
    `module.*`, then merged; in the RAP model only the shared encoder convs
    match.
  * `graft_shared_encoder`: the shared encoder convs (downsamplers and every
    nb1d conv pair) of one model into another.
"""
from __future__ import annotations

import math
import re

import numpy as np
import torch

# a task's slot of an encoder entry: group 3 is the entry's kind, None for RCM's
# matrix `Wt_k.{t}` (a parameter of its own, with no suffix)
_SLOT = re.compile(r"^(encoder\.(?:.*\.)?(?:bn_ini|bns_[12]|parallel_conv_[12]|series_conv_[12]"
                   r"|Wt_[12]|norm\d?|adapter))\.(\d+)"
                   r"(?:\.(weight|bias|running_mean|running_var|num_batches_tracked))?$")
_HEAD = re.compile(r"^decoder\.(\d+)\.")
_SHARED_CONV = re.compile(r"^encoder\.(?:initial_block|layers\.\d+)\."
                          r"(?:conv|conv3x1_1|conv1x3_1|conv3x1_2|conv1x3_2)\.(?:weight|bias)$")


def _fresh_slot_entry(kind: str, prev: torch.Tensor) -> torch.Tensor:
    """The new slot's entry from slot t-1's: the affine copied, the running
    statistics a fresh BN's (mean 0, var 1, num_batches_tracked 0)."""
    if kind in ("weight", "bias", None):
        return prev.clone()
    return torch.ones_like(prev) if kind == "running_var" else torch.zeros_like(prev)


def _fresh_output_conv(prev: torch.Tensor, num_classes: int, generator: torch.Generator):
    """(weight, bias [num_classes]) of a new output conv of the shape of the
    previous head's weight `prev`, with torch's default initialisation
    (kaiming_uniform_(a=sqrt(5)) and a uniform bias over 1/sqrt(fan_in)),
    drawn from `generator` on the CPU: ERFNet's `ConvTranspose2d(16,
    num_classes, 2, stride=2)` (weight [16, classes, 2, 2]), or SegFormer's
    1x1 `Conv2d(C, num_classes, 1)` (weight [classes, C, 1, 1])."""
    if prev.shape[-1] == 1:
        w = torch.empty(num_classes, prev.shape[1], 1, 1)
        fan_in = prev.shape[1]
    else:
        w = torch.empty(16, num_classes, 2, 2)
        fan_in = num_classes * 2 * 2  # fan_in of a transposed conv: dim 1
    torch.nn.init.kaiming_uniform_(w, a=math.sqrt(5), generator=generator)
    bound = 1.0 / math.sqrt(fan_in)
    b = torch.empty(num_classes).uniform_(-bound, bound, generator=generator)
    return w, b


def extend_for_new_task(sd: dict, new_num_classes: int, *,
                        generator: torch.Generator) -> dict[str, torch.Tensor]:
    """ERFNet-RAP (ablation model, SegFormerRAP) state dict of t tasks -> the state
    dict of t + 1 tasks
    (rule above); the new head's `output_conv` is drawn from `generator`.
    Every tensor of the result is its own (no tensor of `sd` is shared)."""
    sd = {k.removeprefix("module."): v for k, v in sd.items()}
    heads = [int(m.group(1)) for k in sd if (m := _HEAD.match(k))]
    if not heads:
        raise ValueError("no decoder.{t} heads in the state dict: not an ERFNet-RAP or "
                         "ablation model")
    t = max(heads) + 1
    out = {k: v.clone() for k, v in sd.items()}
    for k, v in sd.items():
        m = _SLOT.match(k)
        if m and int(m.group(2)) == t - 1:
            suffix = "" if m.group(3) is None else f".{m.group(3)}"
            out[f"{m.group(1)}.{t}{suffix}"] = _fresh_slot_entry(m.group(3), v)
        elif k.startswith(f"decoder.{t - 1}.") and ".output_conv." not in k:
            out[f"decoder.{t}." + k[len(f"decoder.{t - 1}."):]] = v.clone()
    w, b = _fresh_output_conv(sd[f"decoder.{t - 1}.output_conv.weight"], new_num_classes,
                              generator)
    out[f"decoder.{t}.output_conv.weight"] = w
    out[f"decoder.{t}.output_conv.bias"] = b
    return out


def _tensor(v, like: torch.Tensor) -> torch.Tensor:
    t = v.detach() if isinstance(v, torch.Tensor) else torch.from_numpy(np.array(v))
    return t.to(dtype=like.dtype, copy=True)


def merge_state_dict(sd_current: dict, sd_in: dict) -> dict[str, torch.Tensor]:
    """`sd_current` with every key of `sd_in` (without `module.`) that exists
    in it with the same shape taken from `sd_in`; the rest kept
    (`load_state_dict(strict=False)`). BN's `num_batches_tracked` is kept too:
    the JAX package keeps no such counter (its export writes 0), and the
    reference's momentum of 0.1 never reads it."""
    merged = dict(sd_current)
    for k, v in sd_in.items():
        k = k.removeprefix("module.")
        if k.endswith("num_batches_tracked"):
            continue
        if k in merged and tuple(merged[k].shape) == tuple(np.shape(v)):
            merged[k] = _tensor(v, merged[k])
    return merged


def load_imagenet_encoder(sd_current: dict, sd_pretrained: dict) -> dict[str, torch.Tensor]:
    """Step-1 init: `module.features.*` -> `module.*`, then `merge_state_dict`
    (train_RAPFT_step1.py:482-502)."""
    renamed = {(k.replace("module.features", "module", 1) if k.startswith("module.features")
                else k): v for k, v in sd_pretrained.items()}
    return merge_state_dict(sd_current, renamed)


def graft_shared_encoder(dst_sd: dict, src_sd: dict) -> dict[str, torch.Tensor]:
    """`dst_sd` with its shared encoder convs (the downsamplers' convs and
    every nb1d conv pair, weights and biases) taken from `src_sd`; its
    per-task adapters and BN, and its decoders, untouched."""
    src = {k.removeprefix("module."): v for k, v in src_sd.items()}
    return {k: (_tensor(src[k], v) if _SHARED_CONV.match(k) else v) for k, v in dst_sd.items()}


def keep_tasks(sd: dict, nb_tasks: int) -> dict[str, torch.Tensor]:
    """The first `nb_tasks` tasks of a digit-indexed state dict (ERFNet-RAP, an
    ablation model or multi_task): the encoder slots and `decoder.{t}` heads of
    later tasks dropped, as the JAX package's converter reads `nb_tasks` tasks
    (mdilss_tpu/ckpt/pth_converter.py `convert_state_dict`)."""
    found = {int(m.group(1)) for k in sd if (m := _HEAD.match(k))}
    if len(found) < nb_tasks:
        raise ValueError(f"the state dict has {len(found)} heads, fewer than {nb_tasks}")

    def task(k: str) -> int | None:
        if m := _SLOT.match(k):
            return int(m.group(2))
        m = _HEAD.match(k)
        return None if m is None else int(m.group(1))

    return {k: v for k, v in sd.items() if (t := task(k)) is None or t < nb_tasks}
