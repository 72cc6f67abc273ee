"""The program's side of an `erfnet_rap` configuration: the port's ERFNet-RAP
(`mdilss_tpu_torch.models.ERFNetRAP`) built on the run's device with the
benchmark's weights loaded strictly, its LR dict as the Trainer builds it,
and the port's kernels built before the first batch. Configuration keys
read: `num_classes`, `teacher_num_classes`, `current_task`, `lr`,
`shared_lr`."""
from __future__ import annotations

import torch

from mdilss_tpu_torch.models import ERFNetRAP
from mdilss_tpu_torch.ops import _build
from mdilss_tpu_torch.train.masks import rap_lr_tree


def build_kernels(device: torch.device) -> None:
    """Every CUDA source of the port compiled (one nvcc each, at once) into
    the checkout's build directory, or found there from an earlier run."""
    if device.type == "cuda":
        _build.build(_build.all_sources())


def model(num_classes, state_dict: dict, device: torch.device) -> torch.nn.Module:
    m = ERFNetRAP(list(num_classes), len(num_classes), device=device)
    m.load_state_dict(state_dict, strict=True)
    return m


def lr_tree(student: torch.nn.Module, config: dict) -> dict[str, float]:
    return rap_lr_tree(student, current_task=config["current_task"],
                       shared_lr=config["shared_lr"], ds_lr=config["lr"])
