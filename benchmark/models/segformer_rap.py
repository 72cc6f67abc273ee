"""The program's side of a `segformer_rap` configuration: the port's
SegFormerRAP (`mdilss_tpu_torch.models.SegFormerRAP`) of the configuration's
widths and depths, built on the run's device with the benchmark's weights
loaded strictly, and its LR dict as the Trainer builds it. Configuration
keys read: `embed_dims`, `num_heads`, `depths`, `sr_ratios`, `mlp_ratios`,
`decoder_embed_dim`, `drop_path_rate`, `dropout_ratio`, `current_task`,
`lr`, `shared_lr`."""
from __future__ import annotations

import torch

from benchmark.reference.segformer_rap import spec_of
from mdilss_tpu_torch.models.segformer_rap import SegFormerRAP, SegFormerSpec
from mdilss_tpu_torch.train.masks import rap_lr_tree


def build_kernels(device: torch.device) -> None:
    """Nothing to build: the model runs torch's and cuDNN's kernels, no CUDA
    source of the port."""


def model(num_classes, state_dict: dict, device: torch.device, config: dict) -> torch.nn.Module:
    m = SegFormerRAP(list(num_classes), len(num_classes), spec=SegFormerSpec(**spec_of(config)),
                     device="meta")
    m.load_state_dict(state_dict, strict=True, assign=True)
    return m.to(device)


def lr_tree(student: torch.nn.Module, config: dict) -> dict[str, float]:
    return rap_lr_tree(student, current_task=config["current_task"],
                       shared_lr=config["shared_lr"], ds_lr=config["lr"])
