"""What the benchmark makes from `--seed` and hands to the program and to the
reference alike: weights as a state dict in the reference checkpoints'
names, and device-resident uint8 data sets.

Everything is drawn on the run's device from one `torch.Generator` seeded
with the run's seed, in a few large calls and in a fixed order, so one seed
gives the same inputs in every run and on every device of a kind.
"""
from __future__ import annotations

import math

import torch

from .reference.erfnet_rap import param_spec


def state_dict(num_classes, gen: torch.Generator, device) -> dict:
    """Random weights of ERFNet-RAP with one task per entry of `num_classes`:
    conv weights and biases uniform in +-1/sqrt(fan_in) (torch's default), BN
    scale U(0.5, 1.5), shift N(0, 0.1), running mean N(0, 0.1), running
    variance U(0.5, 1.5). Two draws in all: one uniform, one normal."""
    spec = param_spec(num_classes)
    sizes = [math.prod(shape) for _, shape, _ in spec]
    uniform_n = sum(s for s, (_, _, init) in zip(sizes, spec)
                    if init[0] in ("conv", "bn_weight", "bn_var"))
    normal_n = sum(s for s, (_, _, init) in zip(sizes, spec) if init[0] in ("bn_bias", "bn_mean"))
    uniform = torch.rand(uniform_n, generator=gen, device=device)
    normal = torch.randn(normal_n, generator=gen, device=device)
    sd, u, g = {}, 0, 0
    for (name, shape, init), n in zip(spec, sizes):
        kind = init[0]
        if kind == "count":
            sd[name] = torch.zeros((), dtype=torch.int64, device=device)
        elif kind in ("bn_bias", "bn_mean"):
            sd[name] = (0.1 * normal[g:g + n]).view(shape)
            g += n
        else:
            x = uniform[u:u + n].view(shape)
            u += n
            if kind == "conv":
                bound = 1.0 / math.sqrt(init[1])
                sd[name] = (2.0 * x - 1.0) * bound
            else:  # bn_weight, bn_var
                sd[name] = x + 0.5
    return sd


def student_from_teacher(student: dict, teacher: dict) -> dict:
    """The student as an incremental step starts it: every tensor the
    teacher has (the shared convs, the old tasks' slices and heads) taken
    from the teacher, the new task's from `student`."""
    return {k: (teacher[k] if k in teacher else v).clone() for k, v in student.items()}


def labelled_images(n: int, height: int, width: int, num_classes: int, gen: torch.Generator,
                    device, chunk: int = 512):
    """n uint8 images [n, H, W, 3] and labels [n, H, W] drawn uniformly: pixels
    in [0, 255], labels in [0, num_classes - 2] and the void label 255 where
    a draw lands on num_classes - 1."""
    images = torch.empty((n, height, width, 3), dtype=torch.uint8, device=device)
    labels = torch.empty((n, height, width), dtype=torch.uint8, device=device)
    for i in range(0, n, chunk):
        j = min(n, i + chunk)
        images[i:j].random_(0, 256, generator=gen)
        lab = labels[i:j]
        lab.random_(0, num_classes, generator=gen)
        lab.masked_fill_(lab == num_classes - 1, 255)
    return images, labels


def take_rows(images: torch.Tensor, labels: torch.Tensor, idx):
    """Rows `idx` (host indices) of a device set: one batch, as the port's
    device cache takes it."""
    di = torch.as_tensor(idx, dtype=torch.int64).to(images.device)
    return images.index_select(0, di), labels.index_select(0, di)
