"""Eval-time batch preparation (port of mdilss_tpu/data/transforms.py:138-147)."""
from __future__ import annotations

import torch


def prepare_batch(images_u8, labels_u8, *, num_classes: int):
    """uint8 images [N,H,W,3] -> float32 in [0, 1]; uint8 labels [N,H,W] ->
    int32 with the void label 255 relabelled to `num_classes - 1`
    (MyCoTransform(augment=False)). Tensors stay on their device."""
    images = torch.as_tensor(images_u8).to(torch.float32) / 255.0
    labels = torch.as_tensor(labels_u8).to(torch.int32)
    labels = torch.where(labels == 255, num_classes - 1, labels)
    return images, labels
