"""Per-domain evaluation (port of mdilss_tpu/evaluate.py:155-168): the
Evaluation notebook's protocol, argmax predictions with ignore = last class."""
from __future__ import annotations

import numpy as np
import torch

from .data.transforms import prepare_batch
from .metrics import IoUEvaluator


def evaluate_domain(model, task: int, num_classes: int, batches):
    """(mIoU, per-class IoU) of head `task` over `batches`, any iterable of
    (images uint8 [N,H,W,3], labels uint8 [N,H,W], valid bool [N]) as the
    JAX package's Loader yields them; invalid (padding) images count nowhere.
    Runs in float32 on the model's device."""
    device = next(model.parameters()).device
    ev = IoUEvaluator(num_classes, num_classes - 1)
    for imgs, lbls, valid in batches:
        x, y = prepare_batch(torch.from_numpy(np.asarray(imgs)).to(device),
                             torch.from_numpy(np.asarray(lbls)).to(device),
                             num_classes=num_classes)
        valid = torch.from_numpy(np.asarray(valid, dtype=bool)).to(device)
        y = torch.where(valid[:, None, None], y, num_classes - 1)
        preds = model(x, task).argmax(dim=-1)
        ev.add_batch(preds, y)
    return ev.get_iou()
