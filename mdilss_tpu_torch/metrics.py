"""Streaming mIoU through a confusion matrix (port of mdilss_tpu/metrics.py).

The reference's iouEval ignore semantics (iouEval.py:10-77):
  * `ignore_index` (the last class by convention) is dropped from the
    per-class IoU;
  * pixels predicted as the ignore class count as false negatives of their
    true class, never as false positives;
  * pixels whose target is the ignore class count nowhere.
IoU_c = tp / (tp + fp + fn + 1e-15); mIoU = mean over the kept classes.
"""
from __future__ import annotations

import numpy as np
import torch


def confusion_matrix(preds, targets, *, num_classes: int) -> torch.Tensor:
    """[N,H,W] integer preds/targets -> [C, C] int64 counts cm[target, pred],
    on the inputs' device. As `jnp.bincount(length=C*C)`: a flat index below 0
    counts in bin 0 and one of C*C or more is dropped."""
    cc = num_classes * num_classes
    idx = targets.reshape(-1).to(torch.int64) * num_classes + preds.reshape(-1).to(torch.int64)
    idx = idx.clamp(min=0)
    cm = torch.bincount(idx[idx < cc], minlength=cc)
    return cm.reshape(num_classes, num_classes)


def iou_from_confusion(cm, ignore_index: int | None):
    """Per-class IoU and their mean, float64 host math."""
    cm = np.asarray(cm, dtype=np.float64)
    tp = np.diag(cm)
    fn = cm.sum(axis=1) - tp
    fp = cm.sum(axis=0) - tp
    keep = np.ones(cm.shape[0], dtype=bool)
    if ignore_index is not None:
        fp = fp - cm[ignore_index, :]
        keep[ignore_index] = False
    iou = tp[keep] / (tp[keep] + fp[keep] + fn[keep] + 1e-15)
    return float(iou.mean()), iou


class IoUEvaluator:
    """Streaming evaluator with iouEval(nClasses, ignoreIndex) semantics; an
    `ignore_index >= num_classes` means no ignore class. Totals accumulate
    on the host in int64."""

    def __init__(self, num_classes: int, ignore_index: int | None = None):
        self.num_classes = num_classes
        if ignore_index is not None and ignore_index >= num_classes:
            ignore_index = None
        self.ignore_index = ignore_index
        self.reset()

    def reset(self):
        self._cm = np.zeros((self.num_classes, self.num_classes), dtype=np.int64)

    def add_batch(self, preds, targets):
        """preds/targets: [N,H,W] integer class maps (tensors or arrays)."""
        cm = confusion_matrix(torch.as_tensor(preds), torch.as_tensor(targets),
                              num_classes=self.num_classes)
        self._cm += cm.cpu().numpy()

    def get_iou(self):
        """(mean IoU, per-class IoU over the non-ignore classes)."""
        return iou_from_confusion(self._cm, self.ignore_index)
