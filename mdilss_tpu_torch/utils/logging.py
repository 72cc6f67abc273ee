"""Run logging: metrics JSONL + reference-compatible artifacts (port of
mdilss_tpu/utils/logging.py).

The reference wrote a tab-separated `automated_log.txt` (epoch, train loss,
val loss, train IoU, val IoU, lr; train_RAPFT_step1.py:380-382), `best.txt`,
`opts.txt`, `model.txt` and ANSI-coloured console IoU (iouEval.py:92-104).
This module reproduces automated_log.txt and the colour scheme byte for byte
and adds `metrics.jsonl` (one JSON object per epoch) as the machine-readable
record. The JAX package's optional TensorBoard scalars are not ported.
"""
from __future__ import annotations

import json
import os
from typing import Any

AUTOMATED_LOG_HEADER = "Epoch\t\tTrain-loss\t\tTest-loss\t\tTrain-IoU\t\tTest-IoU\t\tlearningRate"


class MetricLogger:
    def __init__(self, savedir: str):
        self.savedir = savedir
        os.makedirs(savedir, exist_ok=True)
        self.jsonl_path = os.path.join(savedir, "metrics.jsonl")
        self.automated_log_path = os.path.join(savedir, "automated_log.txt")
        if not os.path.exists(self.automated_log_path):
            with open(self.automated_log_path, "a") as f:
                f.write(AUTOMATED_LOG_HEADER)

    def log(self, row: dict[str, Any]) -> None:
        with open(self.jsonl_path, "a") as f:
            f.write(json.dumps(row) + "\n")

    def automated_log_row(self, epoch, train_loss, val_loss, train_iou, val_iou, lr):
        with open(self.automated_log_path, "a") as f:
            f.write("\n%d\t\t%.4f\t\t%.4f\t\t%.4f\t\t%.4f\t\t%.8f" % (
                epoch, train_loss, val_loss, train_iou, val_iou, lr))


# ANSI console colouring of IoU values (iouEval.py:80-104 behaviour)
class colors:
    RED = "\033[31;1m"
    YELLOW = "\033[33;1m"
    BLUE = "\033[34;1m"
    CYAN = "\033[36;1m"
    GREEN = "\033[32;1m"
    ENDC = "\033[0m"


def getColorEntry(val) -> str:
    if not isinstance(val, float):
        return colors.ENDC
    if val < 0.20:
        return colors.RED
    if val < 0.40:
        return colors.YELLOW
    if val < 0.60:
        return colors.BLUE
    if val < 0.80:
        return colors.CYAN
    return colors.GREEN
