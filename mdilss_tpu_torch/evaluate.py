"""Checkpoint evaluation: the Evaluation notebook's workflow (port of
mdilss_tpu/evaluate.py).

Build the model for an incremental configuration, load a reference
`.pth.tar` or one of the port's checkpoint directories, and compute each
domain's val mIoU with the notebook's protocol: argmax predictions, the last
class ignored (Evaluation_Notebook cells 4-5; iouEval.py:10-12). Kinds: "rap"
(ERFNet-RAP), "erfnet" (single task), "multi_task", "ftp1" and "ftp2" (the
multi-head baselines), the four ablation models by their reference names
(erfnet_bn, erfnet_onlyRAP, erfnet_RA_series, erfnet_RCM; from the port's
checkpoint directories only: they have no torch grammar), and
"segformer_b5_rap" (SegFormerRAP of the B5 preset).
"""
from __future__ import annotations

import json
import os
from typing import Sequence

import numpy as np
import torch

from . import resolve_device
from .analysis.names import NAMES_BY_DATASET
from .ckpt import torch_io
from .ckpt.surgery import keep_tasks
from .data.loader import Loader, SyntheticSource, device_prefetch
from .data.sources import make_source
from .data.transforms import prepare_batch
from .metrics import IoUEvaluator
from .config import ABLATION_MODELS, SEGFORMER_MODELS
from .models import ERFNetAblation, ERFNetMultiHead, ERFNetRAP, SegFormerRAP
from .models.erfnet_ablations import REFERENCE_NAMES
from .models.erfnet_multihead import KINDS as MULTIHEAD_KINDS
from .ops.precision import no_tf32
from .utils.logging import getColorEntry

KINDS = ("rap", *MULTIHEAD_KINDS, *ABLATION_MODELS, *SEGFORMER_MODELS)


def load_expected(setting: str) -> dict[str, float]:
    """Reference-recorded mIoU for one setting (expected_miou.json, the
    port's copy of the JAX package's: the Evaluation notebook's executed
    outputs, cells 8-22)."""
    path = os.path.join(os.path.dirname(__file__), "expected_miou.json")
    with open(path) as f:
        table = json.load(f)
    if setting not in table:
        known = [k for k in table if not k.startswith("_")]
        raise KeyError(f"unknown setting {setting!r}; known: {known}")
    return {k: v for k, v in table[setting].items() if not k.startswith("_")}


def check_expected(results: dict[str, float], setting: str, *,
                   tolerance_points: float = 0.5) -> tuple[bool, str]:
    """Compare measured per-domain mIoU against the reference record;
    `tolerance_points` is in mIoU percentage points. Returns (ok, report)."""
    expected = load_expected(setting)
    lines, ok = [], True
    for d, exp in expected.items():
        if d not in results:
            lines.append(f"{d}: expected {exp * 100:.2f} but not evaluated")
            ok = False
            continue
        got = results[d]
        delta = (got - exp) * 100
        within = abs(delta) <= tolerance_points
        ok = ok and within
        lines.append(f"{d}: got {got * 100:.2f} expected {exp * 100:.2f} "
                     f"(delta {delta:+.2f} pts) {'OK' if within else 'FAIL'}")
    return ok, "\n".join(lines)


def infer_num_classes(path: str) -> list[int]:
    """Per-head class counts read from the checkpoint itself, a reference
    `.pth.tar` or a checkpoint directory of the port's Trainer (its newest
    file), by the heads' `output_conv.bias` shapes in task order
    (digit-indexed or named heads)."""
    if os.path.isdir(path):
        return torch_io.infer_num_classes(path)
    return torch_io.heads_num_classes(torch_io.load_pth_tar(path), path)


def load_checkpoint(path: str, *, kind: str, num_classes: Sequence[int] | None = None,
                    device=None) -> torch.nn.Module:
    """The checkpoint's `kind` model in eval mode on `device` (None -> the
    CUDA card), loaded strictly. `num_classes=None` infers the heads from
    the checkpoint."""
    if kind not in KINDS:
        raise ValueError(f"unknown kind {kind!r}: one of {KINDS}")
    sd = torch_io.load_state(path, kind)  # first: an ablation kind's file raises here
    if num_classes is None:
        num_classes = infer_num_classes(path)
    if kind == "rap":
        model = ERFNetRAP(list(num_classes), len(num_classes), device="cpu")
    elif kind in SEGFORMER_MODELS:
        model = SegFormerRAP(list(num_classes), len(num_classes), device="cpu")
    elif kind in ABLATION_MODELS:
        model = ERFNetAblation(list(num_classes), len(num_classes), REFERENCE_NAMES[kind],
                               device="cpu")
    else:
        model = ERFNetMultiHead(list(num_classes), kind=kind, device="cpu")
    if kind not in ("erfnet", "ftp1", "ftp2"):  # digit-indexed tasks
        sd = keep_tasks(sd, len(num_classes))
    model.load_state_dict(sd, strict=True)
    return model.to(resolve_device(device))


@no_tf32()
def evaluate_domain(model, task: int, num_classes: int, batches):
    """(mIoU, per-class IoU) of head `task` over `batches`, any iterable of
    (images uint8 [N,H,W,3], labels uint8 [N,H,W], valid bool [N]) arrays or
    tensors, as a Loader or `device_prefetch` yields them; invalid (padding)
    images count nowhere. Runs in the model's floating type on its device
    (float32 with TF32 off)."""
    p = next(model.parameters())
    ev = IoUEvaluator(num_classes, num_classes - 1)
    for imgs, lbls, valid in batches:
        x, y = prepare_batch(torch.as_tensor(imgs).to(p.device),
                             torch.as_tensor(lbls).to(p.device), num_classes=num_classes)
        valid = torch.as_tensor(valid).to(p.device).bool()
        y = torch.where(valid[:, None, None], y, num_classes - 1)
        preds = model(x.to(p.dtype), task).argmax(dim=-1)
        ev.add_batch(preds, y)
    return ev.get_iou()


def evaluate_checkpoint(
    ckpt: str,
    *,
    kind: str,
    datasets: Sequence[str],
    num_classes: Sequence[int] | None = None,
    data_roots: dict[str, str] | None = None,
    subset: str = "val",
    batch_size: int = 1,
    height: int = 512,
    width: int = 1024,
    synthetic: bool = False,
    compute_dtype: str = "float32",
    return_per_class: bool = False,
    device=None,
):
    """Evaluate every domain head of a checkpoint; prints and returns the
    mIoUs ({dataset: mIoU}, plus {dataset: per-class IoU float64} with
    `return_per_class`).

    float32 runs on `device` (None -> the CUDA card). `compute_dtype=
    "float64"` runs the model in float64 on the CPU's plain path and needs
    `device="cpu"` (the CUDA kernels take float32 and bfloat16 only): the
    logits then differ from another float64 implementation by far less than
    any top-2 gap, so per-class IoU is bit-comparable with the JAX package's
    float64 run (tests/test_torch_evaluate.py)."""
    if compute_dtype == "float64":
        if device is None or torch.device(device).type != "cpu":
            raise ValueError(
                "compute_dtype='float64' runs on the CPU's plain path only (the CUDA "
                "kernels take float32 and bfloat16): pass device='cpu'")
    elif compute_dtype != "float32":
        raise ValueError(f"compute_dtype={compute_dtype!r}: float32 or float64")
    if num_classes is None:
        num_classes = infer_num_classes(ckpt)
        print(f"inferred num_classes {list(num_classes)} from {ckpt}")
    if len(num_classes) != len(datasets):
        raise ValueError(f"{len(datasets)} datasets but {len(num_classes)} heads "
                         f"({list(num_classes)}) in {ckpt}")
    model = load_checkpoint(ckpt, kind=kind, num_classes=num_classes, device=device)
    if compute_dtype == "float64":
        model = model.to(torch.float64)
    dev = next(model.parameters()).device
    results: dict[str, float] = {}
    per_class_by_dataset: dict[str, np.ndarray] = {}
    data_roots = data_roots or {}
    for t, (d, nc) in enumerate(zip(datasets, num_classes)):
        if synthetic or d not in data_roots:
            source = SyntheticSource(nc, n=8, height=height, width=width)
        else:
            source = make_source(d, data_roots[d], subset)
        loader = Loader(source, batch_size=batch_size, height=height, width=width)
        miou, per_class = evaluate_domain(model, t, nc, device_prefetch(loader, device=dev))
        # the per-class table with class names, ANSI-coloured like the
        # notebook's eval cell (Evaluation_Notebook cell 5; iouEval.py:92-104)
        names = NAMES_BY_DATASET.get(d, [])
        for ci, iou in enumerate(per_class):
            name = names[ci] if ci < len(names) else f"class {ci}"
            print(f"  {getColorEntry(float(iou))}{iou * 100:6.2f}\033[0m%  {name}")
        print(f"{d}: mIoU {getColorEntry(miou)}{miou * 100:.2f}\033[0m% over "
              f"{len(per_class)} classes")
        results[d] = miou
        per_class_by_dataset[d] = per_class
    if return_per_class:
        return results, per_class_by_dataset
    return results
