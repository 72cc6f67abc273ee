"""Colorized prediction dumps, the notebooks' "save output coloured maps for
analysis" workflow (port of mdilss_tpu/analysis/predict.py; Plot_Tsne_Notebook
cell 0, Colorize in transform.py:82-105). Writes one RGB PNG per val image:
the argmax predictions (and optionally the ground truth) through the
Cityscapes+IDD palette. PIL is imported when the function runs."""
from __future__ import annotations

import os

import numpy as np
import torch

from .. import resolve_device
from ..data.colorize import colorize
from ..data.loader import Loader
from ..data.transforms import prepare_batch
from ..ops.precision import no_tf32


@no_tf32()
def save_predictions(
    model,
    source,
    *,
    task: int,
    num_classes: int,
    out_dir: str,
    max_images: int | None = None,
    save_gt: bool = False,
    batch_size: int = 1,
    height: int = 512,
    width: int = 1024,
    device=None,
) -> list[str]:
    """Head `task` of `model` (moved to `device`, None -> the CUDA card) over
    `source`; returns the written file paths (named after the source images,
    else `<source name>_<index>`), stopping after `max_images` images."""
    from PIL import Image

    dev = resolve_device(device)
    model = model.to(dev).eval()
    os.makedirs(out_dir, exist_ok=True)
    loader = Loader(source, batch_size=batch_size, height=height, width=width)
    pairs = getattr(source, "pairs", None)
    written: list[str] = []
    for b, (imgs, lbls, valid) in enumerate(loader):
        x, y = prepare_batch(torch.from_numpy(imgs), torch.from_numpy(lbls),
                             num_classes=num_classes)
        preds = model(x.to(dev), task).argmax(dim=-1).cpu().numpy()
        for i in range(preds.shape[0]):
            if not valid[i]:
                continue
            idx = b * batch_size + i
            if pairs is not None:
                stem = os.path.splitext(os.path.basename(pairs[idx][0]))[0]
            else:
                stem = f"{source.name}_{idx:05d}"
            path = os.path.join(out_dir, f"{stem}_pred.png")
            Image.fromarray(colorize(preds[i], num_classes)).save(path)
            written.append(path)
            if save_gt:
                gt_path = os.path.join(out_dir, f"{stem}_gt.png")
                Image.fromarray(colorize(y[i].numpy(), num_classes)).save(gt_path)
                written.append(gt_path)
            if max_images is not None and len(written) >= max_images * (2 if save_gt else 1):
                return written
    return written
