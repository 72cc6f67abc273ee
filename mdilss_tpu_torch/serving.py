"""Serving functions (port of mdilss_tpu/serving.py:46-59,139-152).

`build_infer_fn` closes over a model and a head and returns the inference
function; `serve_batches` drives it over host batches. The default compute
type is bfloat16, as in the JAX package. Exporting a self-contained
artifact, the JAX package's StableHLO export, is not ported yet.
"""
from __future__ import annotations

import numpy as np
import torch


def build_infer_fn(model, task: int, *, output: str = "logits",
                   compute_dtype=torch.bfloat16):
    """`fn(x [N,H,W,3] float in [0,1])` -> float32 logits [N,H,W,C] or, with
    `output="labels"`, int32 argmax labels [N,H,W], on the model's device.
    Math is the eval protocol (running BN stats) in `compute_dtype`."""
    if output not in ("logits", "labels"):
        raise ValueError(f"output={output!r}: logits or labels")
    device = next(model.parameters()).device

    def fn(x):
        x = torch.as_tensor(x).to(device=device, dtype=compute_dtype)
        logits = model(x, task)
        if output == "labels":
            return logits.argmax(dim=-1).to(torch.int32)
        return logits.float()

    return fn


def serve_batches(fn, batches, height: int, width: int):
    """Run `fn` over host batches (uint8 images are scaled by 1/255),
    yielding numpy outputs; a batch of another resolution raises."""
    for x in batches:
        x = np.asarray(x)
        if x.dtype == np.uint8:
            x = x.astype(np.float32) / 255.0
        if x.shape[1:3] != (height, width):
            raise ValueError(f"batch is {x.shape[1:3]}, the function serves ({height}, {width})")
        yield fn(torch.from_numpy(x)).cpu().numpy()
