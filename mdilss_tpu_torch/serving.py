"""Serving: the inference function of one head, and self-contained per-head
artifacts (port of mdilss_tpu/serving.py).

`build_infer_fn` closes over a model and a head and returns the inference
function; `serve_fn_batches` drives such a function over host batches. The
default compute type is bfloat16, as in the JAX package.

`export_checkpoint` writes each domain head of a checkpoint as a
self-contained program, in place of the JAX package's StableHLO artifacts:
`torch.export` traces the head with its task fixed and its output mode
(logits, or the argmax labels) baked in, and `torch.export.save` writes the
graph and the weights into one file. The eval forward's nb1d blocks are the
custom op `mdilss::nb1d_infer` in the graph, so an exported head runs the
hand-written kernel on the card. A program is traced on one device, so each
platform gets its own file:

    serving/
      meta.json                kind, per-task class counts, shapes, output
                               mode, dtype, torch version, platforms
      head0.cuda.pt2           task 0 traced on the CUDA card
      head0.cpu.pt2            ... and on the CPU (plain versions)
      head1.cuda.pt2           ...

`load_head(dir, task)` registers the custom op (by importing
`ops.nb1d_infer`) and returns the program's module for the artifact of the
device; `serve_batches(dir, task, batches)` runs it over host batches.
Whoever loads an artifact in their own process imports `mdilss_tpu_torch`
first, for the same reason.
"""
from __future__ import annotations

import json
import os
from typing import Sequence

import numpy as np
import torch
from torch import nn

from . import resolve_device
from .ops.precision import no_tf32

_FMT = "head{t}.{platform}.pt2"
PLATFORMS = ("cuda", "cpu")
_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


class ServingHead(nn.Module):
    """Head `task` of `model` as a module of the image alone: `forward(x
    [N,H,W,3] float in [0,1])` -> float32 logits [N,H,W,C] or, with
    `output="labels"`, int32 argmax labels [N,H,W]; the eval protocol
    (running BN statistics) in `compute_dtype`."""

    def __init__(self, model: nn.Module, task: int, output: str = "logits",
                 compute_dtype=torch.bfloat16):
        super().__init__()
        if output not in ("logits", "labels"):
            raise ValueError(f"output={output!r}: logits or labels")
        self.model, self.task, self.output, self.compute_dtype = model, task, output, compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        logits = self.model(x.to(self.compute_dtype), self.task)
        if self.output == "labels":
            return logits.argmax(dim=-1).to(torch.int32)
        return logits.float()


def build_infer_fn(model, task: int, *, output: str = "logits",
                   compute_dtype=torch.bfloat16):
    """`fn(x [N,H,W,3] float in [0,1])` -> float32 logits [N,H,W,C] or, with
    `output="labels"`, int32 argmax labels [N,H,W], on the model's device
    (`ServingHead`; float32 convs with TF32 off)."""
    head = ServingHead(model, task, output, compute_dtype)
    device = next(model.parameters()).device

    def fn(x):
        with no_tf32():
            return head(torch.as_tensor(x).to(device))

    return fn


def _host_batches(batches, height: int, width: int):
    """Host batches as float32 arrays (uint8 images scaled by 1/255); a batch
    of another resolution raises."""
    for x in batches:
        x = np.asarray(x)
        if x.dtype == np.uint8:
            x = x.astype(np.float32) / 255.0
        if x.shape[1:3] != (height, width):
            raise ValueError(f"batch is {x.shape[1:3]}, the head serves ({height}, {width})")
        yield torch.from_numpy(x)


def serve_fn_batches(fn, batches, height: int, width: int):
    """Run `fn` (e.g. `build_infer_fn`'s) over host batches, yielding numpy
    outputs; a batch of another resolution raises."""
    for x in _host_batches(batches, height, width):
        yield fn(x).cpu().numpy()


def export_head(model: nn.Module, task: int, *, height: int, width: int,
                batch_size: int | None = 1, output: str = "logits",
                compute_dtype=torch.bfloat16) -> torch.export.ExportedProgram:
    """Trace head `task` of `model` on the model's device with torch.export.
    `batch_size=None` exports a symbolic batch dimension (traced at batch 2:
    torch.export specialises a dimension of size 1)."""
    device = next(model.parameters()).device
    head = ServingHead(model.eval(), task, output, compute_dtype)
    n = 2 if batch_size is None else batch_size
    example = (torch.rand(n, height, width, 3, device=device),)
    dynamic = None if batch_size else {"x": {0: torch.export.Dim("batch", min=1)}}
    with torch.no_grad():  # one flat graph: no grad-mode regions to record
        return torch.export.export(head, example, dynamic_shapes=dynamic)


def export_checkpoint(ckpt: str, *, kind: str, num_classes: Sequence[int] | None = None,
                      out_dir: str, tasks: Sequence[int] | None = None,
                      height: int = 512, width: int = 1024,
                      batch_size: int | None = 1, output: str = "logits",
                      compute_dtype: str = "bfloat16",
                      platforms: Sequence[str] = ("cuda",)) -> dict:
    """Export every (or the selected) domain head of a checkpoint (a
    reference `.pth.tar` or a checkpoint directory of the port) into
    `out_dir`, one file per head and platform ("cuda", "cpu"); returns and
    writes meta.json."""
    from .evaluate import infer_num_classes, load_checkpoint

    bad = [p for p in platforms if p not in PLATFORMS]
    if bad or not platforms:
        raise ValueError(f"platforms {list(platforms)}: each one of {PLATFORMS}")
    if compute_dtype not in _DTYPES:
        raise ValueError(f"compute_dtype={compute_dtype!r}: one of {tuple(_DTYPES)}")
    if num_classes is None:
        num_classes = infer_num_classes(ckpt)
    tasks = list(range(len(num_classes))) if tasks is None else list(tasks)
    os.makedirs(out_dir, exist_ok=True)
    sizes: dict[str, dict[str, int]] = {str(t): {} for t in tasks}
    for platform in platforms:
        model = load_checkpoint(ckpt, kind=kind, num_classes=list(num_classes),
                                device=resolve_device(platform))
        for t in tasks:
            program = export_head(model, t, height=height, width=width, batch_size=batch_size,
                                  output=output, compute_dtype=_DTYPES[compute_dtype])
            path = os.path.join(out_dir, _FMT.format(t=t, platform=platform))
            torch.export.save(program, path)
            sizes[str(t)][platform] = os.path.getsize(path)
        del model
    meta = {
        "kind": kind,
        "num_classes": list(num_classes),
        "tasks": tasks,
        "height": height,
        "width": width,
        "batch_size": batch_size,  # null => symbolic batch
        "output": output,
        "compute_dtype": compute_dtype,
        "platforms": list(platforms),
        "torch_version": torch.__version__,
        "artifact_bytes": sizes,  # {task: {platform: bytes}}
        "source_checkpoint": os.path.abspath(ckpt),
    }
    with open(os.path.join(out_dir, "meta.json"), "w") as f:
        json.dump(meta, f, indent=2)
    return meta


def load_meta(export_dir: str) -> dict:
    with open(os.path.join(export_dir, "meta.json")) as f:
        return json.load(f)


def load_head(export_dir: str, task: int, device=None) -> nn.Module:
    """The exported head `task` for `device` (None -> the CUDA card): the
    module of its program, `fn(x [N,H,W,3] float on that device)`, its
    weights without gradients. Raises
    when the directory holds no artifact of that device's platform."""
    from .ops import nb1d_infer  # noqa: F401  registers mdilss::nb1d_infer

    platform = resolve_device(device).type
    path = os.path.join(export_dir, _FMT.format(t=task, platform=platform))
    if not os.path.exists(path):
        there = sorted(p for p in PLATFORMS if os.path.exists(
            os.path.join(export_dir, _FMT.format(t=task, platform=p))))
        raise FileNotFoundError(f"{export_dir} holds no {platform} artifact of head {task} "
                                f"(platforms there: {there}); export it with "
                                f"--platforms {platform}")
    return torch.export.load(path).module().requires_grad_(False)


def serve_batches(export_dir: str, task: int, batches, device=None):
    """Run exported head `task` over host uint8/float batches on `device`
    (None -> the CUDA card), yielding numpy outputs (float32 convs with TF32
    off); a batch of another resolution raises."""
    dev = resolve_device(device)
    fn = load_head(export_dir, task, dev)
    meta = load_meta(export_dir)
    for x in _host_batches(batches, meta["height"], meta["width"]):
        with no_tf32():
            yield fn(x.to(dev)).cpu().numpy()
