"""ERFNet and ERFNet-RAP encoder/decoder assembly (port of
mdilss_tpu/models/topology.py).

  Encoder: initial_block Down(3->16); layers = Down(16->64); 5x nb1d(64, d=1);
           Down(64->128); 2x [nb1d(128, d) for d in 2, 4, 8, 16]
  Decoder: layers = Up(128->64); 2x nb1d(64, 1); Up(64->16); 2x nb1d(16, 1);
           output_conv = ConvTranspose2d(16 -> num_classes, k2 s2)

The RAP encoder's blocks carry per-task adapters and BN; the plain encoder's
share one BN each (the multi-head and single-task models); an ablation
encoder (`variant`) has that variant's blocks and, except onlyrap, per-task
downsampler BN. The layers are a flat ModuleList in reference order, and the
decoder returns spatial logits (the JAX package's packed head is a TPU
layout trick). The JAX package's scan groups exist here as the remat regions
of a `remat=True` training forward (`ENCODER_REGIONS`, `DECODER_REGIONS`):
each group64 block and each group128 chain of four blocks of the encoder,
each nb1d block of the decoder, checkpointed by `_ckpt` as JAX's `_ckpt`
checkpoints them (mdilss_tpu/models/topology.py:39-51, :244-274, :311-324),
saving nothing inside a region and replaying it in the backward. The
downsamplers, the upsamplers and the output conv stay outside every region.
The outputs and gradients are those of the forward without regions.

Training-mode dropout takes host keep-masks drawn by `make_dropout_masks`,
with the JAX package's shapes and numpy draws, so one np.random.Generator
gives both packages the same masks.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.norm import replaying, sync_mesh, synced
from ..parallel.mesh import shard_rows
from ..utils.profiling import spanned
from .blocks import (PER_TASK_BN_VARIANTS, DownsamplerBlock, NonBottleneck1d,
                     NonBottleneck1dAblation, NonBottleneck1dRAP, UpsamplerBlock)

# (kind, *args): ("down", nin, nout) | ("nb", ch, dropprob, dilated)
ENCODER_PLAN: tuple = (
    ("down", 16, 64),
    *[("nb", 64, 0.03, 1)] * 5,
    ("down", 64, 128),
    *[("nb", 128, 0.3, d) for _ in range(2) for d in (2, 4, 8, 16)],
)

DECODER_PLAN: tuple = (
    ("up", 128, 64),
    ("nb", 64, 0.0, 1),
    ("nb", 64, 0.0, 1),
    ("up", 64, 16),
    ("nb", 16, 0.0, 1),
    ("nb", 16, 0.0, 1),
)

GROUP128_DILATIONS = (2, 4, 8, 16)
# remat regions: (first layer, layer count) over Encoder.layers, each group64
# block and each group128 chain (mdilss_tpu/models/topology.py:244-249, :262-274);
# the index of each nb1d block of Decoder.layers (:311-324)
ENCODER_REGIONS = tuple((1 + i, 1) for i in range(5)) + tuple(
    (7 + 4 * rep, len(GROUP128_DILATIONS)) for rep in range(2))
DECODER_REGIONS = tuple(i for i, spec in enumerate(DECODER_PLAN) if spec[0] == "nb")
KEEP64, KEEP128 = 1 - 0.03, 1 - 0.3  # keep probabilities of the two encoder groups


def dropout_mask_shapes(batch: int) -> dict:
    """Shapes of the encoder's host keep-masks (mdilss_tpu/models/topology.py:146-158):
    g64 for encoder.layers.1-5, g128[rep, j] for encoder.layers.{7 + 4*rep + j}."""
    return {
        "g64": (5, batch, 1, 1, 64),
        "g128": (2, len(GROUP128_DILATIONS), batch, 1, 1, 128),
    }


@spanned("data.masks")
def make_dropout_masks(np_rng: np.random.Generator, batch: int) -> dict:
    """Bernoulli keep-masks for one training forward, drawn as the JAX package
    draws them (g64 first, then g128)."""
    shapes = dropout_mask_shapes(batch)
    return {
        "g64": np_rng.random(shapes["g64"]) < KEEP64,
        "g128": np_rng.random(shapes["g128"]) < KEEP128,
    }


def shard_dropout_masks(drop_masks: dict | None, mesh) -> dict | None:
    """The rows of `make_dropout_masks(rng, B)` for the global batch B of
    this rank's data index (`parallel.shard_rows` along each mask's batch
    axis): a mask is per image and channel, the same on every spatial rank
    of the image."""
    if drop_masks is None:
        return None
    axes = {k: len(v) - 4 for k, v in dropout_mask_shapes(1).items()}
    return {k: shard_rows(np.asarray(v), mesh, axes[k]) for k, v in drop_masks.items()}


def layer_drop_masks(drop_masks: dict, device) -> dict[int, torch.Tensor]:
    """`make_dropout_masks` output -> {encoder layer index: keep-mask [N, C]} on
    `device`. Both masks go over in one copy of one host block; on a CUDA
    device the block is pinned and the copy does not wait for the queue
    (torch's caching host allocator keeps the block until the copy has run)."""
    g64, g128 = np.asarray(drop_masks["g64"]), np.asarray(drop_masks["g128"])
    host = torch.from_numpy(np.concatenate([g64.ravel(), g128.ravel()]))
    if torch.device(device).type == "cuda":
        flat = host.pin_memory().to(device, non_blocking=True)
    else:
        flat = host.to(device)
    g64, g128 = (part.view(a.shape) for part, a in zip(flat.split([g64.size, g128.size]),
                                                         (g64, g128)))
    out = {1 + i: g64[i].reshape(g64.shape[1], -1) for i in range(g64.shape[0])}
    for rep in range(g128.shape[0]):
        for j in range(g128.shape[1]):
            out[7 + 4 * rep + j] = g128[rep, j].reshape(g128.shape[2], -1)
    return out


@contextlib.contextmanager
def _replay(mesh):
    """The recompute context of a region: `replaying`, and the forward's
    sync-BN mesh (the backward may run in another thread), so the replay
    issues the forward's collectives again, in the same order on every rank."""
    with replaying(), synced(mesh):
        yield


def _ckpt(fn, *args):
    """fn(*args) as a remat region (the counterpart of JAX's `_ckpt` with its
    save-nothing policy): the forward keeps only the region's inputs, and the
    backward replays fn on them under `ops.norm.replaying`, so the running
    statistics are updated once. The forward draws no random numbers (dropout
    comes from host masks, passed in `args`), so no RNG state is kept."""
    mesh = sync_mesh()
    return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False,
                      context_fn=lambda: (contextlib.nullcontext(), _replay(mesh)))


def _regions_on(module: nn.Module, remat: bool) -> bool:
    """Whether a forward of `module` runs its remat regions: `remat`, in training
    mode, with grad enabled (a no_grad forward, the teacher's, saves nothing)."""
    return remat and module.training and torch.is_grad_enabled()


class Encoder(nn.Module):
    """`nb_tasks` an int: the RAP encoder, every BN per-task (`bn_ini` /
    `bns_*`) beside per-task adapters. None: the plain ERFNet encoder
    (reference models/erfnet.py), one shared `bn` per downsampler and
    `bn1` / `bn2` per block, with the same dropout rates. `variant` (with
    `nb_tasks`): an ablation encoder (mdilss_tpu/models/topology.py
    `encoder_init(variant=...)`), its blocks `NonBottleneck1dAblation`, its
    downsampler BN per task except onlyrap's."""

    def __init__(self, nb_tasks: int | None, variant: str | None = None):
        super().__init__()
        if variant is not None and nb_tasks is None:
            raise ValueError(f"the {variant!r} ablation encoder needs nb_tasks")
        # the downsamplers' BN is per task unless the variant's BN is shared (onlyrap)
        ds_tasks = nb_tasks if variant is None or variant in PER_TASK_BN_VARIANTS else None

        def nb(ch: int, dropprob: float, dilated: int) -> nn.Module:
            if variant is not None:
                return NonBottleneck1dAblation(ch, dilated, nb_tasks, variant, dropprob)
            if nb_tasks is None:
                return NonBottleneck1d(ch, dilated, dropprob)
            return NonBottleneck1dRAP(ch, dilated, nb_tasks, dropprob)

        self.initial_block = DownsamplerBlock(3, 16, ds_tasks)
        self.layers = nn.ModuleList([
            DownsamplerBlock(spec[1], spec[2], ds_tasks) if spec[0] == "down" else nb(*spec[1:])
            for spec in ENCODER_PLAN
        ])

    def forward(self, x: torch.Tensor, task: int | None, drop_masks: dict | None = None,
                remat: bool = False) -> torch.Tensor:
        """`task` selects the RAP encoder's slices (the plain encoder ignores
        it). `drop_masks` (training only): `make_dropout_masks` output, or
        None for no dropout. `remat` (training with grad only): each of
        `ENCODER_REGIONS` a remat region, its blocks' keep-masks its inputs."""
        masks = {} if drop_masks is None or not self.training else layer_drop_masks(
            drop_masks, x.device)
        span = lambda a, b: [masks.get(i) for i in range(a, b)]  # noqa: E731
        x = self.initial_block(x, task)
        if not _regions_on(self, remat):
            return self._span(x, task, 0, *span(0, len(self.layers)))
        done = 0
        for first, count in ENCODER_REGIONS:
            x = self._span(x, task, done, *span(done, first))  # the downsampler before it
            x = _ckpt(self._span, x, task, first, *span(first, first + count))
            done = first + count
        return self._span(x, task, done, *span(done, len(self.layers)))

    def _span(self, x: torch.Tensor, task: int | None, first: int, *masks) -> torch.Tensor:
        """Layers first, first + 1, ... on x, one per keep-mask (or None) in `masks`."""
        for i, mask in enumerate(masks, first):
            layer = self.layers[i]
            x = layer(x, task) if isinstance(layer, DownsamplerBlock) else layer(x, task, mask)
        return x


class Decoder(nn.Module):
    """Per-task decoder head; never carries RAP adapters."""

    def __init__(self, num_classes: int):
        super().__init__()
        self.layers = nn.ModuleList([
            UpsamplerBlock(spec[1], spec[2]) if spec[0] == "up"
            else NonBottleneck1d(spec[1], spec[3], spec[2])
            for spec in DECODER_PLAN
        ])
        self.output_conv = nn.ConvTranspose2d(16, num_classes, 2, stride=2)

    def forward(self, x: torch.Tensor, return_penultimate: bool = False, remat: bool = False):
        """Logits [N, num_classes, 2H', 2W']; with `return_penultimate`, also the
        16-channel features entering `output_conv` (mdilss_tpu/models/topology.py
        `decoder_apply(return_penultimate=True)`). `remat` (training with grad
        only): each nb1d block a remat region (`DECODER_REGIONS`)."""
        regions = DECODER_REGIONS if _regions_on(self, remat) else ()
        for i, layer in enumerate(self.layers):
            x = _ckpt(layer, x) if i in regions else layer(x)
        dt = x.dtype
        out = nn.functional.conv_transpose2d(
            x, self.output_conv.weight.to(dt), self.output_conv.bias.to(dt), stride=2
        )
        return (out, x) if return_penultimate else out
