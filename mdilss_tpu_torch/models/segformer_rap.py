"""SegFormer with the incremental rule of ERFNet-RAP: per-domain LayerNorms,
a per-domain adapter in every block and one head per domain, beside a
shared MiT encoder.

The published model (Xie et al., "SegFormer", NeurIPS 2021,
arXiv:2105.15203; NVlabs/SegFormer mix_transformer.py `mit_b5` and the
all-MLP head of segformer.b5.1024x1024.city.160k), `spec="b5"`:

  encoder  four stages of widths 64 / 128 / 320 / 512, heads 1 / 2 / 5 / 8
           (head dim 64), depths 3 / 6 / 40 / 3, spatial-reduction ratios
           8 / 4 / 2 / 1, MLP ratio 4, qkv bias. Each stage: an overlapping
           patch embedding (conv 7x7 stride 4 pad 3, then 3x3 stride 2 pad
           1; LayerNorm eps 1e-5), its blocks, a LayerNorm (eps 1e-6).
  block    x = x + dp(Attn(LN1(x))); x = x + dp(MixFFN(LN2(x))), LN eps
           1e-6, drop-path rising linearly from 0 to 0.1 over the blocks.
  Attn     Q = W_q x; for R > 1, x_r = LN_sr(Conv_RxR,stride R(x)) (eps
           1e-5), else x_r = x; K, V = W_kv x_r; softmax(Q K^T / sqrt(64)) V,
           then W_proj. `ops.attention` computes it.
  MixFFN   fc1 (C -> 4C), depthwise 3x3 conv with bias, exact GELU, fc2.
  head     each stage's features through a Linear to 768, resized
           bilinearly (align_corners False) to 1/4 of the input, concatenated
           as [c4, c3, c2, c1]; a 1x1 conv 3072 -> 768 without bias, BN (eps
           1e-5), ReLU, Dropout2d 0.1, a 1x1 conv 768 -> classes. The logits
           are resized x4 bilinearly to the input size.

The incremental rule (ERFNet-RAP's per-domain BN, parallel 1x1 adapters and
decoders, carried over; MDIL-SS published ERFNet only): every encoder
LayerNorm is per domain (`norm.{t}`, `norm1.{t}`, ...), every block gains a
per-domain adapter A_t, a Linear C -> C with bias on the FFN's normalised
input, x = x + dp(MixFFN(LN2_t(x)) + A_t(LN2_t(x))), each domain has its own
whole head (`decoder.{t}`, its BN included), and every other Linear and conv
of the encoder is shared. The parameter names are NVlabs' under `encoder.`
(`patch_embed1.proj`, `block3.12.attn.kv`, `norm4`, ...), with the depthwise
conv as `mlp.dwconv` and the head's `linear_c.{i}` (stage i), `linear_fuse`,
`bn` and `output_conv` (mmseg's linear_pred), so the checkpoint surgery and
the LR rule find the per-domain slots and heads as they find ERFNet-RAP's.

The contract is ERFNetRAP's: NHWC images in, NHWC logits at the input size
out (H and W multiples of 32); eval mode (the default) runs under no_grad
with the head's BN on running statistics; training mode runs with autograd,
batch-statistics BN that updates the running statistics
(`ops.norm.batch_norm_train`), and drop-path and the head's Dropout2d from
host keep-masks (`make_dropout_masks`). Inside, activations are token
sequences [B, N, C] and, around the convs, NCHW views of them in channels-
last memory. `remat=True` raises: the model has no remat regions.

Each stage of a forward is a `model.stage` span (attr `stage`) and the head
a `model.head` span (`utils.profiling`).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .. import resolve_device
from ..ops.attention import attention
from ..ops.dropout import dropout2d, masks_to_device
from ..ops.norm import batch_norm_eval, batch_norm_train
from ..utils.profiling import span, spanned
from .erfnet_rap import grad_off

# (kernel, stride, padding) of each stage's overlapping patch embedding
PATCH = ((7, 4, 3), (3, 2, 1), (3, 2, 1), (3, 2, 1))
EMBED_LN_EPS, BLOCK_LN_EPS, SR_LN_EPS, HEAD_BN_EPS = 1e-5, 1e-6, 1e-5, 1e-5
SIZE_MULTIPLE = 32  # the four patch embeddings divide H and W by 4 * 2 * 2 * 2


@dataclass(frozen=True)
class SegFormerSpec:
    """Widths and depths of a SegFormer; the defaults are MiT-B5's with the
    B5 head."""
    embed_dims: tuple = (64, 128, 320, 512)
    num_heads: tuple = (1, 2, 5, 8)
    depths: tuple = (3, 6, 40, 3)
    sr_ratios: tuple = (8, 4, 2, 1)
    mlp_ratio: int = 4
    decoder_dim: int = 768
    drop_path_rate: float = 0.1
    head_dropout: float = 0.1

    def drop_path_rates(self) -> np.ndarray:
        """Each block's drop-path rate, linear from 0 to drop_path_rate."""
        return np.linspace(0.0, self.drop_path_rate, sum(self.depths))


SPECS = {"b5": SegFormerSpec()}


def spec_of(spec) -> SegFormerSpec:
    """A preset's name (`SPECS`) or a SegFormerSpec -> the SegFormerSpec."""
    if isinstance(spec, SegFormerSpec):
        return spec
    if spec not in SPECS:
        raise ValueError(f"unknown SegFormer spec {spec!r}: one of {sorted(SPECS)}")
    return SPECS[spec]


def _per_domain_ln(dim: int, eps: float, nb_tasks: int) -> nn.ModuleList:
    return nn.ModuleList([nn.LayerNorm(dim, eps=eps) for _ in range(nb_tasks)])


def _tokens(x: torch.Tensor) -> torch.Tensor:
    """NCHW (channels-last memory) -> tokens [B, H*W, C], a view."""
    return x.flatten(2).transpose(1, 2)


def _grid(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Tokens [B, H*W, C] -> NCHW [B, C, H, W] in channels-last memory, a view
    where the tokens are contiguous."""
    return x.transpose(1, 2).reshape(x.shape[0], x.shape[2], h, w)


def drop_path(x: torch.Tensor, keep: torch.Tensor | None, rate: float) -> torch.Tensor:
    """A residual branch [B, N, C] with the samples that `keep` [B] drops
    zeroed and the kept divided by 1 - rate (timm's DropPath); the identity
    without a mask or at rate 0."""
    if keep is None or rate == 0.0:
        return x
    return x.div(1.0 - rate) * keep.to(x.dtype).view(-1, 1, 1)


class PatchEmbed(nn.Module):
    def __init__(self, cin: int, dim: int, kernel: int, stride: int, padding: int,
                 nb_tasks: int):
        super().__init__()
        self.proj = nn.Conv2d(cin, dim, kernel, stride, padding)
        self.norm = _per_domain_ln(dim, EMBED_LN_EPS, nb_tasks)

    def forward(self, x: torch.Tensor, task: int):
        x = self.proj(x)
        h, w = x.shape[2:]
        return self.norm[task](_tokens(x)), h, w


class EfficientAttention(nn.Module):
    def __init__(self, dim: int, heads: int, sr_ratio: int, nb_tasks: int):
        super().__init__()
        self.heads, self.sr_ratio = heads, sr_ratio
        self.scale = (dim // heads) ** -0.5
        self.q = nn.Linear(dim, dim)
        self.kv = nn.Linear(dim, 2 * dim)
        self.proj = nn.Linear(dim, dim)
        if sr_ratio > 1:
            self.sr = nn.Conv2d(dim, dim, sr_ratio, sr_ratio)
            self.norm = _per_domain_ln(dim, SR_LN_EPS, nb_tasks)

    def forward(self, x: torch.Tensor, h: int, w: int, task: int) -> torch.Tensor:
        b, n, c = x.shape
        d = c // self.heads
        q = self.q(x).view(b, n, self.heads, d).transpose(1, 2)
        xr = x
        if self.sr_ratio > 1:
            xr = self.norm[task](_tokens(self.sr(_grid(x, h, w))))
        kv = self.kv(xr).view(b, -1, 2, self.heads, d).permute(2, 0, 3, 1, 4)
        o = attention(q, kv[0], kv[1], self.scale)
        return self.proj(o.transpose(1, 2).reshape(b, n, c))


class MixFFN(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.dwconv = nn.Conv2d(hidden, hidden, 3, 1, 1, groups=hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor, h: int, w: int) -> torch.Tensor:
        x = _tokens(self.dwconv(_grid(self.fc1(x), h, w)))
        return self.fc2(F.gelu(x))


class Block(nn.Module):
    def __init__(self, dim: int, heads: int, sr_ratio: int, mlp_ratio: int, drop_rate: float,
                 nb_tasks: int):
        super().__init__()
        self.drop_rate = float(drop_rate)
        self.norm1 = _per_domain_ln(dim, BLOCK_LN_EPS, nb_tasks)
        self.attn = EfficientAttention(dim, heads, sr_ratio, nb_tasks)
        self.norm2 = _per_domain_ln(dim, BLOCK_LN_EPS, nb_tasks)
        self.mlp = MixFFN(dim, mlp_ratio * dim)
        self.adapter = nn.ModuleList([nn.Linear(dim, dim) for _ in range(nb_tasks)])

    def forward(self, x: torch.Tensor, h: int, w: int, task: int,
                keep: torch.Tensor | None) -> torch.Tensor:
        """`keep` [2, B]: the drop-path keep-masks of the two branches, or None."""
        ka, kf = (None, None) if keep is None else keep
        x = x + drop_path(self.attn(self.norm1[task](x), h, w, task), ka, self.drop_rate)
        y = self.norm2[task](x)
        return x + drop_path(self.mlp(y, h, w) + self.adapter[task](y), kf, self.drop_rate)


class MixTransformer(nn.Module):
    """The MiT encoder with per-domain LayerNorms and adapters; forward
    returns the four stages' features, NCHW in channels-last memory."""

    def __init__(self, spec: SegFormerSpec, nb_tasks: int):
        super().__init__()
        rates = spec.drop_path_rates()
        cin, first = 3, 0
        for i, (dim, heads, depth, sr) in enumerate(zip(spec.embed_dims, spec.num_heads,
                                                        spec.depths, spec.sr_ratios)):
            setattr(self, f"patch_embed{i + 1}", PatchEmbed(cin, dim, *PATCH[i], nb_tasks))
            setattr(self, f"block{i + 1}", nn.ModuleList([
                Block(dim, heads, sr, spec.mlp_ratio, rates[first + j], nb_tasks)
                for j in range(depth)]))
            setattr(self, f"norm{i + 1}", _per_domain_ln(dim, BLOCK_LN_EPS, nb_tasks))
            cin, first = dim, first + depth

    def forward(self, x: torch.Tensor, task: int, keep: torch.Tensor | None) -> list:
        """`keep` [blocks, 2, B] drop-path keep-masks, or None."""
        feats, b = [], 0
        for i in range(len(PATCH)):
            with span("model.stage", stage=i):
                x, h, w = getattr(self, f"patch_embed{i + 1}")(x, task)
                for blk in getattr(self, f"block{i + 1}"):
                    x = blk(x, h, w, task, None if keep is None else keep[b])
                    b += 1
                x = _grid(getattr(self, f"norm{i + 1}")[task](x), h, w)
            feats.append(x)
        return feats


class AllMLPHead(nn.Module):
    """SegFormer's all-MLP decoder for one domain."""

    def __init__(self, in_dims: Sequence[int], dim: int, num_classes: int, dropout: float):
        super().__init__()
        self.dropout = dropout
        self.linear_c = nn.ModuleList([nn.Linear(c, dim) for c in in_dims])
        self.linear_fuse = nn.Conv2d(len(in_dims) * dim, dim, 1, bias=False)
        self.bn = nn.BatchNorm2d(dim, eps=HEAD_BN_EPS)
        self.output_conv = nn.Conv2d(dim, num_classes, 1)

    def forward(self, feats: list, keep: torch.Tensor | None = None):
        """Logits [B, classes, H/4, W/4] and the features the classifier reads
        (before dropout). `keep` [B, dim]: Dropout2d's keep-mask, or None."""
        size = feats[0].shape[2:]
        outs = []
        for i in reversed(range(len(feats))):
            c = feats[i]
            t = _grid(self.linear_c[i](_tokens(c)), *c.shape[2:])
            outs.append(t if i == 0 else
                        F.interpolate(t, size=size, mode="bilinear", align_corners=False))
        x = self.linear_fuse(torch.cat(outs, 1))
        x = F.relu(batch_norm_train(x, self.bn) if self.training else batch_norm_eval(x, self.bn))
        return self.output_conv(dropout2d(x, self.dropout, keep)), x


class SegFormerRAP(nn.Module):
    """`SegFormerRAP([20, 20], 2)` builds the two-domain SegFormer-B5 on the
    CUDA card (`device="cpu"` on the CPU; `device="meta"` builds the shapes
    alone; `spec` a preset's name or a `SegFormerSpec`). Weights are drawn
    from the global RNG on the CPU as NVlabs' `_init_weights` draws them
    (Linear: truncated normal, std 0.02, bias 0; conv: normal, std
    sqrt(2 / fan_out), bias 0; LayerNorm 1 and 0), the classifier normal with
    std 0.01 (mmseg's decode head). The model starts in eval mode."""

    def __init__(self, num_classes: Sequence[int], nb_tasks: int, spec="b5", device=None):
        super().__init__()
        if len(num_classes) != nb_tasks:
            raise ValueError(f"{len(num_classes)} class counts for {nb_tasks} tasks")
        meta = device is not None and torch.device(device).type == "meta"
        dev = torch.device("meta") if meta else resolve_device(device)
        self.spec = spec_of(spec)
        with torch.device("meta" if meta else "cpu"):
            self.encoder = MixTransformer(self.spec, nb_tasks)
            self.decoder = nn.ModuleList([
                AllMLPHead(self.spec.embed_dims, self.spec.decoder_dim, nc,
                           self.spec.head_dropout)
                for nc in num_classes])
        if not meta:
            self.apply(_init_weights)
            for head in self.decoder:
                nn.init.normal_(head.output_conv.weight, std=0.01)
        self.to(dev)
        self.eval()

    @property
    def blocks(self) -> int:
        return sum(self.spec.depths)

    @spanned("data.masks")
    def make_dropout_masks(self, np_rng: np.random.Generator, batch: int) -> dict:
        """Bernoulli keep-masks for one training forward: "drop_path" [blocks,
        2, B] (each block's attention and FFN branch, at the block's rate),
        then "head" [B, decoder_dim] (Dropout2d), from `np_rng` in that order."""
        keep = 1.0 - self.spec.drop_path_rates()
        head_keep = 1.0 - self.spec.head_dropout
        return {"drop_path": np_rng.random((self.blocks, 2, batch)) < keep[:, None, None],
                "head": np_rng.random((batch, self.spec.decoder_dim)) < head_keep}

    def forward(self, x_nhwc: torch.Tensor, task: int, drop_masks: dict | None = None,
                return_features: bool = False, remat: bool = False):
        """x [N, H, W, 3] -> logits [N, H, W, num_classes[task]] (H and W
        multiples of 32). `drop_masks` (training mode only):
        `make_dropout_masks` output, or None for no drop-path and dropout.
        `return_features=True` returns (logits, {"encoder": the last stage's
        features [N, H/32, W/32, C4], "penultimate": the features the
        classifier reads [N, H/4, W/4, decoder_dim]}), NHWC."""
        if remat:
            raise ValueError("remat=True: SegFormerRAP has no remat regions")
        if not 0 <= task < len(self.decoder):
            raise IndexError(f"task {task} out of range for {len(self.decoder)} heads")
        h, w = x_nhwc.shape[1:3]
        if h % SIZE_MULTIPLE or w % SIZE_MULTIPLE:
            raise ValueError(f"SegFormerRAP takes heights and widths that are multiples of "
                             f"{SIZE_MULTIPLE}, not {h} x {w}")
        if self.training:
            return self._forward(x_nhwc, task, drop_masks, return_features)
        with grad_off():
            return self._forward(x_nhwc, task, None, return_features)

    def _device_masks(self, drop_masks: dict, batch: int, device):
        dp, head = np.asarray(drop_masks["drop_path"]), np.asarray(drop_masks["head"])
        want = ((self.blocks, 2, batch), (batch, self.spec.decoder_dim))
        if (dp.shape, head.shape) != want:
            raise ValueError(f"keep-masks of shapes {dp.shape}, {head.shape}: this model "
                             f"takes {want} (make_dropout_masks)")
        return masks_to_device([dp, head], device)

    def _forward(self, x_nhwc: torch.Tensor, task: int, drop_masks: dict | None,
                 return_features: bool):
        keep_dp = keep_head = None
        if drop_masks is not None:
            keep_dp, keep_head = self._device_masks(drop_masks, x_nhwc.shape[0], x_nhwc.device)
        feats = self.encoder(x_nhwc.permute(0, 3, 1, 2), task, keep_dp)
        with span("model.head"):
            logits, penultimate = self.decoder[task](feats, keep_head)
            logits = F.interpolate(logits, size=x_nhwc.shape[1:3], mode="bilinear",
                                   align_corners=False).permute(0, 2, 3, 1)
        if not return_features:
            return logits
        return logits, {"encoder": feats[-1].permute(0, 2, 3, 1),
                        "penultimate": penultimate.permute(0, 2, 3, 1)}


def _init_weights(m: nn.Module) -> None:
    """NVlabs mix_transformer.py `_init_weights`."""
    if isinstance(m, nn.Linear):
        nn.init.trunc_normal_(m.weight, std=0.02)
        nn.init.zeros_(m.bias)
    elif isinstance(m, nn.LayerNorm):
        nn.init.ones_(m.weight)
        nn.init.zeros_(m.bias)
    elif isinstance(m, nn.Conv2d):
        fan_out = m.kernel_size[0] * m.kernel_size[1] * m.out_channels // m.groups
        nn.init.normal_(m.weight, std=math.sqrt(2.0 / fan_out))
        if m.bias is not None:
            nn.init.zeros_(m.bias)
