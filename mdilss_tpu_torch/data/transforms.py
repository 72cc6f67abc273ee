"""Preprocessing: host-side decode/resize, device-side augment/normalize/relabel
(port of mdilss_tpu/data/transforms.py).

The reference's MyCoTransform (train_RAPFT_step1.py:53-86) does, per sample:
    Resize (512,1024) bilinear/nearest -> [train only] hflip p=0.5 +
    random translate tx,ty in [-2,2] px -> ToTensor (/255) ->
    Relabel(255 -> NUM_CLASSES-1)

Only decode+resize run on the host (the native decoder, else PIL, bit-equal
with torchvision's PIL-backed Resize); the rest runs batched on the tensors'
device, so batches cross to the card as uint8.

Translation fidelity: the reference translates with ImageOps.expand + crop.
For positive shifts the new border is filled with 0 (image) / 255 (label ->
the ignore class after relabel); for negative shifts PIL's crop pads with 0
for image AND label, so the 255 fill applies on two of the four edges only.
`augment_batch` reproduces this (255 on top/left for labels, 0 on
bottom/right).

The random draws are split from the transform: `draw_augment` draws flip, tx
and ty from an explicit CPU `torch.Generator`, and `augment_batch` takes them
as tensors. The JAX package draws them inside its jitted augment with
`jax.random`, which torch cannot reproduce; with the draws as inputs both
packages can be fed the same ones.
"""
from __future__ import annotations

import numpy as np
import torch

from ..utils.profiling import spanned

MAX_TRANSLATE = 2  # pixels, each axis (train_RAPFT_step1.py:66-68)


# ---------------------------------------------------------------------------
# Host side
# ---------------------------------------------------------------------------

def decode_pair(img_path: str, label_path: str, *, height: int, width: int,
                label_map: np.ndarray | None = None) -> tuple[np.ndarray, np.ndarray]:
    """Decode + resize one (image, label) pair -> (u8 [H,W,3], u8 [H,W]).

    Uses the port's native decoder (mdilss_tpu_torch/native) when it is
    available and falls back to PIL per file for anything it does not
    handle. PIL is imported only for that fallback. The label LUT commutes
    with nearest resize, so it applies after.
    """
    from ..native import get_decoder

    dec = get_decoder()
    img = lbl = None
    if dec is not None:
        with open(img_path, "rb") as f:
            raw = f.read()
        try:
            img = np.frombuffer(dec.decode_image(raw, height, width), np.uint8).reshape(
                height, width, 3)
        except ValueError:
            img = None
        with open(label_path, "rb") as f:
            raw = f.read()
        try:
            lbl = np.frombuffer(dec.decode_label(raw, height, width), np.uint8)
            lbl = (label_map[lbl] if label_map is not None else lbl).reshape(height, width)
        except ValueError:
            lbl = None
    if img is None or lbl is None:
        try:
            from PIL import Image
        except ImportError:
            raise RuntimeError(
                f"cannot decode {img_path if img is None else label_path}: the native "
                "decoder (mdilss_tpu_torch/native, g++ with libpng/libjpeg) is "
                "unavailable or rejected the file, and PIL is not installed"
            ) from None
    if img is None:
        with open(img_path, "rb") as f:
            pil = Image.open(f).convert("RGB").resize((width, height), Image.BILINEAR)
        img = np.asarray(pil, np.uint8)
    if lbl is None:
        with open(label_path, "rb") as f:
            pil = Image.open(f).convert("P")
            if label_map is not None:
                pil = Image.fromarray(label_map[np.array(pil)])
            pil = pil.resize((width, height), Image.NEAREST)
        lbl = np.asarray(pil, np.uint8)
    return img, lbl


def draw_augment(gen: torch.Generator, n: int):
    """The random draws of one training batch of `n` images from the CPU
    generator `gen`: (flip bool [n] with p=0.5, tx int64 [n], ty int64 [n]
    uniform in [-MAX_TRANSLATE, MAX_TRANSLATE]), on the CPU."""
    flip = torch.rand(n, generator=gen) < 0.5
    tx = torch.randint(-MAX_TRANSLATE, MAX_TRANSLATE + 1, (n,), generator=gen)
    ty = torch.randint(-MAX_TRANSLATE, MAX_TRANSLATE + 1, (n,), generator=gen)
    return flip, tx, ty


# ---------------------------------------------------------------------------
# Device side
# ---------------------------------------------------------------------------

@spanned("data.augment")
def augment_batch(images_u8: torch.Tensor, labels_u8: torch.Tensor, flip, tx, ty, *,
                  num_classes: int, out_dtype: torch.dtype = torch.float32):
    """Train-time augment on the tensors' device: hflip where `flip`, a
    (tx, ty) translate (content moves right/down for positive shifts), /255,
    relabel 255 -> num_classes - 1.

    images_u8 [N,H,W,3] uint8, labels_u8 [N,H,W] uint8; flip, tx, ty [N]
    (`draw_augment`'s draws; any device). Returns (images in [0, 1] of type
    `out_dtype`, labels int32): a bf16 trainer passes torch.bfloat16, and the
    /255 still runs in float32 and then rounds, so the values are those of a
    later cast (mdilss_tpu/data/transforms.py:113, :143-144). A pixel shifted
    in from the top/left takes 0 in the image and 255 (then the ignore class)
    in the label; one from the bottom/right takes 0 in both, as PIL's expand
    + crop gives."""
    n, h, w = labels_u8.shape
    dev = images_u8.device
    # the three draws in one small host -> device copy
    draws = torch.stack([torch.as_tensor(t).to(torch.int64) for t in (flip, tx, ty)])
    flip, tx, ty = draws.to(dev, non_blocking=True).unbind()
    flip = flip.bool()
    rows = torch.arange(h, device=dev)
    cols = torch.arange(w, device=dev)
    # output (r, c) reads the flipped image at ((r - ty) mod H, (c - tx) mod W)
    src_r = (rows[None, :] - ty[:, None]).remainder(h)  # [N, H]
    src_c = (cols[None, :] - tx[:, None]).remainder(w)  # [N, W]
    src_c = torch.where(flip[:, None], w - 1 - src_c, src_c)
    b = torch.arange(n, device=dev)[:, None, None]
    imgs = images_u8[b, src_r[:, :, None], src_c[:, None, :]]
    lbls = labels_u8[b, src_r[:, :, None], src_c[:, None, :]]
    border_pos = ((rows[None, :] < ty[:, None])[:, :, None]
                  | (cols[None, :] < tx[:, None])[:, None, :])  # new top/left area
    border_neg = ((rows[None, :] >= h + ty[:, None])[:, :, None]
                  | (cols[None, :] >= w + tx[:, None])[:, None, :])  # new bottom/right
    zero = torch.zeros((), dtype=torch.uint8, device=dev)
    imgs = torch.where((border_pos | border_neg)[..., None], zero, imgs)
    lbls = torch.where(border_pos, torch.full_like(zero, 255), lbls)
    lbls = torch.where(border_neg, zero, lbls)
    return _finalize(imgs, lbls, num_classes, out_dtype)


@spanned("data.prepare")
def prepare_batch(images_u8, labels_u8, *, num_classes: int):
    """uint8 images [N,H,W,3] -> float32 in [0, 1]; uint8 labels [N,H,W] ->
    int32 with the void label 255 relabelled to `num_classes - 1`
    (MyCoTransform(augment=False)). Tensors stay on their device."""
    return _finalize(torch.as_tensor(images_u8), torch.as_tensor(labels_u8), num_classes)


# XLA compiles the JAX package's `x / 255.0` into a multiply by the float32
# reciprocal, which is 1 ulp off a true division on some values; the port
# multiplies the same way, so its inputs equal the JAX package's bit for bit
_INV_255 = float(np.float32(1.0) / np.float32(255.0))


def _finalize(imgs_u8: torch.Tensor, lbls_u8: torch.Tensor, num_classes: int,
              out_dtype: torch.dtype = torch.float32):
    images = (imgs_u8.to(torch.float32) * _INV_255).to(out_dtype)
    labels = lbls_u8.to(torch.int32)
    labels = torch.where(labels == 255, num_classes - 1, labels)
    return images, labels
