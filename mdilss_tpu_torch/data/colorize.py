"""Label colorization: the reference's hand-coded Cityscapes+IDD palette and
`Colorize` visualization (transform.py:7-44,82-105), vectorized (the port's
own copy of mdilss_tpu/data/colorize.py, numpy only).

The reference loops over labels and paints a CHW ByteTensor per class
(transform.py:90-105); here colorization is a single LUT gather over the
whole (batched) label map — O(pixels), layout HWC (or NHWC), numpy in/out so
it composes with the host-side loader and PIL saving.
"""
from __future__ import annotations

import numpy as np

# Cityscapes 19-class palette + the paper's IDD extension classes
# (transform.py:7-44; rows 19-27 are the IDD level3 extras, 28 is white).
_PALETTE_29 = np.array(
    [
        [128, 64, 128],   # 0  road
        [244, 35, 232],   # 1  sidewalk
        [70, 70, 70],     # 2  building
        [102, 102, 156],  # 3  wall
        [190, 153, 153],  # 4  fence
        [153, 153, 153],  # 5  pole
        [250, 170, 30],   # 6  traffic light
        [220, 220, 0],    # 7  traffic sign
        [107, 142, 35],   # 8  vegetation
        [152, 251, 152],  # 9  terrain
        [70, 130, 180],   # 10 sky
        [220, 20, 60],    # 11 person
        [255, 0, 0],      # 12 rider
        [0, 0, 142],      # 13 car
        [0, 0, 70],       # 14 truck
        [0, 60, 100],     # 15 bus
        [0, 80, 100],     # 16 train
        [0, 0, 230],      # 17 motorcycle
        [119, 11, 32],    # 18 bicycle
        [229, 23, 142],   # 19 drivable-fallback
        [156, 60, 200],   # 20 non-drivable-fallback
        [99, 250, 80],    # 21 autorickshaw
        [82, 92, 214],    # 22 vehicle-fallback
        [196, 209, 152],  # 23 curb
        [180, 165, 180],  # 24 guard-rail
        [37, 58, 77],     # 25 billboard
        [11, 35, 88],     # 26 obs-str-bar-fallback
        [150, 100, 100],  # 27 bridge
        [255, 255, 255],  # 28
    ],
    dtype=np.uint8,
)


def colormap_cityscapes(n: int) -> np.ndarray:
    """[n, 3] uint8: the hand-coded palette above, zero-padded past entry 28
    (transform.py:7-44)."""
    cmap = np.zeros((n, 3), np.uint8)
    k = min(n, len(_PALETTE_29))
    cmap[:k] = _PALETTE_29[:k]
    return cmap


def colormap(n: int) -> np.ndarray:
    """[n, 3] uint8 generic bit-interleaved palette (transform.py:47-60):
    channel bit b of entry i is bit 3*b(+ch) of i, MSB-first."""
    i = np.arange(n, dtype=np.int64)[:, None]
    j = np.arange(8)[None, :]
    r = (((i >> (3 * j)) & 1) << (7 - j)).sum(1)
    g = (((i >> (3 * j + 1)) & 1) << (7 - j)).sum(1)
    b = (((i >> (3 * j + 2)) & 1) << (7 - j)).sum(1)
    return np.stack([r, g, b], axis=1).astype(np.uint8)


def colorize(labels: np.ndarray, n: int = 22) -> np.ndarray:
    """Label map(s) -> RGB uint8, channel-last.

    [H, W] -> [H, W, 3] (or any leading batch dims). Labels 0..n-1 take the
    Cityscapes+IDD palette entry; labels >= n (incl. a 255 ignore) map to
    black — matching `Colorize(n)` (transform.py:82-105), whose per-class
    paint loop only covers cmap[:n] and leaves other pixels zero-filled.
    """
    labels = np.asarray(labels)
    lut = np.zeros((256, 3), np.uint8)
    lut[:n] = colormap_cityscapes(256)[:n]
    return lut[labels.astype(np.uint8)]
