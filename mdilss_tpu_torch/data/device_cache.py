"""Device-resident dataset cache: upload once, gather each batch on the card
(port of mdilss_tpu/data/device_cache.py, single device).

The reference re-reads and re-decodes every image every epoch. Here each
(image, label) pair is decoded once through the loader, assembled in one
(pinned) host buffer and uploaded as uint8 tensors in one copy, and every
later batch is an `index_select` on the card: per-step host -> device
traffic drops from ~12.6 MB (6x512x1024 uint8) to the batch indices.

Epoch semantics are those of the streaming Loader by construction: all
batch through `loader.batch_indices` (same permutation, drop-last and
padding rule), so a cached run reproduces the streamed run's batches
exactly. The JAX package's mesh arm (`DeviceCache(mesh=...)`, the dataset
sharded over the data axis) is not ported.
"""
from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from .. import resolve_device
from .loader import Loader, batch_indices, produced


def cache_bytes(n: int, height: int, width: int) -> int:
    """uint8 images [N,H,W,3] + labels [N,H,W]."""
    return n * height * width * 4


def should_cache(source, *, height: int, width: int, budget_bytes: int) -> bool:
    """Cache when the uint8 dataset fits in `budget_bytes` (synthetic sources
    too, so a budget of 0 disables caching everywhere)."""
    return cache_bytes(len(source), height, width) <= budget_bytes


def plan_cache(source, *, height: int, width: int, budget_bytes: int, batch_size: int = 1):
    """("full", n) when the whole uint8 dataset fits in `budget_bytes`;
    ("hybrid", k) caching the k = budget // row_bytes rows that fit;
    otherwise ("stream", 0). Hybrid needs at least one batch's worth of
    cached rows to be worth the per-batch scatter."""
    n = len(source)
    row = height * width * 4
    if n * row <= budget_bytes:
        return "full", n
    k = int(budget_bytes // row)
    if k >= max(batch_size, 1):
        return "hybrid", min(k, n)
    return "stream", 0


def _cache_drop_last(loader: Loader, shuffle: bool) -> bool:
    """drop_last for a cache epoch: an explicit Loader override wins (the
    cache must reproduce the wrapped loader's batching rule); otherwise it
    follows the per-call shuffle flag as the Loader's default does."""
    return loader.drop_last if loader._drop_last_explicit else shuffle


def _upload(loader: Loader, rows, dev: torch.device):
    """Decode `rows` of the loader's source into one host buffer (pinned for
    the card) and copy it to `dev` in one transfer each for images and labels."""
    n, h, w = len(rows), loader.height, loader.width
    pin = dev.type == "cuda"
    images = torch.empty((n, h, w, 3), dtype=torch.uint8, pin_memory=pin)
    labels = torch.empty((n, h, w), dtype=torch.uint8, pin_memory=pin)
    im, lb = images.numpy(), labels.numpy()
    with ThreadPoolExecutor(loader.num_threads) as pool:
        for i, (img, lbl) in enumerate(pool.map(loader._decode, rows)):
            im[i] = img
            lb[i] = lbl
    return images.to(dev), labels.to(dev)


def _index(idx: np.ndarray, dev: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.asarray(idx, np.int64)).to(dev, non_blocking=True)


class DeviceCache:
    """The whole dataset as uint8 tensors on `device` (None -> the CUDA card)
    + deterministic epoch batching."""

    def __init__(self, loader: Loader, device=None):
        self.device = resolve_device(device)
        self.loader = loader
        self.batch_size = loader.batch_size
        self.n = len(loader.source)
        self.images, self.labels = _upload(loader, range(self.n), self.device)

    def epoch_batches(self, epoch: int, *, shuffle: bool = True):
        """Yields (images, labels, valid) batches on the device; the order and
        drop-last/padding of the streaming Loader at the same (seed, epoch)."""
        for idx, valid in batch_indices(
            self.n, self.batch_size, seed=self.loader.seed, epoch=epoch,
            shuffle=shuffle, drop_last=_cache_drop_last(self.loader, shuffle),
        ):
            imgs, lbls = self.take(idx)
            yield imgs, lbls, valid

    def take(self, idx: np.ndarray):
        """Gather one batch of rows `idx` on the device."""
        di = _index(idx, self.device)
        return self.images.index_select(0, di), self.labels.index_select(0, di)


class HybridCache:
    """Partial device cache for datasets over the device budget.

    Rows [0, max_rows) live on the device as uint8 (decoded once, like
    DeviceCache); rows >= max_rows decode on the host each epoch in a
    producer thread, and the batch is combined on the device: one gather of
    the cached rows (uncached positions read a clipped dummy row) and one
    scatter of the uncached ones over them. Batches equal the streaming
    Loader's and a full DeviceCache's at the same (seed, epoch): all three
    batch through `loader.batch_indices`, so switching cache modes never
    changes the training trajectory. Single device.
    """

    def __init__(self, loader: Loader, max_rows: int, device=None):
        if not 0 < max_rows < len(loader.source):
            raise ValueError(f"max_rows {max_rows} must lie in (0, {len(loader.source)})")
        self.device = resolve_device(device)
        self.loader = loader
        self.batch_size = loader.batch_size
        self.n = len(loader.source)
        self.k = int(max_rows)
        self.images, self.labels = _upload(loader, range(self.k), self.device)

    def epoch_batches(self, epoch: int, *, shuffle: bool = True):
        """Yields (images, labels, valid) batches on the device, in the
        streaming Loader's order at the same (seed, epoch). The uncached rows
        decode in a producer thread (bounded queue), ahead of the batches
        the device is computing."""
        plan = list(batch_indices(
            self.n, self.batch_size, seed=self.loader.seed, epoch=epoch,
            shuffle=shuffle, drop_last=_cache_drop_last(self.loader, shuffle),
        ))
        pin = self.device.type == "cuda"

        def produce(put, stop):
            with ThreadPoolExecutor(self.loader.num_threads) as pool:
                for idx, valid in plan:
                    if stop.is_set():
                        return
                    pos = np.nonzero(idx >= self.k)[0]
                    up = None
                    if len(pos):
                        pairs = list(pool.map(self.loader._decode, idx[pos]))
                        up = [torch.from_numpy(np.stack([p[i] for p in pairs])) for i in (0, 1)]
                        if pin:
                            up = [t.pin_memory() for t in up]
                    put((idx, valid, pos, up))

        for idx, valid, pos, up in produced(produce, 3):
            yield (*self._combine(idx, pos, up), valid)

    def _combine(self, idx: np.ndarray, pos: np.ndarray, up):
        di = _index(np.minimum(idx, self.k - 1), self.device)
        imgs = self.images.index_select(0, di)
        lbls = self.labels.index_select(0, di)
        if len(pos):
            # copies on the current stream from pinned memory: ordered before
            # the scatter that reads them
            p = _index(pos, self.device)
            imgs.index_copy_(0, p, up[0].to(self.device, non_blocking=True))
            lbls.index_copy_(0, p, up[1].to(self.device, non_blocking=True))
        return imgs, lbls
