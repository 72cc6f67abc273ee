"""Host input pipeline: multithreaded decode + prefetch, static-shape batches
(port of mdilss_tpu/data/loader.py).

A thread pool decodes (the native decoder and PIL release the GIL while they
decode and resize) into numpy uint8 batches, and a bounded queue overlaps
host decode with device compute. Normalize, augment and relabel run on the
device (transforms.py), so batches cross to the card as uint8, from pinned
memory (`device_prefetch`).

Training drops the last partial batch (`drop_last`, the default with
shuffling; the reference kept it, a <=0.2% difference in seen samples per
epoch). Evaluation keeps it, padded, with a validity mask.
"""
from __future__ import annotations

import collections
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator

import numpy as np
import torch

from .. import resolve_device
from .sources import Source
from .transforms import decode_pair


class SyntheticSource:
    """Deterministic random data with the same interface as an indexed Source;
    used by tests and smoke runs (no dataset download)."""

    def __init__(self, num_classes: int, n: int = 64, height: int = 512, width: int = 1024,
                 seed: int = 0):
        self.name = f"synthetic{num_classes}"
        self.num_classes = num_classes
        self._n = n
        self._h, self._w = height, width
        self._seed = seed

    def __len__(self):
        return self._n

    def decode(self, idx: int, height: int, width: int):
        rng = np.random.default_rng(self._seed * 100003 + idx)
        img = rng.integers(0, 256, size=(height, width, 3), dtype=np.uint8)
        lbl = rng.integers(0, self.num_classes, size=(height, width)).astype(np.uint8)
        # sprinkle ignore pixels like real data
        lbl[rng.random((height, width)) < 0.05] = 255
        return img, lbl


class LearnableSource(SyntheticSource):
    """Synthetic data whose labels are a deterministic function of the pixels
    (a learnable mapping), for metric-level convergence checks.

    Images are spatially coherent colour patches (a low-res random grid,
    nearest-upsampled); a pixel's label is its red value quantized into
    num_classes-1 bins (the last class stays the ignore class), plus a 5%
    sprinkle of ignore pixels.
    """

    def decode(self, idx: int, height: int, width: int):
        rng = np.random.default_rng(self._seed * 100003 + idx)
        gh, gw = max(height // 8, 1), max(width // 8, 1)
        grid = rng.integers(0, 256, size=(gh, gw, 3), dtype=np.uint8)
        img = np.repeat(np.repeat(grid, height // gh, 0), width // gw, 1)
        img = img[:height, :width]
        n_real = self.num_classes - 1
        lbl = (img[:, :, 0].astype(np.int32) * n_real // 256).astype(np.uint8)
        lbl[rng.random((height, width)) < 0.05] = 255
        return img, lbl


def device_prefetch(iterator, *, depth: int = 2, device=None):
    """Overlap host -> device copies with device compute.

    Wraps an iterator of tuples of numpy arrays (a Loader's (images, labels,
    valid) batches) and yields them as tensors on `device` (None -> the CUDA
    card; "cpu" -> CPU tensors that share the arrays' memory), issuing the
    copies of up to `depth` batches ahead of the one it yields.

    On the card each array goes to pinned memory and is copied with
    `non_blocking=True` on a side stream; before a batch is yielded the
    current stream waits for its copies (an event recorded after them), and
    each tensor is marked as used by the current stream (`record_stream`),
    so its memory is not handed to a later copy while the consumer's kernels
    may still read it.
    """
    dev = resolve_device(device)
    if dev.type == "cpu":
        for item in iterator:
            yield tuple(torch.from_numpy(x) if isinstance(x, np.ndarray) else x for x in item)
        return
    stream = torch.cuda.Stream(dev)

    def put(item):
        with torch.cuda.stream(stream):
            out = tuple(
                torch.from_numpy(x).pin_memory().to(dev, non_blocking=True)
                if isinstance(x, np.ndarray) else x for x in item
            )
            done = stream.record_event()
        return out, done

    q = collections.deque()
    it = iter(iterator)
    for item in it:
        q.append(put(item))
        if len(q) == depth:
            break
    while q:
        out, done = q.popleft()
        nxt = next(it, None)
        if nxt is not None:
            q.append(put(nxt))
        current = torch.cuda.current_stream(dev)
        current.wait_event(done)
        for t in out:
            if isinstance(t, torch.Tensor):
                t.record_stream(current)
        yield out


def batch_indices(n: int, batch_size: int, *, seed: int, epoch: int,
                  shuffle: bool, drop_last: bool):
    """THE batching rule (one place): per-epoch `default_rng(seed + epoch)`
    permutation, drop-last for training, zero-index padding + valid mask for
    the final eval batch. Shared by the streaming Loader and the device
    caches, so cached runs reproduce streamed batch sequences exactly.

    Yields (idx [batch_size] int64, valid [batch_size] bool).
    """
    order = np.arange(n)
    if shuffle:
        np.random.default_rng(seed + epoch).shuffle(order)
    nb = n // batch_size if drop_last else -(-n // batch_size)
    for b in range(nb):
        idx = order[b * batch_size : (b + 1) * batch_size]
        valid = np.ones(batch_size, bool)
        if len(idx) < batch_size:
            valid[len(idx):] = False
            idx = np.concatenate([idx, np.zeros(batch_size - len(idx), np.int64)])
        yield idx, valid


class Loader:
    """Iterable over uint8 (images [N,H,W,3], labels [N,H,W], valid [N])
    numpy batches.

    Deterministic per-epoch shuffling: epoch e uses rng(seed + e), so resume
    reproduces the batch order of the uninterrupted run.
    """

    def __init__(self, source: Source | SyntheticSource, *, batch_size: int, height: int = 512,
                 width: int = 1024, shuffle: bool = False, drop_last: bool | None = None,
                 num_threads: int = 8, prefetch: int = 4, seed: int = 0):
        self.source = source
        self.batch_size = batch_size
        self.height = height
        self.width = width
        self.shuffle = shuffle
        self.drop_last = shuffle if drop_last is None else drop_last
        # device caches re-derive drop_last from their per-call shuffle flag
        # unless the caller pinned it here (cached-vs-streamed batch parity
        # must hold for that configuration too)
        self._drop_last_explicit = drop_last is not None
        # 0 is valid reference usage (torch DataLoader num_workers=0 =
        # in-process decode); here it still means one pool thread
        self.num_threads = max(1, num_threads)
        self.prefetch = prefetch
        self.seed = seed
        self.epoch = 0

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __len__(self):
        n = len(self.source)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _decode(self, idx: int):
        if isinstance(self.source, SyntheticSource):
            return self.source.decode(idx, self.height, self.width)
        img_path, lbl_path = self.source.pairs[idx]
        return decode_pair(img_path, lbl_path, height=self.height, width=self.width,
                           label_map=getattr(self.source, "label_map", None))

    def __iter__(self) -> Iterator[tuple[np.ndarray, np.ndarray, np.ndarray]]:
        """Yields (images, labels, valid_mask). valid_mask is all-ones except
        for a padded final batch (drop_last=False)."""
        plan = list(batch_indices(
            len(self.source), self.batch_size, seed=self.seed, epoch=self.epoch,
            shuffle=self.shuffle, drop_last=self.drop_last,
        ))

        def produce(put, stop):
            with ThreadPoolExecutor(self.num_threads) as pool:
                for idxs, valid in plan:
                    if stop.is_set():
                        return
                    pairs = list(pool.map(self._decode, idxs))
                    put((np.stack([p[0] for p in pairs]), np.stack([p[1] for p in pairs]),
                         valid))

        yield from produced(produce, self.prefetch)


def produced(produce, maxsize: int):
    """Run `produce(put, stop)` in a daemon thread and yield what it puts,
    through a queue of `maxsize` items. An exception in the producer is
    raised in the consumer (it would otherwise wait forever); a consumer that
    abandons the generator sets `stop`, and a producer blocked on the full
    queue notices it within 0.2 s and ends."""
    q: queue.Queue = queue.Queue(maxsize=maxsize)
    stop = threading.Event()
    done = object()

    def put(item):
        while not stop.is_set():
            try:
                q.put(item, timeout=0.2)
                return
            except queue.Full:
                continue

    def run():
        try:
            produce(put, stop)
            put((done, None))
        except BaseException as e:  # noqa: BLE001 - handed to the consumer, which raises it
            put((done, e))

    threading.Thread(target=run, daemon=True).start()
    try:
        while True:
            item = q.get()
            if isinstance(item, tuple) and len(item) == 2 and item[0] is done:
                if item[1] is not None:
                    raise item[1]
                return
            yield item
    finally:
        stop.set()
