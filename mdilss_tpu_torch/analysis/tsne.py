"""Latent-space t-SNE: Plot_Tsne_Notebook.ipynb as a library workflow (port
of mdilss_tpu/analysis/tsne.py).

The notebook (cells 13-30) picks one label-diverse val image, extracts
encoder (or decoder-penultimate) features from a checkpoint before and after
an incremental step, t-SNE-embeds 20k sampled pixels (perplexity 100,
n_iter 2000, random_state 2; cell 26), and scatter-plots them coloured by
the Cityscapes palette (cell 18). Feature extraction runs on the device
through the models' `return_features=True` (in eval mode the encoder features
are the nb1d kernel's output); the embedding and the plot run on the host,
with sklearn and matplotlib imported when they run.
"""
from __future__ import annotations

import os
from typing import Callable, Sequence

import numpy as np
import torch

from .. import resolve_device
from ..data.colorize import colormap_cityscapes
from ..data.loader import Loader
from ..data.transforms import prepare_batch
from ..ops.precision import no_tf32
from .names import CITY_NAMES


def default_select(labels: np.ndarray, num_classes: int) -> bool:
    """The notebook's image pick: a val image whose label map contains
    exactly 17 distinct ids (eval_visualize, cell 13), i.e. diverse enough
    to produce a readable embedding."""
    return len(np.unique(labels)) == 17


@no_tf32()
def extract_features(
    model,
    source,
    *,
    task: int,
    num_classes: int,
    which: str = "encoder",
    height: int = 512,
    width: int = 1024,
    select: Callable[[np.ndarray, int], bool] | None = None,
    device=None,
) -> tuple[np.ndarray, np.ndarray, str]:
    """Scan `source` (batch 1, the notebook's protocol) for the first image
    passing `select`; returns (features [H',W',C], relabeled labels [H,W],
    filename). `model` is moved to `device` (None -> the CUDA card).

    `which`: "encoder" (128 channels at H/8, cells 26-27), "penultimate"
    (16 channels at H/2) or "logits" (cell 16's softmax-space variant).
    """
    select = select or default_select
    dev = resolve_device(device)
    model = model.to(dev).eval()
    loader = Loader(source, batch_size=1, height=height, width=width)
    pairs = getattr(source, "pairs", None)
    for i, (imgs, lbls, valid) in enumerate(loader):
        if not valid[0]:
            break
        x, y = prepare_batch(torch.from_numpy(imgs), torch.from_numpy(lbls),
                             num_classes=num_classes)
        y_np = y[0].numpy()
        if not select(y_np, num_classes):
            continue
        logits, feats = model(x.to(dev), task, return_features=True)
        chosen = logits[0] if which == "logits" else feats[which][0]
        fname = pairs[i][0] if pairs is not None else f"index{i}"
        return chosen.cpu().numpy(), y_np, fname
    raise ValueError("no image in the source passed the selection criterion")


def sample_pixels(
    features: np.ndarray,
    labels: np.ndarray,
    *,
    n: int = 20000,
    seed: int = 0,
) -> tuple[np.ndarray, np.ndarray]:
    """Flatten per-pixel features + nearest-downsampled labels, then sample
    `n` pixels without replacement (preprocess_fn_enco, cell 19: targets are
    Resize(NEAREST)-matched to the feature resolution, 20000 samples)."""
    fh, fw, c = features.shape
    lh, lw = labels.shape
    if (lh, lw) != (fh, fw):
        # nearest downsample: PIL Resize NEAREST == pick at scaled coords
        rows = (np.arange(fh) + 0.5) * lh / fh
        cols = (np.arange(fw) + 0.5) * lw / fw
        labels = labels[rows.astype(np.int64)[:, None], cols.astype(np.int64)[None, :]]
    flat_f = features.reshape(-1, c)
    flat_y = labels.reshape(-1)
    rng = np.random.default_rng(seed)
    idx = rng.choice(len(flat_y), size=min(n, len(flat_y)), replace=False)
    return flat_f[idx], flat_y[idx]


def tsne_embed(
    samples: np.ndarray,
    *,
    perplexity: float = 100.0,
    n_iter: int = 2000,
    random_state: int = 2,
) -> np.ndarray:
    """2-D t-SNE with the notebook's hyperparameters (cell 26)."""
    from sklearn.manifold import TSNE

    # sklearn requires perplexity < n_samples; clamp for small sample sets
    perplexity = min(perplexity, max(1.0, (len(samples) - 1) / 3))
    kw = dict(n_components=2, perplexity=perplexity, random_state=random_state)
    try:
        model = TSNE(max_iter=n_iter, **kw)  # sklearn >= 1.5
    except TypeError:
        model = TSNE(n_iter=n_iter, **kw)
    return model.fit_transform(np.asarray(samples, np.float64))


def plot_tsne(
    embedding: np.ndarray,
    labels: np.ndarray,
    path: str,
    *,
    class_names: Sequence[str] = CITY_NAMES,
    sample_labels: Sequence[int] | None = None,
    exclude: Sequence[int] | None = None,
) -> str:
    """Square-marker scatter per class, Cityscapes palette, legend of class
    names (plot_tsne, cell 18). Returns the saved path.

    `sample_labels` defaults to every class present in `labels` (the
    notebook's own cell 17 restricted itself to classes 0-9; pass range(10)
    to reproduce that figure exactly); `exclude` defaults to none."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    if sample_labels is None:
        sample_labels = sorted(int(v) for v in np.unique(labels))
    exclude = () if exclude is None else exclude
    cmap = colormap_cityscapes(256).astype(np.float64) / 256.0
    fig, ax = plt.subplots(figsize=(16, 16))
    for label in sample_labels:
        if label in exclude:
            continue
        sel = labels == label
        if not sel.any():
            continue
        ax.scatter(
            embedding[sel, 0], embedding[sel, 1],
            c=cmap[label].reshape(1, 3),
            label=class_names[label] if label < len(class_names) else str(label),
            marker="s",
        )
    ax.legend(fontsize=25, markerscale=5, loc="best")
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fig.savefig(path)
    plt.close(fig)
    return path


def run_tsne(
    model,
    source,
    *,
    task: int,
    num_classes: int,
    out_path: str,
    which: str = "encoder",
    n_samples: int = 20000,
    class_names: Sequence[str] = CITY_NAMES,
    select: Callable[[np.ndarray, int], bool] | None = None,
    seed: int = 0,
    height: int = 512,
    width: int = 1024,
    device=None,
) -> dict:
    """End to end: select an image -> features (on `device`) -> sample ->
    embed -> plot."""
    feats, labels, fname = extract_features(
        model, source, task=task, num_classes=num_classes, which=which, select=select,
        height=height, width=width, device=device,
    )
    samples, y = sample_pixels(feats, labels, n=n_samples, seed=seed)
    emb = tsne_embed(samples)
    # every class present in the sample is plotted; the remapped ignore
    # index (num_classes - 1) is dropped like the notebook's `label != 19`
    plot_tsne(emb, y, out_path, class_names=class_names, exclude=(num_classes - 1,))
    return {"image": fname, "embedding": emb, "labels": y, "plot": out_path}
