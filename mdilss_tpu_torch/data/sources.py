"""Dataset sources: file indexing for CS / BDD100k / IDD (/ VOC12).

The port's own copy of mdilss_tpu/data/sources.py (pure Python and numpy).

Replicates the reference's directory and label-file conventions exactly
(dataset.py:19-28,75-256):

  * cityscapes: `<root>/leftImg8bit/<subset>` + `<root>/gtFine/<subset>`,
    recursive walk, labels end `_labelTrainIds.png`, both lists sorted.
  * IDD:        same layout, labels end `_labellevel3Ids.png`.
  * IDD_union:  IDD remapped into the 28-class union space via MAP_dict
    (dataset.py:173-207).
  * BDD100k:    `<root>/images/<subset>` + `<root>/labels/<subset>`, flat
    listdir, labels end `_train_id.png`.
  * VOC12:      `<root>/images/*.jpg` + `<root>/labels/*.png` keyed by the
    label basenames (dataset.py:43-72).

Images decode to RGB uint8, labels to single-channel uint8 ('P' mode), resized
on the host (transforms.decode_pair: the native decoder, else PIL; bilinear /
nearest) to match the reference's torchvision Resize bit for bit. Everything
after decode+resize runs on the device (transforms.prepare_batch /
augment_batch).
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Callable

import numpy as np

IMAGE_EXTENSIONS = (".jpg", ".png")

DATASET_NUM_CLASSES = {
    "cityscapes": 20, "BDD": 20, "IDD": 27, "IDD_union": 28, "VOC12": 21,
}

# IDD level3 -> 28-class union space (dataset.py:173-174)
IDD_UNION_MAP = {
    0: 0, 1: 19, 2: 1, 3: 20, 4: 11, 5: 12, 6: 17, 7: 18, 8: 21, 9: 13, 10: 14,
    11: 15, 12: 22, 13: 23, 14: 3, 15: 4, 16: 24, 17: 25, 18: 7, 19: 6, 20: 5,
    21: 26, 22: 2, 23: 27, 24: 8, 25: 10, 255: 255,
}


def _is_image(f: str) -> bool:
    return f.endswith(IMAGE_EXTENSIONS)


def _walk_sorted(root: str, pred: Callable[[str], bool]) -> list[str]:
    out = [
        os.path.join(dp, f)
        for dp, _, fn in os.walk(os.path.expanduser(root))
        for f in fn
        if pred(f)
    ]
    out.sort()
    return out


def cityscapes_index(root: str, subset: str = "train") -> list[tuple[str, str]]:
    imgs = _walk_sorted(os.path.join(root, "leftImg8bit", subset), _is_image)
    labels = _walk_sorted(
        os.path.join(root, "gtFine", subset), lambda f: f.endswith("_labelTrainIds.png")
    )
    assert len(imgs) == len(labels), (len(imgs), len(labels))
    return list(zip(imgs, labels))


def idd_index(root: str, subset: str = "train") -> list[tuple[str, str]]:
    imgs = _walk_sorted(os.path.join(root, "leftImg8bit", subset), _is_image)
    labels = _walk_sorted(
        os.path.join(root, "gtFine", subset), lambda f: f.endswith("_labellevel3Ids.png")
    )
    assert len(imgs) == len(labels), (len(imgs), len(labels))
    return list(zip(imgs, labels))


def bdd100k_index(root: str, subset: str = "train") -> list[tuple[str, str]]:
    img_dir = os.path.join(root, "images", subset)
    lbl_dir = os.path.join(root, "labels", subset)
    imgs = sorted(f for f in os.listdir(img_dir) if _is_image(f))
    labels = sorted(f for f in os.listdir(lbl_dir) if f.endswith("_train_id.png"))
    assert len(imgs) == len(labels), (len(imgs), len(labels))
    return [(os.path.join(img_dir, i), os.path.join(lbl_dir, l)) for i, l in zip(imgs, labels)]


def voc12_index(root: str, subset: str = "train",
                allow_flat: bool | None = None) -> list[tuple[str, str]]:
    # The reference's VOC12 layout is flat (<root>/images + <root>/labels,
    # dataset.py:44-51 — no split dirs). Honor <root>/<subset>/images|labels
    # when it exists; otherwise a non-train subset would silently alias the
    # training set (a "val" metric that is really a train metric), so that
    # case is an ERROR unless explicitly opted into via allow_flat=True or
    # MDILSS_ALLOW_FLAT_VOC12=1 in the environment.
    if os.path.isdir(os.path.join(root, subset, "labels")):
        root = os.path.join(root, subset)
    elif subset != "train":
        if allow_flat is None:
            allow_flat = os.environ.get("MDILSS_ALLOW_FLAT_VOC12", "") not in ("", "0")
        if not allow_flat:
            raise ValueError(
                f"VOC12 root {root!r} has no {subset}/ split dir (reference "
                f"flat layout, dataset.py:44-51): '{subset}' would silently "
                f"return the SAME image set as 'train'. Create "
                f"<root>/{subset}/images|labels, or opt in to the aliasing "
                f"with MDILSS_ALLOW_FLAT_VOC12=1."
            )
        print(f"[data] VOC12 root {root!r} has no {subset}/ split dir "
              f"(reference flat layout): '{subset}' returns the SAME image "
              f"set as 'train' — val metrics are training-set metrics")
    lbl_dir = os.path.join(root, "labels")
    img_dir = os.path.join(root, "images")
    names = sorted(
        os.path.splitext(f)[0] for f in os.listdir(lbl_dir) if _is_image(f)
    )
    return [
        (os.path.join(img_dir, n + ".jpg"), os.path.join(lbl_dir, n + ".png"))
        for n in names
    ]


@dataclass
class Source:
    """An indexed dataset: (image, label) paths + optional label remap."""

    name: str
    pairs: list[tuple[str, str]]
    num_classes: int
    label_map: np.ndarray | None = None  # uint8 LUT of length 256

    def __len__(self) -> int:
        return len(self.pairs)


def make_source(name: str, root: str, subset: str = "train") -> Source:
    """Build a Source by reference dataset name."""
    if name == "cityscapes":
        return Source(name, cityscapes_index(root, subset), 20)
    if name == "IDD":
        return Source(name, idd_index(root, subset), 27)
    if name == "IDD_union":
        lut = np.arange(256, dtype=np.int32)
        for k, v in IDD_UNION_MAP.items():
            lut[k] = v
        return Source(name, idd_index(root, subset), 28, label_map=lut.astype(np.uint8))
    if name == "BDD":
        return Source(name, bdd100k_index(root, subset), 20)
    if name == "VOC12":
        return Source(name, voc12_index(root, subset), 21)
    raise ValueError(f"unknown dataset {name!r}")
