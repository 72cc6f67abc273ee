"""The port's analysis tools (mdilss_tpu_torch/data/colorize.py,
analysis/tsne.py, analysis/predict.py and the models' `return_features`)
against the JAX package's (mdilss_tpu/data/colorize.py, analysis/tsne.py,
analysis/predict.py, `apply(..., return_features=True)`) on the CPU, on the
same weights (JAX's init with random BN, through the weight bridge) and the
same synthetic images, as tests/test_analysis.py holds the JAX package.
Features and logits to 1e-5 relative L2 (float32 in two summation orders);
what is numpy on both sides (palettes, sampling, t-SNE on the same samples)
bit for bit; prediction maps equal off the pixels whose JAX top-2 logit gap
is within 1e-4."""
import importlib
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_port import randomize_bn, rel_l2
from mdilss_tpu.analysis import predict as jpredict
from mdilss_tpu.analysis import tsne as jtsne
from mdilss_tpu.ckpt import export_state_dict
from mdilss_tpu.data import SyntheticSource as JaxSyntheticSource
from mdilss_tpu.models import erfnet as jerfnet
from mdilss_tpu.models import erfnet_multihead as jmh
from mdilss_tpu.models import erfnet_rap
from mdilss_tpu_torch.analysis import predict, tsne
from mdilss_tpu_torch.ckpt import from_jax
from mdilss_tpu_torch.data import colorize
from mdilss_tpu_torch.data.loader import SyntheticSource
from mdilss_tpu_torch.models import ERFNet, ERFNetMultiHead, ERFNetRAP

# the module itself: mdilss_tpu.data exports a function of the same name
jcolorize = importlib.import_module("mdilss_tpu.data.colorize")
torch.set_num_threads(1)
H, W = 32, 64
NC = [6, 7]


@pytest.fixture(scope="module")
def rap():
    params, bn = randomize_bn(*erfnet_rap.init(jax.random.key(4), NC, 2),
                              np.random.default_rng(4))
    model = ERFNetRAP(NC, 2, device="cpu")
    model.load_state_dict(from_jax(params, bn), strict=True)
    return params, bn, model


@pytest.mark.parametrize("n", [20, 22, 27, 29, 256])
def test_colormaps_and_colorize_equal_jax(n):
    np.testing.assert_array_equal(colorize.colormap_cityscapes(n), jcolorize.colormap_cityscapes(n))
    np.testing.assert_array_equal(colorize.colormap(n), jcolorize.colormap(n))
    labels = np.random.default_rng(n).integers(0, 30, (2, 17, 23)).astype(np.uint8)
    labels[0, 0, :4] = 255
    got = colorize.colorize(labels, n)
    assert got.dtype == np.uint8 and got.shape == (2, 17, 23, 3)
    np.testing.assert_array_equal(got, jcolorize.colorize(labels, n))


def _multihead(kind):
    rng = np.random.default_rng(5)
    if kind == "erfnet":
        params, bn = randomize_bn(*jerfnet.init(jax.random.key(5), 6), rng)
        model = ERFNet(6, device="cpu")
        apply = lambda p, s, x, t, **kw: jerfnet.apply(p, s, x, **kw)  # noqa: E731
    else:
        params, bn = randomize_bn(*jmh.init(jax.random.key(5), [6, 7, 8]), rng)
        model = ERFNetMultiHead([6, 7, 8], kind=kind, device="cpu")
        apply = jmh.apply
    sd = {k: torch.from_numpy(np.array(v)) for k, v in
          export_state_dict(params, bn, kind=kind).items()}
    model.load_state_dict(sd, strict=True)
    return apply, params, bn, model


@pytest.mark.parametrize("kind", ["rap", "multi_task", "erfnet"])
def test_return_features_match_jax(rap, kind):
    """(logits, {"encoder", "penultimate"}) of the eval forward, NHWC, each
    within 1e-5 rel L2 of `apply(..., return_features=True)`; the default
    signature returns the same logits alone."""
    if kind == "rap":
        params, bn, model = rap
        apply, task = erfnet_rap.apply, 1
    else:
        apply, params, bn, model = _multihead(kind)
        task = 0 if kind == "erfnet" else 2
    x = np.random.default_rng(6).random((2, H, W, 3), dtype=np.float32)
    j_logits, _, j_feats = apply(params, bn, jnp.asarray(x), task, training=False,
                                 return_features=True)
    logits, feats = model(torch.from_numpy(x), task, return_features=True)
    assert set(feats) == {"encoder", "penultimate"}
    assert tuple(feats["encoder"].shape) == (2, H // 8, W // 8, 128)
    assert tuple(feats["penultimate"].shape) == (2, H // 2, W // 2, 16)
    for got, want in ((logits, j_logits), (feats["encoder"], j_feats["encoder"]),
                      (feats["penultimate"], j_feats["penultimate"])):
        assert tuple(got.shape) == tuple(want.shape)
        assert rel_l2(got.numpy(), want) <= 1e-5
    assert torch.equal(model(torch.from_numpy(x), task), logits)


def test_sample_pixels_equals_jax():
    rng = np.random.default_rng(7)
    labels = rng.integers(0, 20, (64, 128)).astype(np.uint8)
    feats = rng.random((8, 16, 4)).astype(np.float32)
    for n, seed in ((50, 0), (128, 3), (10**9, 1)):
        got = tsne.sample_pixels(feats, labels, n=n, seed=seed)
        want = jtsne.sample_pixels(feats, labels, n=n, seed=seed)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    same = rng.integers(0, 20, (8, 16)).astype(np.uint8)  # no downsample
    for g, w in zip(tsne.sample_pixels(feats, same, n=40), jtsne.sample_pixels(feats, same, n=40)):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("which", ["encoder", "penultimate", "logits"])
def test_extract_features_equals_jax(rap, which):
    """The same image picked (a selection that skips the first two), the same
    relabeled labels, features within 1e-5 rel L2."""
    params, bn, model = rap
    pick = lambda labels, n: int(labels.sum()) % 3 == 0  # noqa: E731
    kw = dict(task=1, num_classes=NC[1], which=which, height=H, width=W, select=pick)
    want, w_lbl, w_name = jtsne.extract_features(
        erfnet_rap.apply, params, bn, JaxSyntheticSource(NC[1], n=6, height=H, width=W), **kw)
    got, g_lbl, g_name = tsne.extract_features(
        model, SyntheticSource(NC[1], n=6, height=H, width=W), device="cpu", **kw)
    assert g_name == w_name and g_name != "index0"
    np.testing.assert_array_equal(g_lbl, w_lbl)
    assert got.shape == want.shape and got.dtype == np.float32
    assert rel_l2(got, want) <= 1e-5
    with pytest.raises(ValueError, match="selection"):
        tsne.extract_features(model, SyntheticSource(NC[1], n=2, height=H, width=W),
                              device="cpu", **{**kw, "select": lambda labels, n: False})


def test_tsne_embed_equals_jax_and_run_tsne_writes_its_plot(rap, tmp_path):
    pytest.importorskip("sklearn")
    pytest.importorskip("matplotlib")
    params, bn, model = rap
    samples = np.random.default_rng(8).random((60, 5)).astype(np.float32)
    np.testing.assert_array_equal(tsne.tsne_embed(samples), jtsne.tsne_embed(samples))
    out = tsne.run_tsne(model, SyntheticSource(NC[0], n=2, height=H, width=W), task=0,
                        num_classes=NC[0], out_path=str(tmp_path / "plots" / "tsne.png"),
                        n_samples=30, select=lambda labels, n: True, height=H, width=W,
                        device="cpu")
    assert os.path.getsize(out["plot"]) > 0 and out["image"] == "index0"
    assert out["embedding"].shape == (30, 2) and out["labels"].shape == (30,)


def test_save_predictions_equal_jax(rap, tmp_path):
    """The same file names and early stop; the PNGs equal JAX's on every pixel
    whose JAX top-2 logit gap exceeds 1e-4, and ground truth equal everywhere."""
    from PIL import Image

    params, bn, model = rap
    kw = dict(task=1, num_classes=NC[1], max_images=3, save_gt=True, batch_size=2,
              height=H, width=W)
    want = jpredict.save_predictions(erfnet_rap.apply, params, bn,
                                     JaxSyntheticSource(NC[1], n=5, height=H, width=W),
                                     out_dir=str(tmp_path / "jax"), **kw)
    got = predict.save_predictions(model, SyntheticSource(NC[1], n=5, height=H, width=W),
                                   out_dir=str(tmp_path / "port"), device="cpu", **kw)
    assert [os.path.basename(p) for p in got] == [os.path.basename(p) for p in want]
    assert len(got) == 6 and got[0].endswith("synthetic7_00000_pred.png")
    src = SyntheticSource(NC[1], n=5, height=H, width=W)
    for g, w in zip(got, want):
        g_img, w_img = np.asarray(Image.open(g)), np.asarray(Image.open(w))
        assert g_img.shape == (H, W, 3)
        if g.endswith("_gt.png"):
            np.testing.assert_array_equal(g_img, w_img)
            continue
        idx = int(os.path.basename(g).split("_")[1])
        img, _ = src.decode(idx, H, W)
        logits = np.asarray(erfnet_rap.apply(params, bn, jnp.asarray(img[None] / 255.0,
                                                                     jnp.float32), 1)[0][0])
        top2 = np.sort(logits, axis=-1)[..., -2:]
        decided = top2[..., 1] - top2[..., 0] > 1e-4
        np.testing.assert_array_equal(g_img[decided], w_img[decided])
