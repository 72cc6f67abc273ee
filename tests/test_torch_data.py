"""The port's data pipeline (mdilss_tpu_torch/data, native) against the JAX
package's on the CPU, exactly: the dataset indexes on trees laid out as each
dataset's, `decode_pair` through the native decoder and through PIL,
`augment_batch` fed the draws JAX makes from its key, `batch_indices` and the
Loader's batches, and the device caches against the streaming Loader; the
producer threads' error propagation and shutdown."""
import io
import os
import threading
import time

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

import mdilss_tpu.native as jnative
from _torch_port import jax_augment_draws
from mdilss_tpu.data import loader as jloader
from mdilss_tpu.data import sources as jsources
from mdilss_tpu.data import transforms as jtransforms
import mdilss_tpu_torch.native as pnative
from mdilss_tpu_torch.data import loader as ploader
from mdilss_tpu_torch.data import sources as psources
from mdilss_tpu_torch.data import transforms as ptransforms
from mdilss_tpu_torch.data.device_cache import DeviceCache, HybridCache, cache_bytes, plan_cache

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_decoder_source_is_byte_equal_to_jax():
    with open(os.path.join(REPO, "mdilss_tpu/native/decoder.cc"), "rb") as a, \
            open(os.path.join(REPO, "mdilss_tpu_torch/native/decoder.cc"), "rb") as b:
        assert a.read() == b.read()


# ---- dataset indexes ------------------------------------------------------------------------

def _png(path, arr, mode=None):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    Image.fromarray(arr, mode=mode).save(path)


def _tree(root, layout: str):
    """A tree in `layout`'s conventions for train and val, with decoy files
    the suffix filters must skip."""
    img, lbl = np.zeros((4, 6, 3), np.uint8), np.zeros((4, 6), np.uint8)
    for subset in ("train", "val"):
        for i in range(3):
            city = ("bremen", "aachen")[i % 2]
            if layout in ("cityscapes", "IDD"):
                suffix = "labelTrainIds" if layout == "cityscapes" else "labellevel3Ids"
                stem = f"{city}_{i:06d}"
                _png(f"{root}/leftImg8bit/{subset}/{city}/{stem}_leftImg8bit.png", img)
                _png(f"{root}/gtFine/{subset}/{city}/{stem}_gtFine_{suffix}.png", lbl)
                _png(f"{root}/gtFine/{subset}/{city}/{stem}_gtFine_labelIds.png", lbl)
            elif layout == "BDD":
                _png(f"{root}/images/{subset}/{i:04d}.jpg", img)
                _png(f"{root}/labels/{subset}/{i:04d}_train_id.png", lbl)
                _png(f"{root}/labels/{subset}/{i:04d}_color.png", lbl)
            else:  # VOC12, split layout
                _png(f"{root}/{subset}/images/n{i}.jpg", img)
                _png(f"{root}/{subset}/labels/n{i}.png", lbl, "P")


@pytest.mark.parametrize("name,layout", [("cityscapes", "cityscapes"), ("IDD", "IDD"),
                                         ("IDD_union", "IDD"), ("BDD", "BDD"),
                                         ("VOC12", "VOC12")])
def test_make_source_equals_jax(tmp_path, name, layout):
    _tree(str(tmp_path), layout)
    for subset in ("train", "val"):
        got = psources.make_source(name, str(tmp_path), subset)
        want = jsources.make_source(name, str(tmp_path), subset)
        assert len(got) == 3 and got.pairs == want.pairs
        assert (got.name, got.num_classes) == (want.name, want.num_classes)
        if want.label_map is None:
            assert got.label_map is None
        else:
            np.testing.assert_array_equal(got.label_map, want.label_map)
    assert psources.DATASET_NUM_CLASSES == jsources.DATASET_NUM_CLASSES


def test_voc12_flat_layout_refuses_to_alias_val(tmp_path, monkeypatch):
    _png(f"{tmp_path}/images/a.jpg", np.zeros((4, 4, 3), np.uint8))
    _png(f"{tmp_path}/labels/a.png", np.zeros((4, 4), np.uint8), "P")
    monkeypatch.delenv("MDILSS_ALLOW_FLAT_VOC12", raising=False)
    with pytest.raises(ValueError, match="silently"):
        psources.voc12_index(str(tmp_path), "val")
    assert psources.voc12_index(str(tmp_path), "val", allow_flat=True) == \
        jsources.voc12_index(str(tmp_path), "val", allow_flat=True)


# ---- decode_pair ----------------------------------------------------------------------------

def _write_pair(tmp_path, rng, image_format: str, label_mode: str):
    img = rng.integers(0, 256, (45, 70, 3), np.uint8)
    lbl = rng.integers(0, 27, (45, 70), np.uint8)
    lbl[0, :6] = 255
    ip = str(tmp_path / f"img.{image_format}")
    if image_format == "jpg":
        Image.fromarray(img).save(ip, "JPEG", quality=90)
    else:
        Image.fromarray(img).save(ip)
    lp = str(tmp_path / "lbl.png")
    im = Image.fromarray(lbl, mode=label_mode)
    if label_mode == "P":
        im.putpalette([v for i in range(256) for v in (i, i, i)])
    im.save(lp)
    return ip, lp


@pytest.fixture
def no_native(monkeypatch):
    """Both packages' decoders turned off, so decode_pair takes PIL."""
    monkeypatch.setattr(jnative, "_tried", True)
    monkeypatch.setattr(jnative, "_decoder", None)
    monkeypatch.setattr(pnative, "_tried", True)
    monkeypatch.setattr(pnative, "_decoder", None)


@pytest.mark.parametrize("image_format,label_mode", [("png", "L"), ("png", "P"), ("jpg", "P")])
@pytest.mark.parametrize("path", ["native", "pil"])
def test_decode_pair_equals_jax(tmp_path, rng, request, image_format, label_mode, path):
    if path == "pil":
        request.getfixturevalue("no_native")
    elif pnative.get_decoder() is None or jnative.get_decoder() is None:
        pytest.skip("native decoder unavailable (g++ with libpng/libjpeg)")
    ip, lp = _write_pair(tmp_path, rng, image_format, label_mode)
    lut = np.arange(256, dtype=np.uint8)
    lut[26] = 3
    for label_map in (None, lut):
        got = ptransforms.decode_pair(ip, lp, height=24, width=40, label_map=label_map)
        want = jtransforms.decode_pair(ip, lp, height=24, width=40, label_map=label_map)
        for g, w in zip(got, want):
            assert g.dtype == np.uint8
            np.testing.assert_array_equal(g, w)


def test_native_decoder_builds_outside_the_packages():
    dec = pnative.get_decoder()
    if dec is None:
        pytest.skip("native decoder unavailable (g++ with libpng/libjpeg)")
    assert dec.__name__ == pnative.MODULE_NAME
    assert os.path.dirname(dec.__file__) == str(pnative.BUILD_DIR)
    buf = io.BytesIO()
    Image.fromarray(np.full((4, 6), 7, np.uint8), mode="L").save(buf, "PNG")
    assert np.frombuffer(dec.decode_label(buf.getvalue(), 2, 3), np.uint8).tolist() == [7] * 6


def test_decode_pair_without_native_or_pil_names_both(tmp_path, rng, no_native, monkeypatch):
    import builtins

    ip, lp = _write_pair(tmp_path, rng, "png", "L")
    real_import = builtins.__import__

    def no_pil(name, *a, **kw):
        if name == "PIL" or name.startswith("PIL."):
            raise ImportError("no PIL")
        return real_import(name, *a, **kw)

    monkeypatch.setattr(builtins, "__import__", no_pil)
    with pytest.raises(RuntimeError, match="native decoder.*PIL is not installed"):
        ptransforms.decode_pair(ip, lp, height=8, width=8)


# ---- augment --------------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(4))
def test_augment_batch_equals_jax(rng, seed):
    n = 8
    imgs = rng.integers(0, 256, (n, 12, 20, 3), dtype=np.uint8)
    lbls = rng.integers(0, 20, (n, 12, 20)).astype(np.uint8)
    lbls[:, 3, :] = 255
    key = jax.random.key(seed)
    wx, wy = jtransforms.augment_batch(jnp.asarray(imgs), jnp.asarray(lbls), key, num_classes=20)
    flip, tx, ty = jax_augment_draws(key, n)
    gx, gy = ptransforms.augment_batch(torch.from_numpy(imgs), torch.from_numpy(lbls),
                                       flip, tx, ty, num_classes=20)
    assert gx.dtype == torch.float32 and gy.dtype == torch.int32
    np.testing.assert_array_equal(gx.numpy(), np.asarray(wx))
    np.testing.assert_array_equal(gy.numpy(), np.asarray(wy))


def test_draw_augment_ranges_and_generator_state():
    gen = torch.Generator().manual_seed(3)
    state = gen.get_state()
    flip, tx, ty = ptransforms.draw_augment(gen, 4000)
    assert flip.dtype == torch.bool and 0.45 < flip.float().mean() < 0.55
    for t in (tx, ty):
        assert sorted(t.unique().tolist()) == [-2, -1, 0, 1, 2]
    gen.set_state(state)
    again = ptransforms.draw_augment(gen, 4000)
    assert all(torch.equal(a, b) for a, b in zip((flip, tx, ty), again))


def test_prepare_batch_equals_jax(rng):
    imgs = rng.integers(0, 256, (2, 4, 6, 3), dtype=np.uint8)
    lbls = rng.integers(0, 20, (2, 4, 6)).astype(np.uint8)
    lbls[0, 0, 0] = 255
    gx, gy = ptransforms.prepare_batch(torch.from_numpy(imgs), torch.from_numpy(lbls),
                                       num_classes=20)
    wx, wy = jtransforms.prepare_batch(jnp.asarray(imgs), jnp.asarray(lbls), num_classes=20)
    np.testing.assert_array_equal(gx.numpy(), np.asarray(wx))
    np.testing.assert_array_equal(gy.numpy(), np.asarray(wy))


# ---- batching and the Loader ----------------------------------------------------------------

@pytest.mark.parametrize("n,bs,shuffle,drop_last", [(11, 3, True, True), (11, 3, False, False),
                                                    (7, 4, True, False), (8, 4, False, True),
                                                    (2, 4, False, False)])
def test_batch_indices_equal_jax(n, bs, shuffle, drop_last):
    for epoch in (0, 1, 5):
        kw = dict(seed=7, epoch=epoch, shuffle=shuffle, drop_last=drop_last)
        got = list(ploader.batch_indices(n, bs, **kw))
        want = list(jloader.batch_indices(n, bs, **kw))
        assert len(got) == len(want)
        for (gi, gv), (wi, wv) in zip(got, want):
            np.testing.assert_array_equal(gi, wi)
            np.testing.assert_array_equal(gv, wv)


@pytest.mark.parametrize("kind", ["SyntheticSource", "LearnableSource"])
@pytest.mark.parametrize("shuffle", [True, False])
def test_loader_batches_equal_jax(kind, shuffle):
    src_p = getattr(ploader, kind)(6, n=7, height=16, width=24, seed=3)
    src_j = getattr(jloader, kind)(6, n=7, height=16, width=24, seed=3)
    kw = dict(batch_size=3, height=16, width=24, shuffle=shuffle, num_threads=2, seed=4)
    pl, jl = ploader.Loader(src_p, **kw), jloader.Loader(src_j, **kw)
    assert len(pl) == len(jl)
    for epoch in (1, 2):
        pl.set_epoch(epoch)
        jl.set_epoch(epoch)
        got, want = list(pl), list(jl)
        assert len(got) == len(want) == len(pl)
        for g, w in zip(got, want):
            for a, b in zip(g, w):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)


def test_loader_over_files_equals_jax(tmp_path):
    _tree(str(tmp_path), "cityscapes")
    kw = dict(batch_size=2, height=4, width=6, shuffle=True, seed=1, num_threads=2)
    got = list(ploader.Loader(psources.make_source("cityscapes", str(tmp_path)), **kw))
    want = list(jloader.Loader(jsources.make_source("cityscapes", str(tmp_path)), **kw))
    assert len(got) == len(want) == 1
    for a, b in zip(got[0], want[0]):
        np.testing.assert_array_equal(a, b)


def test_device_prefetch_on_the_cpu_yields_the_batches():
    ld = ploader.Loader(ploader.SyntheticSource(5, n=5, height=8, width=16), batch_size=2,
                        height=8, width=16)
    want = list(ld)
    got = list(ploader.device_prefetch(ld, device="cpu"))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert all(isinstance(t, torch.Tensor) for t in g)
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a.numpy(), b)


# ---- device caches --------------------------------------------------------------------------

def _assert_batches_equal(got, want):
    assert len(got) == len(want)
    for (gi, gl, gv), (wi, wl, wv) in zip(got, want):
        np.testing.assert_array_equal(np.asarray(gv), wv)
        gi, gl = torch.as_tensor(gi).numpy(), torch.as_tensor(gl).numpy()
        np.testing.assert_array_equal(gi[wv], wi[wv])
        np.testing.assert_array_equal(gl[wv], wl[wv])


@pytest.mark.parametrize("shuffle,drop_last", [(True, None), (False, None), (True, False)])
def test_caches_equal_the_streaming_loader(shuffle, drop_last):
    src = ploader.SyntheticSource(7, n=11, height=16, width=24, seed=3)
    ld = ploader.Loader(src, batch_size=3, height=16, width=24, shuffle=shuffle,
                        drop_last=drop_last, seed=5, num_threads=2)
    caches = [DeviceCache(ld, device="cpu"), HybridCache(ld, 5, device="cpu")]
    for epoch in (0, 2):
        ld.set_epoch(epoch)
        stream = list(ld)
        assert len(stream) == (3 if shuffle and drop_last is None else 4)
        for cache in caches:
            _assert_batches_equal(list(cache.epoch_batches(epoch, shuffle=shuffle)), stream)


def test_cache_take_is_the_host_rows():
    src = ploader.SyntheticSource(7, n=6, height=8, width=16, seed=1)
    ld = ploader.Loader(src, batch_size=2, height=8, width=16)
    cache = DeviceCache(ld, device="cpu")
    assert cache.images.dtype == torch.uint8 and cache.images.shape == (6, 8, 16, 3)
    idx = np.array([5, 0, 3])
    imgs, lbls = cache.take(idx)
    for row, i in enumerate(idx):
        img, lbl = src.decode(int(i), 8, 16)
        np.testing.assert_array_equal(imgs[row].numpy(), img)
        np.testing.assert_array_equal(lbls[row].numpy(), lbl)


def test_plan_cache_modes_equal_jax():
    from mdilss_tpu.data import device_cache as jcache

    src = ploader.SyntheticSource(7, n=10, height=8, width=8)
    for budget, bs in ((10 * 256, 1), (6 * 256, 3), (2 * 256, 3), (0, 1), (10**9, 6)):
        kw = dict(height=8, width=8, budget_bytes=budget, batch_size=bs)
        assert plan_cache(src, **kw) == jcache.plan_cache(src, **kw)
    assert cache_bytes(100, 512, 1024) == jcache.cache_bytes(100, 512, 1024)


def test_hybrid_cache_rejects_a_full_or_empty_split():
    ld = ploader.Loader(ploader.SyntheticSource(5, n=4, height=8, width=8), batch_size=2,
                        height=8, width=8)
    for rows in (0, 4):
        with pytest.raises(ValueError, match="max_rows"):
            HybridCache(ld, rows, device="cpu")


# ---- producer threads -----------------------------------------------------------------------

def test_loader_propagates_producer_errors(tmp_path):
    class BrokenSource:
        pairs = [(str(tmp_path / "missing.png"), str(tmp_path / "missing_l.png"))] * 2
        label_map = None

        def __len__(self):
            return len(self.pairs)

    with pytest.raises(Exception, match="missing"):
        next(iter(ploader.Loader(BrokenSource(), batch_size=2, height=8, width=16)))


def test_hybrid_cache_propagates_producer_errors():
    src = ploader.SyntheticSource(5, n=6, height=8, width=16)
    ld = ploader.Loader(src, batch_size=2, height=8, width=16, shuffle=True, seed=0)
    hc = HybridCache(ld, 4, device="cpu")

    def boom(idx):
        raise RuntimeError(f"decode failed for row {idx}")

    ld._decode = boom
    with pytest.raises(RuntimeError, match="decode failed"):
        for _ in hc.epoch_batches(0):
            pass


def _settle(n0: int, what: str):
    deadline = time.time() + 15
    while time.time() < deadline:
        if threading.active_count() <= n0:
            return
        time.sleep(0.05)
    raise AssertionError(f"{what}: {threading.active_count() - n0} leaked thread(s)")


def test_abandoned_iterators_do_not_leak_producer_threads():
    src = ploader.SyntheticSource(5, n=64, height=8, width=16)
    n0 = threading.active_count()
    it = iter(ploader.Loader(src, batch_size=2, height=8, width=16, prefetch=1))
    next(it)
    it.close()
    _settle(n0, "Loader")

    ld = ploader.Loader(src, batch_size=2, height=8, width=16, shuffle=True, seed=0)
    hc = HybridCache(ld, 8, device="cpu")  # most rows uncached: the producer is busy
    n0 = threading.active_count()
    gen = hc.epoch_batches(0)
    next(gen)
    gen.close()
    _settle(n0, "HybridCache")
