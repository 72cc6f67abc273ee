"""The port's checkpoint evaluation (mdilss_tpu_torch/evaluate.py) against the
JAX package's: a Cityscapes-layout and an IDD-layout PNG tree written here,
and a reference-format `.pth.tar` (`module.`-prefixed keys) written from JAX
weights with `mdilss_tpu.ckpt.export_state_dict` and `torch.save`. In float64
both packages' logits differ by far less than any top-2 gap, so the per-class
IoU must be EQUAL, as tests/test_eval_parity.py pins the JAX f64 path."""
import os

import numpy as np
import pytest
import torch
from PIL import Image

import jax

from _torch_port import randomize_bn
from mdilss_tpu import evaluate as jevaluate
from mdilss_tpu.ckpt import export_state_dict
from mdilss_tpu.models import erfnet_rap
from mdilss_tpu_torch import evaluate
from mdilss_tpu_torch.ckpt import from_jax, torch_io
from mdilss_tpu_torch.models import ERFNetRAP
from mdilss_tpu_torch.train import steps

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W = 32, 64  # eval size
NATIVE_H, NATIVE_W = 48, 80  # on-disk size: the resize runs
NUM_CLASSES = [20, 27]


def _write_tree(root: str, *, n: int, num_classes: int, suffix: str, seed: int) -> None:
    """<root>/leftImg8bit/val/<city>/... + <root>/gtFine/val/<city>/... with
    palettized labels, two cities so the walk and sort are exercised."""
    rng = np.random.default_rng(seed)
    for i in range(n):
        city = ("aa", "ab")[i % 2]
        for sub in (f"leftImg8bit/val/{city}", f"gtFine/val/{city}"):
            os.makedirs(os.path.join(root, sub), exist_ok=True)
        img = rng.integers(0, 256, (NATIVE_H, NATIVE_W, 3), dtype=np.uint8)
        lbl = rng.integers(0, num_classes - 1, (NATIVE_H, NATIVE_W)).astype(np.uint8)
        lbl[rng.random((NATIVE_H, NATIVE_W)) < 0.07] = 255
        stem = f"{city}_{i:03d}"
        Image.fromarray(img).save(os.path.join(root, "leftImg8bit/val", city,
                                               f"{stem}_leftImg8bit.png"))
        im = Image.fromarray(lbl, mode="P")
        im.putpalette([v for i in range(256) for v in (i, i, i)])
        im.save(os.path.join(root, "gtFine/val", city, f"{stem}_gtFine_{suffix}"))


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_eval")
    roots = {"cityscapes": str(tmp / "cs"), "IDD": str(tmp / "idd")}
    _write_tree(roots["cityscapes"], n=3, num_classes=20, suffix="labelTrainIds.png", seed=11)
    _write_tree(roots["IDD"], n=2, num_classes=27, suffix="labellevel3Ids.png", seed=22)
    rng = np.random.default_rng(5)
    params, bn = randomize_bn(*erfnet_rap.init(jax.random.key(3), NUM_CLASSES, 2), rng)
    sd = export_state_dict(params, bn, kind="rap", prefix="module.")
    ckpt = str(tmp / "model_best.pth.tar")
    torch.save({"epoch": 1, "arch": "Net", "best_acc": 0.5,
                "state_dict": {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}}, ckpt)
    return dict(roots=roots, ckpt=ckpt, params=params, bn=bn, tmp=tmp)


def test_f64_per_class_iou_equals_jax(setup):
    kw = dict(kind="rap", datasets=["cityscapes", "IDD"], data_roots=setup["roots"],
              height=H, width=W, compute_dtype="float64", return_per_class=True)
    try:
        want, want_pc = jevaluate.evaluate_checkpoint(setup["ckpt"], **kw)
    finally:
        jax.config.update("jax_enable_x64", False)
    got, got_pc = evaluate.evaluate_checkpoint(setup["ckpt"], device="cpu", **kw)
    for d in ("cityscapes", "IDD"):
        assert got_pc[d].dtype == np.float64
        np.testing.assert_array_equal(got_pc[d], want_pc[d], err_msg=d)
        assert got[d] == want[d]


def test_f32_batched_run_counts_padding_nowhere(setup):
    """float32 at batch 2 over 3 images (a padded final batch): per-class IoU
    within float32's argmax noise of the float64 run, here equal."""
    kw = dict(kind="rap", datasets=["cityscapes", "IDD"], data_roots=setup["roots"],
              height=H, width=W, device="cpu", return_per_class=True)
    _, f64 = evaluate.evaluate_checkpoint(setup["ckpt"], compute_dtype="float64", **kw)
    _, f32 = evaluate.evaluate_checkpoint(setup["ckpt"], batch_size=2, **kw)
    for d in f64:
        np.testing.assert_array_equal(f32[d], f64[d], err_msg=d)


def test_infer_num_classes_on_both_checkpoint_kinds(setup, tmp_path):
    assert evaluate.infer_num_classes(setup["ckpt"]) == NUM_CLASSES
    assert jevaluate.infer_num_classes(setup["ckpt"]) == NUM_CLASSES
    model = ERFNetRAP(NUM_CLASSES, 2, device="cpu")
    model.load_state_dict(from_jax(setup["params"], setup["bn"]), strict=True)
    ts = steps.init_train_state(model)
    d = str(tmp_path / "ckpt")
    torch_io.save(d, 3, ts, best_acc=0.25, aug_state=torch.Generator().get_state())
    assert evaluate.infer_num_classes(d) == NUM_CLASSES
    # the port's checkpoint evaluates as the .pth.tar of the same weights
    kw = dict(kind="rap", datasets=["cityscapes", "IDD"], data_roots=setup["roots"],
              height=H, width=W, device="cpu")
    assert evaluate.evaluate_checkpoint(d, **kw) == evaluate.evaluate_checkpoint(
        setup["ckpt"], **kw)


@pytest.mark.parametrize("kind", ["rap", "multi_task"])
def test_more_tasks_than_asked_for_load_as_jax(setup, kind):
    """A 3-task file evaluated with 2 heads: the port loads its first 2 tasks
    (the encoder slots and heads of task 2 dropped), bit for bit JAX's
    `load_checkpoint(num_classes=[20, 20])`, and the float64 per-class IoU
    equals JAX's (Cityscapes from the PNG tree, BDD synthetic)."""
    from mdilss_tpu.models import erfnet_multihead as jmh

    rng = np.random.default_rng(9)
    if kind == "rap":
        params, bn = randomize_bn(*erfnet_rap.init(jax.random.key(9), [20, 20, 27], 3), rng)
    else:
        params, bn = randomize_bn(*jmh.init(jax.random.key(9), [20, 20, 27]), rng)
    sd = export_state_dict(params, bn, kind=kind, prefix="module.")
    ckpt = str(setup["tmp"] / f"three_{kind}.pth.tar")
    torch.save({"epoch": 1, "arch": kind, "best_acc": 0.5,
                "state_dict": {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}}, ckpt)
    _, jp, jb = jevaluate.load_checkpoint(ckpt, kind=kind, num_classes=[20, 20])
    want = export_state_dict(jp, jb, kind=kind)
    got = evaluate.load_checkpoint(ckpt, kind=kind, num_classes=[20, 20], device="cpu")
    got = got.state_dict()
    assert set(got) == set(want) and not any(k.startswith("decoder.2.") for k in got)
    for k, v in want.items():
        assert torch.equal(got[k], torch.from_numpy(np.array(v)).to(got[k].dtype)), k
    kw = dict(kind=kind, datasets=["cityscapes", "BDD"], num_classes=[20, 20],
              data_roots=setup["roots"], height=H, width=W, compute_dtype="float64",
              return_per_class=True)
    try:
        want_m, want_pc = jevaluate.evaluate_checkpoint(ckpt, **kw)
    finally:
        jax.config.update("jax_enable_x64", False)
    got_m, got_pc = evaluate.evaluate_checkpoint(ckpt, device="cpu", **kw)
    for d in ("cityscapes", "BDD"):
        np.testing.assert_array_equal(got_pc[d], want_pc[d], err_msg=d)
        assert got_m[d] == want_m[d]


def test_load_pth_tar_strips_module_prefix(setup):
    sd = torch_io.load_pth_tar(setup["ckpt"])
    assert sd and not any(k.startswith("module.") for k in sd)
    want = from_jax(setup["params"], setup["bn"])
    assert set(sd) == set(want)
    for k, v in want.items():
        assert torch.equal(sd[k].to(v.dtype), v), k


def test_expected_miou_json_is_byte_equal_and_checked():
    with open(os.path.join(REPO, "mdilss_tpu/expected_miou.json"), "rb") as a, \
            open(os.path.join(REPO, "mdilss_tpu_torch/expected_miou.json"), "rb") as b:
        assert a.read() == b.read()
    import json

    with open(os.path.join(REPO, "mdilss_tpu/expected_miou.json")) as f:
        settings = [k for k in json.load(f) if not k.startswith("_")]
    assert settings
    for setting in settings:
        exp = evaluate.load_expected(setting)
        assert exp == jevaluate.load_expected(setting)
        for results in (exp, {d: v + 0.004 for d, v in exp.items()},
                        {d: v - 0.006 for d, v in exp.items()}, {}):
            assert evaluate.check_expected(results, setting) == \
                jevaluate.check_expected(results, setting)
    with pytest.raises(KeyError, match="unknown setting"):
        evaluate.load_expected("no such setting")


def test_unported_kinds_and_f64_off_the_cpu_raise(setup):
    # an ablation kind loads from the port's checkpoint directories only (no torch grammar)
    with pytest.raises(ValueError, match="kind 'erfnet_bn' has no torch checkpoint grammar"):
        evaluate.load_checkpoint(setup["ckpt"], kind="erfnet_bn", device="cpu")
    with pytest.raises(ValueError, match="float64"):
        evaluate.evaluate_checkpoint(setup["ckpt"], kind="rap", datasets=["cityscapes", "IDD"],
                                     compute_dtype="float64", device="cuda")
    with pytest.raises(ValueError, match="float32 or float64"):
        evaluate.evaluate_checkpoint(setup["ckpt"], kind="rap", datasets=["cityscapes", "IDD"],
                                     compute_dtype="bfloat16", device="cpu")
