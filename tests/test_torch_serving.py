"""Port of serving, metrics and evaluation (mdilss_tpu_torch/serving.py,
metrics.py, evaluate.py) against the JAX package in float32, plus the
device rules of the port's entry points on a host without CUDA."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_port import randomize_bn, rel_l2, to_nchw
from mdilss_tpu import evaluate as jax_evaluate
from mdilss_tpu import metrics as jax_metrics
from mdilss_tpu import serving as jax_serving
from mdilss_tpu.models import erfnet_rap
from mdilss_tpu_torch import evaluate, metrics, resolve_device, serving
from mdilss_tpu_torch.ckpt import from_jax
from mdilss_tpu_torch.data.transforms import prepare_batch
from mdilss_tpu_torch.models import ERFNetRAP
from mdilss_tpu_torch.models.blocks import NonBottleneck1dRAP
from mdilss_tpu_torch.ops import nb1d_infer as K

torch.set_num_threads(1)

NUM_CLASSES = [5, 7]
H, W = 32, 64


@pytest.fixture(scope="module")
def models():
    params, state = erfnet_rap.init(jax.random.key(1), NUM_CLASSES, 2)
    params, state = randomize_bn(params, state, np.random.default_rng(1))
    model = ERFNetRAP(NUM_CLASSES, 2, device="cpu")
    model.load_state_dict(from_jax(params, state), strict=True)
    return params, state, model


@pytest.mark.parametrize("output", ["logits", "labels"])
def test_build_infer_fn_matches_jax(models, output):
    params, state, model = models
    x = np.random.default_rng(2).random((2, H, W, 3), dtype=np.float32)
    want = np.asarray(jax.jit(jax_serving.build_infer_fn(
        erfnet_rap.apply, params, state, 1, output=output, compute_dtype=jnp.float32,
    ))(jnp.asarray(x)))
    got = serving.build_infer_fn(model, 1, output=output, compute_dtype=torch.float32)(
        torch.from_numpy(x)).numpy()
    assert got.shape == want.shape and got.dtype == want.dtype
    if output == "logits":
        assert rel_l2(got, want) <= 1e-5
    else:
        np.testing.assert_array_equal(got, want)


def test_bf16_default_matches_jax_bf16(models):
    """The serving default, bfloat16, against the JAX package's bf16 path.
    The two round at different places (the port folds each nb1d block's BN
    and conv biases into one float32 affine), so they are compared in
    relative L2 at the bf16 kernel tolerance, 2e-2 (measured ~4e-3, the
    same distance as JAX bf16 from JAX float32)."""
    params, state, model = models
    x = np.random.default_rng(6).random((2, H, W, 3), dtype=np.float32)
    for task in range(len(NUM_CLASSES)):
        want = np.asarray(jax.jit(jax_serving.build_infer_fn(
            erfnet_rap.apply, params, state, task))(jnp.asarray(x)))
        got = serving.build_infer_fn(model, task)(torch.from_numpy(x)).numpy()
        assert got.dtype == np.float32 and got.shape == want.shape
        assert rel_l2(got, want) <= 2e-2


def test_serve_batches_uint8_matches_jax(models):
    params, state, model = models
    batches = [np.random.default_rng(i).integers(0, 256, (2, H, W, 3), np.uint8) for i in range(2)]
    jfn = jax.jit(jax_serving.build_infer_fn(erfnet_rap.apply, params, state, 0,
                                             output="labels", compute_dtype=jnp.float32))
    fn = serving.build_infer_fn(model, 0, output="labels", compute_dtype=torch.float32)
    got = list(serving.serve_fn_batches(fn, batches, H, W))
    assert len(got) == 2
    for g, b in zip(got, batches):
        assert g.shape == (2, H, W) and g.dtype == np.int32
        np.testing.assert_array_equal(g, np.asarray(jfn(jnp.asarray(b, jnp.float32) / 255.0)))
    with pytest.raises(ValueError, match="serves"):
        list(serving.serve_fn_batches(fn, [np.zeros((1, 16, W, 3), np.uint8)], H, W))


def test_iou_evaluator_matches_jax():
    rng = np.random.default_rng(3)
    nc = 6
    ours, ref = metrics.IoUEvaluator(nc, nc - 1), jax_metrics.IoUEvaluator(nc, nc - 1)
    for _ in range(3):
        preds = rng.integers(0, nc, (2, 8, 16))
        targets = rng.integers(0, nc, (2, 8, 16))
        ours.add_batch(torch.from_numpy(preds), torch.from_numpy(targets))
        ref.add_batch(jnp.asarray(preds), jnp.asarray(targets))
    miou, per_class = ours.get_iou()
    want_miou, want_per_class = ref.get_iou()
    assert miou == want_miou
    np.testing.assert_array_equal(per_class, want_per_class)
    # ignore_index >= num_classes means no ignore class
    assert metrics.IoUEvaluator(nc, nc).ignore_index is None


@pytest.mark.parametrize("case", ["listed", "random"])
def test_confusion_matrix_drops_out_of_range_targets_as_jax(case):
    """A target of C or more makes a flat index past C*C: JAX's
    bincount(length=C*C) drops it (a negative one counts in bin 0)."""
    if case == "listed":
        nc, preds, targets = 3, np.array([[[0, 1, 2, 1]]]), np.array([[[0, 1, 5, 2]]])
    else:
        rng = np.random.default_rng(4)
        nc = 5
        preds = rng.integers(0, nc, (2, 8, 16))
        targets = rng.integers(-1, nc + 3, (2, 8, 16))
    want = np.asarray(jax_metrics.confusion_matrix(jnp.asarray(preds), jnp.asarray(targets),
                                                   num_classes=nc))
    got = metrics.confusion_matrix(torch.from_numpy(preds), torch.from_numpy(targets),
                                   num_classes=nc)
    assert got.shape == (nc, nc)
    np.testing.assert_array_equal(got.numpy(), want)
    if case == "listed":
        assert want.tolist() == [[1, 0, 0], [0, 1, 0], [0, 1, 0]]


def test_prepare_batch_relabels_void():
    imgs = np.full((1, 2, 2, 3), 255, np.uint8)
    lbls = np.array([[[0, 255], [3, 255]]], np.uint8)
    x, y = prepare_batch(torch.from_numpy(imgs), torch.from_numpy(lbls), num_classes=7)
    assert x.dtype == torch.float32 and float(x.max()) == 1.0
    assert y.dtype == torch.int32 and y.tolist() == [[[0, 6], [3, 6]]]


def test_evaluate_domain_matches_jax(models):
    """Per-class IoU equal to the JAX package's on in-memory batches with void
    (255) pixels and a padding image; the argmax maps agree, so exactly."""
    params, state, model = models
    rng = np.random.default_rng(4)
    nc = NUM_CLASSES[1]
    batches = []
    for i in range(2):
        imgs = rng.integers(0, 256, (2, H, W, 3), np.uint8)
        lbls = rng.integers(0, nc, (2, H, W)).astype(np.uint8)
        lbls[:, :4] = 255
        batches.append((imgs, lbls, np.array([True, i == 0])))
    x = np.concatenate([b[0] for b in batches]).astype(np.float32) / 255.0
    jax_labels = np.asarray(erfnet_rap.apply(params, state, jnp.asarray(x), 1,
                                             training=False)[0]).argmax(-1)
    np.testing.assert_array_equal(model(torch.from_numpy(x), 1).numpy().argmax(-1), jax_labels)
    miou, per_class = evaluate.evaluate_domain(model, 1, nc, batches)
    want_miou, want_per_class = jax_evaluate.evaluate_domain(
        erfnet_rap.apply, params, state, task=1, num_classes=nc, loader=batches)
    np.testing.assert_array_equal(per_class, want_per_class)
    assert miou == want_miou


def test_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ERFNetRAP([5], 1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")


def test_cpu_nb1d_infer_takes_plain_version_without_launch():
    blk = NonBottleneck1dRAP(16, 2, 2)
    x = to_nchw(np.random.default_rng(5).standard_normal((1, 8, 8, 16), dtype=np.float32))
    ops = K.prepare_operands(blk, 1, torch.float32)
    before = K.LAUNCHES
    got = K.nb1d_infer(x, ops, 2)
    assert K.LAUNCHES == before == 0
    assert torch.equal(got, K.nb1d_infer_plain(x, ops, 2))
