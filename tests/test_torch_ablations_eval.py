"""The port's evaluation, serving export and analysis tools on the four
ablation models, against the JAX package's on the CPU (a file of its own
beside tests/test_torch_ablations.py: most of its time is JAX compiling the
float64 evaluation): evaluate_checkpoint in float64 (per-class IoU equal),
the exported head's logits, the t-SNE features and the prediction maps, as
tests/test_torch_evaluate.py, test_torch_export.py and test_torch_analysis.py
hold ERFNet-RAP's, from a JAX Orbax directory and a port checkpoint
directory holding the same weights (random BN and Wt)."""
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_port import ABLATION_VARIANTS as VARIANTS
from _torch_port import ablation_jax_model as jax_model
from _torch_port import ablation_port_model as port_model
from _torch_port import rel_l2
from mdilss_tpu import evaluate as jevaluate
from mdilss_tpu.analysis import predict as jpredict
from mdilss_tpu.analysis import tsne as jtsne
from mdilss_tpu.ckpt import orbax_io
from mdilss_tpu.data import SyntheticSource as JaxSyntheticSource
from mdilss_tpu.models import erfnet_ablations as A
from mdilss_tpu.train import steps as jsteps
from mdilss_tpu_torch import evaluate, serving
from mdilss_tpu_torch.analysis import predict, tsne
from mdilss_tpu_torch.ckpt import torch_io
from mdilss_tpu_torch.data.loader import SyntheticSource
from mdilss_tpu_torch.models.erfnet_ablations import REFERENCE_NAMES
from mdilss_tpu_torch.train import steps

torch.set_num_threads(1)
MODEL = {v: k for k, v in REFERENCE_NAMES.items()}


def _save_both(root, variant: str, params, state) -> tuple[str, str]:
    """The same weights as a JAX Orbax checkpoint directory and as a port
    checkpoint directory; returns (jax_dir, port_dir)."""
    jdir, pdir = str(root / f"jax_{variant}"), str(root / f"port_{variant}")
    orbax_io.save(jdir, 1, jsteps.init_train_state(params, state), best_acc=0.0,
                  rng=jax.random.key(0))
    torch_io.save(pdir, 1, steps.init_train_state(port_model(variant, params, state)),
                  best_acc=0.0, aug_state=torch.Generator().get_state())
    return jdir, pdir


@pytest.mark.parametrize("variant", VARIANTS)
def test_evaluate_export_features_and_predictions_equal_jax(tmp_path, variant):
    """A 2-task checkpoint of `variant` (JAX's Orbax directory, the port's
    directory, the same weights): evaluate_checkpoint in float64 with per-class
    IoU equal to JAX's; export_checkpoint's head 1 (CPU, fp32 logits) within
    1e-5 of JAX's apply; extract_features 1e-5; the prediction maps equal off
    JAX's near-ties (top-2 gap 1e-4)."""
    from PIL import Image

    nc = [20, 27]
    params, state = jax_model(variant, nc, 11)
    jdir, pdir = _save_both(tmp_path, variant, params, state)
    kw = dict(kind=MODEL[variant], datasets=["cityscapes", "IDD"], num_classes=nc,
              synthetic=True, height=32, width=64, compute_dtype="float64",
              return_per_class=True)
    try:
        want, want_pc = jevaluate.evaluate_checkpoint(jdir, **kw)
    finally:
        jax.config.update("jax_enable_x64", False)
    got, got_pc = evaluate.evaluate_checkpoint(pdir, device="cpu", **kw)
    for d in ("cityscapes", "IDD"):
        np.testing.assert_array_equal(got_pc[d], want_pc[d], err_msg=d)
        assert got[d] == want[d]

    apply = A.model_module(variant).apply
    serving.export_checkpoint(pdir, kind=MODEL[variant], out_dir=str(tmp_path / "s"), tasks=[1],
                              height=32, width=64, compute_dtype="float32", platforms=("cpu",))
    x = np.random.default_rng(12).integers(0, 256, (1, 32, 64, 3), np.uint8)
    served, = serving.serve_batches(str(tmp_path / "s"), 1, [x], device="cpu")
    logits = np.asarray(apply(params, state, jnp.asarray(x / 255.0, jnp.float32), 1)[0])
    assert served.shape == logits.shape and rel_l2(served, logits) <= 1e-5

    model = evaluate.load_checkpoint(pdir, kind=MODEL[variant], device="cpu")
    fkw = dict(task=1, num_classes=nc[1], which="penultimate", height=32, width=64,
               select=lambda labels, n: True)
    f_want, l_want, _ = jtsne.extract_features(apply, params, state,
                                               JaxSyntheticSource(nc[1], n=2, height=32, width=64),
                                               **fkw)
    f_got, l_got, _ = tsne.extract_features(model, SyntheticSource(nc[1], n=2, height=32, width=64),
                                            device="cpu", **fkw)
    np.testing.assert_array_equal(l_got, l_want)
    assert rel_l2(f_got, f_want) <= 1e-5

    pkw = dict(task=1, num_classes=nc[1], max_images=2, height=32, width=64)
    p_want = jpredict.save_predictions(apply, params, state,
                                       JaxSyntheticSource(nc[1], n=2, height=32, width=64),
                                       out_dir=str(tmp_path / "jp"), **pkw)
    p_got = predict.save_predictions(model, SyntheticSource(nc[1], n=2, height=32, width=64),
                                     out_dir=str(tmp_path / "pp"), device="cpu", **pkw)
    assert [os.path.basename(p) for p in p_got] == [os.path.basename(p) for p in p_want]
    src = SyntheticSource(nc[1], n=2, height=32, width=64)
    for i, (g, w) in enumerate(zip(p_got, p_want)):
        img, _ = src.decode(i, 32, 64)
        lg = np.asarray(apply(params, state, jnp.asarray(img[None] / 255.0, jnp.float32), 1)[0][0])
        top2 = np.sort(lg, axis=-1)[..., -2:]
        decided = top2[..., 1] - top2[..., 0] > 1e-4
        np.testing.assert_array_equal(np.asarray(Image.open(g))[decided],
                                      np.asarray(Image.open(w))[decided])
