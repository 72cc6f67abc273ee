"""Port of ERFNet-RAP (mdilss_tpu_torch/models) against the JAX package: the
weight bridge reproduces the reference-grammar export bit for bit and loads
strictly, eval logits of every head match erfnet_rap.apply, and so do the
training-mode logits and updated BN running statistics; the port imports
neither JAX nor the JAX package."""
import copy
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_port import randomize_bn, rel_l2
from mdilss_tpu.ckpt import export_state_dict
from mdilss_tpu.models import erfnet_rap
from mdilss_tpu.models.topology import make_dropout_masks
from mdilss_tpu_torch.ckpt import from_jax
from mdilss_tpu_torch.models import ERFNetRAP

torch.set_num_threads(1)

NUM_CLASSES = [20, 20, 27]


@pytest.fixture(scope="module")
def models():
    params, state = erfnet_rap.init(jax.random.key(0), NUM_CLASSES, 3)
    params, state = randomize_bn(params, state, np.random.default_rng(0))
    model = ERFNetRAP(NUM_CLASSES, 3, device="cpu")
    model.load_state_dict(from_jax(params, state), strict=True)
    return params, state, model


def test_from_jax_equals_reference_export_and_loads_strict(models):
    params, state, _ = models
    got = from_jax(params, state)
    want = export_state_dict(params, state, kind="rap")
    assert set(got) == set(want)
    for k, v in want.items():
        g = got[k].numpy()
        assert g.dtype == v.dtype and g.shape == v.shape, k
        np.testing.assert_array_equal(g, v, err_msg=k)
    fresh = ERFNetRAP(NUM_CLASSES, 3, device="cpu")
    assert set(fresh.state_dict()) == set(want)
    fresh.load_state_dict(got, strict=True)
    # sample keys of the reference grammar
    for k in ("encoder.initial_block.bn_ini.2.running_var",
              "encoder.layers.14.parallel_conv_2.1.weight", "encoder.layers.9.bns_1.0.bias",
              "decoder.2.layers.5.conv1x3_2.weight", "decoder.1.output_conv.bias"):
        assert k in want


@pytest.mark.parametrize("task", [0, 1, 2])
def test_eval_logits_match_jax(models, task):
    params, state, model = models
    x = np.random.default_rng(task).random((2, 64, 128, 3), dtype=np.float32)
    want = np.asarray(erfnet_rap.apply(params, state, jnp.asarray(x), task, training=False)[0])
    got = model(torch.from_numpy(x), task).numpy()
    assert got.shape == (2, 64, 128, NUM_CLASSES[task]) and got.dtype == np.float32
    assert rel_l2(got, want) <= 1e-5
    # labels agree except on top-2 near-ties
    top2 = np.sort(want, axis=-1)[..., -2:]
    decided = (top2[..., 1] - top2[..., 0]) >= 1e-4
    np.testing.assert_array_equal(got.argmax(-1)[decided], want.argmax(-1)[decided])


def test_train_forward_matches_jax(models):
    """Training mode, head 1, the same host dropout masks: logits and the
    updated running statistics of every BN (relative L2; batch-statistics BN
    through ~40 layers, the port's var is E[y^2] - E[y]^2 in the nb1d blocks)."""
    params, state, model = models
    model = copy.deepcopy(model).train()  # the fixture's buffers stay as they are
    rng = np.random.default_rng(7)
    x = rng.random((2, 64, 128, 3), dtype=np.float32)
    masks = make_dropout_masks(rng, 2)
    want, new_state = erfnet_rap.apply(params, state, jnp.asarray(x), 1, training=True,
                                       drop_masks=masks)
    got = model(torch.from_numpy(x), 1, masks)
    assert got.requires_grad and got.shape == (2, 64, 128, NUM_CLASSES[1])
    assert rel_l2(got.detach().numpy(), np.asarray(want)) <= 1e-4
    want_sd = from_jax(params, new_state)
    got_sd = model.state_dict()
    running = [k for k in want_sd if "running" in k]
    changed = [k for k in running if not torch.equal(want_sd[k], from_jax(params, state)[k])]
    # only head 1's decoder and the encoder's task-1 slices move
    assert changed and all(k.startswith("decoder.1.") or ".1.running_" in k for k in changed)
    for k in running:
        assert rel_l2(got_sd[k].numpy(), want_sd[k].numpy()) <= 1e-4, k


def test_port_imports_neither_jax_nor_the_jax_package():
    code = (
        "import importlib, pkgutil, sys\n"
        "import mdilss_tpu_torch as P\n"
        "for m in pkgutil.walk_packages(P.__path__, 'mdilss_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in ('jax', 'mdilss_tpu'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    root = Path(__file__).resolve().parents[1]
    out = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
