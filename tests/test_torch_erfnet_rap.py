"""Port of ERFNet-RAP (mdilss_tpu_torch/models) against the JAX package: the
weight bridge reproduces the reference-grammar export bit for bit and loads
strictly, and eval logits of every head match erfnet_rap.apply."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_port import randomize_bn, rel_l2
from mdilss_tpu.ckpt import export_state_dict
from mdilss_tpu.models import erfnet_rap
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


def test_training_mode_raises(models):
    _, _, model = models
    model.train()
    try:
        with pytest.raises(NotImplementedError):
            model(torch.zeros(1, 32, 64, 3), 0)
    finally:
        model.eval()
