"""Port of the step-2 training path (mdilss_tpu_torch/losses.py, train/optim.py,
train/masks.py, train/steps.py, models/topology.py dropout masks,
ckpt/convert.py params_from_jax) against the JAX package on the CPU, on the
same weights, masks and batches."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_port import randomize_bn, rel_l2
from mdilss_tpu import losses as jlosses
from mdilss_tpu.models import erfnet_rap
from mdilss_tpu.models import topology as jtopo
from mdilss_tpu.train import masks as jmasks
from mdilss_tpu.train import optim as joptim
from mdilss_tpu.train import steps as jsteps
from mdilss_tpu_torch import losses
from mdilss_tpu_torch.ckpt import from_jax, params_from_jax
from mdilss_tpu_torch.models import ERFNetRAP
from mdilss_tpu_torch.models import topology
from mdilss_tpu_torch.train import optim, steps
from mdilss_tpu_torch.train.masks import rap_lr_tree

torch.set_num_threads(1)

SHARED_LR, DS_LR = 5e-6, 5e-4


@pytest.mark.parametrize("name", ["weighted_cross_entropy", "kld_faithful", "kld_corrected"])
def test_losses_match_jax(name):
    rng = np.random.default_rng(1)
    c = 6
    a = (rng.normal(size=(2, 8, 16, c)) * 3).astype(np.float32)
    b = (rng.normal(size=(2, 8, 16, c)) * 3).astype(np.float32)
    b[0, :4, :, 2] = -1e4  # teacher probabilities exactly 0: 0 * log 0 = 0
    if name == "weighted_cross_entropy":
        t = rng.integers(0, c, (2, 8, 16)).astype(np.int32)
        t[1, :3] = c - 1  # the ignore class, weight 0
        w = (rng.random(c) * 5 + 0.5).astype(np.float32)
        w[c - 1] = 0.0
        want = jlosses.weighted_cross_entropy(jnp.asarray(a), jnp.asarray(t), jnp.asarray(w))
        got = losses.weighted_cross_entropy(torch.from_numpy(a), torch.from_numpy(t).long(),
                                            torch.from_numpy(w))
    else:
        want = getattr(jlosses, name)(jnp.asarray(a), jnp.asarray(b))
        got = getattr(losses, name)(torch.from_numpy(a), torch.from_numpy(b))
    assert np.isfinite(float(got))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)  # f32 sums in another order


def test_adam_matches_jax_and_lr_zero_freezes_exactly():
    rng = np.random.default_rng(2)
    shapes = {"a": (3, 4), "b": (5,), "frozen": (2, 2)}  # sorted: JAX's flat order too
    lr = {"a": DS_LR, "b": SHARED_LR, "frozen": 0.0}
    p0 = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    js = joptim.init(jp)
    tp = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    ts = optim.init(tp)
    for epoch in (1, 2, 3):
        g = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
        jp, js = joptim.apply_updates(
            jp, {k: jnp.asarray(v) for k, v in g.items()}, js,
            {k: np.float32(v) for k, v in lr.items()},
            lr_scale=joptim.poly_lr_factor(epoch, 150), weight_decay=1e-4)
        ts = optim.apply_updates(tp, {k: torch.from_numpy(v) for k, v in g.items()}, ts, lr,
                                 lr_scale=optim.poly_lr_factor(epoch, 150), weight_decay=1e-4)
        for k in shapes:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=1e-6, atol=1e-9)
        np.testing.assert_allclose(ts.m.numpy(), np.asarray(js.m), rtol=1e-5, atol=1e-12)
        np.testing.assert_allclose(ts.v.numpy(), np.asarray(js.v), rtol=1e-5, atol=1e-12)
    assert ts.count == int(js.count) == 3
    np.testing.assert_array_equal(tp["frozen"].numpy(), p0["frozen"])
    assert not ts.m[-4:].any() and not ts.v[-4:].any()  # the frozen tail: moments exactly 0
    assert optim.poly_lr_factor(1, 150) == 1.0
    assert optim.poly_lr_factor(76, 150) == pytest.approx(float(joptim.poly_lr_factor(76, 150)))


def test_params_from_jax_equals_parameter_entries_of_from_jax():
    params, state = erfnet_rap.init(jax.random.key(0), [6, 6], 2)
    got = params_from_jax(params)
    full = from_jax(params, state)
    model = ERFNetRAP([6, 6], 2, device="cpu")
    names = {k for k, _ in model.named_parameters()}
    assert set(got) == names
    for k in names:
        assert torch.equal(got[k], full[k]), k


@pytest.mark.parametrize("classes,current_task", [([6, 6], 1), ([6, 6, 6], 1), ([6, 6, 6], 2)])
def test_rap_lr_tree_matches_jax(classes, current_task):
    n = len(classes)
    params, _ = erfnet_rap.init(jax.random.key(0), classes, n)
    jl = jmasks.rap_lr_tree(params, current_task=current_task, shared_lr=SHARED_LR, ds_lr=DS_LR)
    want = params_from_jax(jax.tree.map(
        lambda lr, p: np.broadcast_to(np.asarray(lr, np.float32), p.shape), jl, params))
    got = rap_lr_tree(ERFNetRAP(classes, n, device="cpu"), current_task=current_task,
                      shared_lr=SHARED_LR, ds_lr=DS_LR)
    assert set(got) == set(want)
    for k, v in want.items():
        v = v.numpy()
        assert (v == v.flat[0]).all(), k
        assert np.float32(got[k]) == v.flat[0], k
    for t in range(n):
        lr_t = DS_LR if t == current_task else 0.0
        assert got[f"encoder.layers.3.parallel_conv_2.{t}.weight"] == lr_t
        assert got[f"encoder.initial_block.bn_ini.{t}.bias"] == lr_t
        assert got[f"decoder.{t}.output_conv.bias"] == lr_t
        assert got[f"decoder.{t}.layers.2.bn1.weight"] == lr_t
    assert got["encoder.layers.3.conv1x3_2.bias"] == SHARED_LR


def test_dropout_masks_match_jax_draws():
    want = jtopo.make_dropout_masks(np.random.default_rng(3), 2)
    got = topology.make_dropout_masks(np.random.default_rng(3), 2)
    assert topology.dropout_mask_shapes(2) == jtopo.dropout_mask_shapes(2)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    per_layer = topology.layer_drop_masks(got, "cpu")
    assert sorted(per_layer) == [1, 2, 3, 4, 5] + list(range(7, 15))
    np.testing.assert_array_equal(per_layer[3].numpy(), got["g64"][2].reshape(2, 64))
    np.testing.assert_array_equal(per_layer[13].numpy(), got["g128"][1, 2].reshape(2, 128))


def test_distill_step_matches_jax():
    """Two step-2 steps ([6,6] student, [6] teacher, 2x32x64) from the same
    weights, masks and batches. Step 1 is tight. The second step starts from
    parameters that differ by Adam's first-step sign noise: lr * g / |g|
    flips wherever g + wd*p is near 0, and the gradient of this deep BN+relu
    stack at a 4x8 encoder map is chaotic (the JAX package's own gradient
    moves by ~5% relative L2 under a 1e-6 relative parameter perturbation),
    so step 2's losses and running statistics carry that noise."""
    rng = np.random.default_rng(0)
    params, bn = randomize_bn(*erfnet_rap.init(jax.random.key(0), [6, 6], 2), rng)
    tparams, tbn = randomize_bn(*erfnet_rap.init(jax.random.key(1), [6], 1), rng)
    w = (rng.random(6) * 5 + 0.5).astype(np.float32)
    w[5] = 0.0
    batches = [(rng.standard_normal((2, 32, 64, 3), dtype=np.float32),
                rng.integers(0, 6, (2, 32, 64)).astype(np.int32),
                [topology.make_dropout_masks(rng, 2) for _ in range(2)]) for _ in range(2)]

    jstep = jax.jit(jsteps.make_distill_step(
        erfnet_rap.apply, current_task=1, prev_tasks=(0,), class_weight=jnp.asarray(w),
        lr_tree=jmasks.rap_lr_tree(params, current_task=1, shared_lr=SHARED_LR, ds_lr=DS_LR),
        num_epochs=150, remat_prev=False))
    jts = jsteps.init_train_state(params, bn)
    jteacher = jsteps.ModelState(tparams, tbn)

    student = ERFNetRAP([6, 6], 2, device="cpu")
    student.load_state_dict(from_jax(params, bn), strict=True)
    teacher = ERFNetRAP([6], 1, device="cpu")
    teacher.load_state_dict(from_jax(tparams, tbn), strict=True)
    lr = rap_lr_tree(student, current_task=1, shared_lr=SHARED_LR, ds_lr=DS_LR)
    step = steps.make_distill_step(current_task=1, prev_tasks=(0,), class_weight=w, lr_tree=lr,
                                   num_epochs=150)
    ts = steps.init_train_state(student)
    init = from_jax(params, bn)

    for i, (x, y, mks) in enumerate(batches):
        jts, jm = jstep(jts, jteacher, jnp.asarray(x), jnp.asarray(y), mks, None, 1)
        ts, m = step(ts, teacher, torch.from_numpy(x), torch.from_numpy(y).long(), mks, 1)
        n_steps = i + 1
        tol_loss, tol_bn = (1e-4, 1e-4) if n_steps == 1 else (1e-3, 5e-3)
        for k in ("loss", "ce", "kld"):
            assert np.isfinite(float(m[k]))
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=tol_loss, err_msg=k)
        want = from_jax(jts.params, jts.bn)
        got = student.state_dict()
        for k, v in want.items():
            if "num_batches_tracked" in k:
                continue
            g, v = got[k].numpy(), v.numpy()
            if "running" in k:
                assert rel_l2(g, v) <= tol_bn, k
            elif lr[k] == 0.0:  # frozen: the old task's slices and decoder
                np.testing.assert_array_equal(g, v, err_msg=k)
                np.testing.assert_array_equal(g, init[k].numpy(), err_msg=k)
            else:  # each step moves an element by at most ~lr: sign noise
                np.testing.assert_allclose(g, v, atol=2 * n_steps * lr[k] + 1e-6, err_msg=k)
