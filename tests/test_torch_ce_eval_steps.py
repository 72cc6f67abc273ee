"""Port of the CE step, the fused eval step and `iou_train`
(mdilss_tpu_torch/train/steps.py `make_ce_step`, `make_eval_step`,
`_train_cm`) against the JAX package's steps on the CPU, on the same weights,
masks and batches (2x32x64). Confusion matrices are held off near-ties
(`_torch_port.cm_near_ties`)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_port import cm_near_ties, port_train_logits, randomize_bn, rel_l2
from mdilss_tpu.models import erfnet_rap
from mdilss_tpu.train import masks as jmasks
from mdilss_tpu.train import steps as jsteps
from mdilss_tpu_torch.ckpt import from_jax
from mdilss_tpu_torch.models import ERFNetRAP
from mdilss_tpu_torch.models.topology import make_dropout_masks
from mdilss_tpu_torch.train import steps
from mdilss_tpu_torch.train.masks import rap_lr_tree

torch.set_num_threads(1)

SHARED_LR, DS_LR = 5e-6, 5e-4
# near-tie pixels (of 4096) where both packages run the same weights: random weights leave
# the top two logits close, and these seeds give 0-5 (the cms then differ nowhere)
MAX_NEAR_TIES = 8


def _weights(rng, c: int) -> np.ndarray:
    w = (rng.random(c) * 5 + 0.5).astype(np.float32)
    w[c - 1] = 0.0  # the void class
    return w


def _train_logits(params, bn, x, task, mask):
    """JAX's training-mode logits of head `task` (the forward the step's cm
    reads), spatial."""
    fwd = jax.jit(lambda p, s, x_, m: erfnet_rap.apply(p, s, x_, task, training=True, rng=None,
                                                       drop_masks=m)[0])
    return np.asarray(fwd(params, bn, jnp.asarray(x), mask))


def test_ce_step_matches_jax():
    """Two CE steps on a 1-task [6] model from the same weights, masks and
    batches, held as the distill step's: step 1's loss 1e-4 and step 2's 1e-3
    relative, running statistics 1e-4 / 5e-3 rel L2, each element within 2 lr
    per step. `iou_train`'s cm: step 1 runs the same weights in both packages,
    and its cm equals JAX's off a handful of near-ties; step 2's forward runs
    weights that already differ by Adam's first-step sign noise (lr * g / |g|
    flips where g is near 0), which moves the logits by ~6% rel L2 here, so it
    is held off the near-ties that noise makes and, exactly, to the argmax of
    the port's own logits."""
    rng = np.random.default_rng(0)
    params, bn = randomize_bn(*erfnet_rap.init(jax.random.key(0), [6], 1), rng)
    w = _weights(rng, 6)
    batches = [(rng.standard_normal((2, 32, 64, 3), dtype=np.float32),
                rng.integers(0, 6, (2, 32, 64)).astype(np.int32),
                make_dropout_masks(rng, 2)) for _ in range(2)]
    jstep = jax.jit(jsteps.make_ce_step(
        erfnet_rap.apply, task=0, class_weight=jnp.asarray(w),
        lr_tree=jmasks.rap_lr_tree(params, current_task=0, shared_lr=DS_LR, ds_lr=DS_LR),
        num_epochs=150, iou_train=True))
    jts = jsteps.init_train_state(params, bn)

    model = ERFNetRAP([6], 1, device="cpu")
    model.load_state_dict(from_jax(params, bn), strict=True)
    lr = rap_lr_tree(model, current_task=0, shared_lr=DS_LR, ds_lr=DS_LR)
    step = steps.make_ce_step(task=0, class_weight=w, lr_tree=lr, num_epochs=150, iou_train=True)
    ts = steps.init_train_state(model)
    ties = []
    for i, (x, y, mk) in enumerate(batches):
        logits = _train_logits(jts.params, jts.bn, x, 0, mk)
        plogits = port_train_logits(model, x, 0, mk)
        jts, jm = jstep(jts, jnp.asarray(x), jnp.asarray(y), mk, None, 1)
        ts, m = step(ts, torch.from_numpy(x), torch.from_numpy(y).long(), mk, 1)
        assert set(m) == {"loss", "ce", "cm"} and ts.opt.count == i + 1
        tol_loss, tol_bn = (1e-4, 1e-4) if i == 0 else (1e-3, 5e-3)
        for k in ("loss", "ce"):
            assert np.isfinite(float(m[k]))
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=tol_loss, err_msg=k)
        assert m["cm"].dtype == torch.int64 and m["cm"].shape == (6, 6)
        ties.append(cm_near_ties(m["cm"], jm["cm"], logits, plogits, y))
        if i == 1:  # the cm is the argmax of the port's own logits, exactly
            np.testing.assert_array_equal(m["cm"].numpy(), np.bincount(
                y.reshape(-1) * 6 + plogits.argmax(-1).reshape(-1), minlength=36).reshape(6, 6))
        want = from_jax(jts.params, jts.bn)
        got = model.state_dict()
        for k, v in want.items():
            if "num_batches_tracked" in k:
                continue
            g, v = got[k].numpy(), v.numpy()
            if "running" in k:
                assert rel_l2(g, v) <= tol_bn, k
            else:
                np.testing.assert_allclose(g, v, atol=2 * (i + 1) * lr[k] + 1e-6, err_msg=k)
    assert ties[0] <= MAX_NEAR_TIES


def test_ce_step_without_iou_train_and_no_dropout():
    rng = np.random.default_rng(1)
    model = ERFNetRAP([6], 1, device="cpu")
    lr = rap_lr_tree(model, current_task=0, shared_lr=DS_LR, ds_lr=DS_LR)
    step = steps.make_ce_step(task=0, class_weight=np.ones(6, np.float32), lr_tree=lr,
                              num_epochs=150)
    x = torch.from_numpy(rng.standard_normal((2, 32, 64, 3), dtype=np.float32))
    y = torch.from_numpy(rng.integers(0, 6, (2, 32, 64)))
    ts, m = step(steps.init_train_state(model), x, y, None, 1)
    assert set(m) == {"loss", "ce"} and np.isfinite(float(m["loss"])) and ts.opt.count == 1


@pytest.mark.parametrize("task", [0, 1, 2])
def test_eval_step_matches_jax(task):
    """The eval step of every head of a [6, 6, 8] model: loss 1e-5 relative
    (float32 sums in another order), cm as the module docstring says; the
    labels are prepared ones, the void class (weight 0) among them. No
    near-ties beyond a handful at this seed."""
    classes = [6, 6, 8]
    rng = np.random.default_rng(2)
    params, bn = randomize_bn(*erfnet_rap.init(jax.random.key(2), classes, 3), rng)
    nc = classes[task]
    w = _weights(rng, nc)
    x = rng.standard_normal((2, 32, 64, 3), dtype=np.float32)
    y = rng.integers(0, nc, (2, 32, 64)).astype(np.int32)
    y[0, :5] = nc - 1
    jstep = jax.jit(jsteps.make_eval_step(erfnet_rap.apply, task=task,
                                          class_weight=jnp.asarray(w), num_classes=nc))
    jloss, jcm = jstep(params, bn, jnp.asarray(x), jnp.asarray(y))
    logits = np.asarray(jax.jit(lambda p, s, x_: erfnet_rap.apply(p, s, x_, task)[0])(
        params, bn, jnp.asarray(x)))

    model = ERFNetRAP(classes, 3, device="cpu")
    model.load_state_dict(from_jax(params, bn), strict=True)
    with torch.no_grad():
        plogits = model(torch.from_numpy(x), task).numpy()
    model.train()
    step = steps.make_eval_step(task=task, class_weight=w, num_classes=nc)
    loss, cm = step(model, torch.from_numpy(x), torch.from_numpy(y))
    assert not model.training and loss.shape == () and cm.shape == (nc, nc)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    assert cm_near_ties(cm, jcm, logits, plogits, y) <= MAX_NEAR_TIES


def test_distill_step_iou_train_matches_jax():
    """`make_distill_step(iou_train=True)`'s cm from the current-task logits,
    against JAX's, on the step-2 setting of test_torch_train_step.py."""
    rng = np.random.default_rng(3)
    params, bn = randomize_bn(*erfnet_rap.init(jax.random.key(0), [6, 6], 2), rng)
    tparams, tbn = randomize_bn(*erfnet_rap.init(jax.random.key(1), [6], 1), rng)
    w = _weights(rng, 6)
    x = rng.standard_normal((2, 32, 64, 3), dtype=np.float32)
    y = rng.integers(0, 6, (2, 32, 64)).astype(np.int32)
    mks = [make_dropout_masks(rng, 2) for _ in range(2)]
    jstep = jax.jit(jsteps.make_distill_step(
        erfnet_rap.apply, current_task=1, prev_tasks=(0,), class_weight=jnp.asarray(w),
        lr_tree=jmasks.rap_lr_tree(params, current_task=1, shared_lr=SHARED_LR, ds_lr=DS_LR),
        num_epochs=150, remat_prev=False, iou_train=True))
    _, jm = jstep(jsteps.init_train_state(params, bn), jsteps.ModelState(tparams, tbn),
                  jnp.asarray(x), jnp.asarray(y), mks, None, 1)
    logits = _train_logits(params, bn, x, 1, mks[0])

    student = ERFNetRAP([6, 6], 2, device="cpu")
    student.load_state_dict(from_jax(params, bn), strict=True)
    teacher = ERFNetRAP([6], 1, device="cpu")
    teacher.load_state_dict(from_jax(tparams, tbn), strict=True)
    lr = rap_lr_tree(student, current_task=1, shared_lr=SHARED_LR, ds_lr=DS_LR)
    step = steps.make_distill_step(current_task=1, prev_tasks=(0,), class_weight=w, lr_tree=lr,
                                   num_epochs=150, iou_train=True)
    plogits = port_train_logits(student, x, 1, mks[0])
    _, m = step(steps.init_train_state(student), teacher, torch.from_numpy(x),
                torch.from_numpy(y).long(), mks, 1)
    assert set(m) == {"loss", "ce", "kld", "cm"}
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-4)
    assert cm_near_ties(m["cm"], jm["cm"], logits, plogits, y) <= MAX_NEAR_TIES
