"""Port of step 3's two-phase distillation step
(mdilss_tpu_torch/train/steps.py `make_two_phase_distill_step`) against the
JAX package's `make_two_phase_distill_step` on the CPU, on the same weights,
masks and batches: student ERFNet-RAP [6, 6, 6] at task 2 with previous tasks
(1, 0), teacher [6, 6], 2x32x64 batches."""
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
from mdilss_tpu_torch.train import optim, steps
from mdilss_tpu_torch.train.masks import rap_lr_tree

torch.set_num_threads(1)

SHARED_LR, DS_LR = 5e-6, 5e-4
STUDENT, TEACHER = [6, 6, 6], [6, 6]
CUR, PREV = 2, (1, 0)
WD = 1e-4


def _setup(seed: int = 0):
    """JAX weights with random BN for the student and the teacher, the class
    weights (the last class weight 0, as the void class), and the port's
    student and teacher loaded from them."""
    rng = np.random.default_rng(seed)
    params, bn = randomize_bn(*erfnet_rap.init(jax.random.key(0), STUDENT, 3), rng)
    tparams, tbn = randomize_bn(*erfnet_rap.init(jax.random.key(1), TEACHER, 2), rng)
    w = (rng.random(6) * 5 + 0.5).astype(np.float32)
    w[5] = 0.0
    student = ERFNetRAP(STUDENT, 3, device="cpu")
    student.load_state_dict(from_jax(params, bn), strict=True)
    teacher = ERFNetRAP(TEACHER, 2, device="cpu")
    teacher.load_state_dict(from_jax(tparams, tbn), strict=True)
    return rng, (params, bn, tparams, tbn), w, student, teacher


def _batch(rng, n_masks: int):
    return (rng.standard_normal((2, 32, 64, 3), dtype=np.float32),
            rng.integers(0, 6, (2, 32, 64)).astype(np.int32),
            [make_dropout_masks(rng, 2) for _ in range(n_masks)])


def _buffers(module) -> dict:
    return {k: v.clone() for k, v in module.named_buffers()}


def _port_step(student, w, **kw):
    lr = rap_lr_tree(student, current_task=CUR, shared_lr=SHARED_LR, ds_lr=DS_LR)
    step = steps.make_two_phase_distill_step(current_task=CUR, prev_tasks=PREV, class_weight=w,
                                             lr_tree=lr, num_epochs=150, **kw)
    return lr, step


@pytest.mark.parametrize("mode,n_batches", [("train_teacher", 2), ("eval_teacher", 1),
                                            ("teacher_dropout", 1)])
def test_two_phase_step_matches_jax(mode, n_batches):
    """Each batch is two Adam steps, and every Adam step carries its
    first-step sign noise (lr * g / |g| flips where g is near 0, and this
    BN+relu stack's gradient at random weights is chaotic: see
    test_torch_train_step.py). Held as the distill step's steps: batch 1's
    losses at 1e-4 relative and running statistics at 1e-4 rel L2 (measured
    1.7e-6 and 5.5e-7), batch 2's at 1e-3 and 5e-3 (measured 4.8e-6 and
    3.7e-5), each trained element within 2 lr per Adam step taken (measured
    1.9 lr after 2, 3.1 lr after 4); `iou_train`'s cm off near-ties
    (`_torch_port.cm_near_ties`), the CE phase of batch 1 running the same
    weights in both packages. Frozen parameters (tasks 0 and 1's slices and
    decoders) are bitwise JAX's and their initial values; the teacher's
    parameters and buffers are bitwise unchanged and its mode restored."""
    kw = {"train_teacher": {}, "eval_teacher": {"teacher_training": False},
          "teacher_dropout": {"teacher_dropout": True}}[mode] | {"iou_train": True}
    n_masks = 1 + len(PREV) * (2 if mode == "teacher_dropout" else 1)
    rng, (params, bn, tparams, tbn), w, student, teacher = _setup()
    batches = [_batch(rng, n_masks) for _ in range(n_batches)]

    jstep = jax.jit(jsteps.make_two_phase_distill_step(
        erfnet_rap.apply, current_task=CUR, prev_tasks=PREV, class_weight=jnp.asarray(w),
        lr_tree=jmasks.rap_lr_tree(params, current_task=CUR, shared_lr=SHARED_LR, ds_lr=DS_LR),
        num_epochs=150, **kw))
    jts = jsteps.init_train_state(params, bn)
    jteacher = jsteps.ModelState(tparams, tbn)

    lr, step = _port_step(student, w, **kw)
    ts = steps.init_train_state(student)
    init = from_jax(params, bn)
    teacher_before = _buffers(teacher)
    teacher_params = {k: p.detach().clone() for k, p in teacher.named_parameters()}

    jfwd = jax.jit(lambda p, s_, x_, mk: erfnet_rap.apply(p, s_, x_, CUR, training=True, rng=None,
                                                         drop_masks=mk)[0])
    for i, (x, y, mks) in enumerate(batches):
        logits = np.asarray(jfwd(jts.params, jts.bn, jnp.asarray(x), mks[0]))
        plogits = port_train_logits(student, x, CUR, mks[0])
        jts, jm = jstep(jts, jteacher, jnp.asarray(x), jnp.asarray(y), mks, None, 1)
        ts, m = step(ts, teacher, torch.from_numpy(x), torch.from_numpy(y).long(), mks, 1)
        n_adam = 2 * (i + 1)
        tol_loss, tol_bn = (1e-4, 1e-4) if i == 0 else (1e-3, 5e-3)
        assert ts.opt.count == int(jts.opt.count) == n_adam
        for k in ("loss", "ce", "kld"):
            assert np.isfinite(float(m[k]))
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=tol_loss, err_msg=k)
        ties = cm_near_ties(m["cm"], jm["cm"], logits, plogits, y)
        assert i > 0 or ties <= 8  # batch 1: the same weights; a handful of near-ties at most
        want = from_jax(jts.params, jts.bn)
        got = student.state_dict()
        for k, v in want.items():
            if "num_batches_tracked" in k:
                continue
            g, v = got[k].numpy(), v.numpy()
            if "running" in k:
                assert rel_l2(g, v) <= tol_bn, k
            elif lr[k] == 0.0:
                np.testing.assert_array_equal(g, v, err_msg=k)
                np.testing.assert_array_equal(g, init[k].numpy(), err_msg=k)
            else:
                np.testing.assert_allclose(g, v, atol=2 * n_adam * lr[k] + 1e-6, err_msg=k)
        after = dict(teacher.named_buffers())
        assert all(torch.equal(after[k], v) for k, v in teacher_before.items())
        assert all(torch.equal(p, teacher_params[k]) for k, p in teacher.named_parameters())
        assert not teacher.training  # its mode restored


def test_two_phase_step_rejects_bad_masks_and_options():
    _, _, w, student, teacher = _setup()
    with pytest.raises(ValueError, match="teacher_training"):
        _port_step(student, w, teacher_dropout=True, teacher_training=False)
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((2, 32, 64, 3), dtype=np.float32))
    y = torch.from_numpy(rng.integers(0, 6, (2, 32, 64)))
    _, step = _port_step(student, w, teacher_dropout=True)
    ts = steps.init_train_state(student)
    for masks in ([make_dropout_masks(rng, 2) for _ in range(3)],  # the student's only
                  [make_dropout_masks(rng, 2) for _ in range(6)],
                  make_dropout_masks(rng, 2),  # one dict: JAX would reuse it for the teacher
                  None):
        with pytest.raises(ValueError, match="dropout-mask dicts"):
            step(ts, teacher, x, y, masks, 1)
    _, step = _port_step(student, w)
    with pytest.raises(ValueError, match="dropout-mask dicts"):
        step(ts, teacher, x, y, [make_dropout_masks(rng, 2) for _ in range(2)], 1)
    assert ts.opt.count == 0  # nothing ran


def test_phase_two_moves_parameters_it_gives_no_gradient():
    """The KD phase reaches no parameter of the current task (its slices and
    decoder): their gradient is None, and Adam still moves them in phase 2
    by its moments and weight decay, as the JAX package's zero gradient
    does. Pinned exactly: the two-phase step equals phase 1 and phase 2 run
    by hand, and phase 2 moves every current-task parameter."""
    rng, _, w, student, teacher = _setup()
    x, y, mks = _batch(rng, 3)
    x, y = torch.from_numpy(x), torch.from_numpy(y).long()
    twin = ERFNetRAP(STUDENT, 3, device="cpu")
    twin.load_state_dict(student.state_dict())

    lr, step = _port_step(student, w)
    ts, _ = step(steps.init_train_state(student), teacher, x, y, mks, 1)

    params = dict(twin.named_parameters())
    weight = torch.from_numpy(w)
    _, _, g1 = steps.ce_loss_and_grads(twin, x, y, mks[0], task=CUR, class_weight=weight)
    opt = optim.apply_updates(params, g1, optim.init(params), lr, lr_scale=1.0, weight_decay=WD)
    p1 = {k: p.detach().clone() for k, p in params.items()}
    _, _, g2 = steps.kd_loss_and_grads(twin, teacher, x, mks[1:], prev_tasks=PREV)
    current = [k for k in params if lr[k] == DS_LR]  # the current task's slices and decoder
    assert current and all(g2[k] is None for k in current)
    assert all(g2[k] is not None for k in params if lr[k] > 0 and k not in current
               and "conv1x3" not in k)  # the pre-BN biases the batch mean absorbs: None
    optim.apply_updates(params, g2, opt, lr, lr_scale=1.0, weight_decay=WD)
    for k, p in params.items():
        assert torch.equal(p, dict(student.named_parameters())[k]), k
    for k in current:
        assert not torch.equal(params[k], p1[k]), k  # phase 2 moved it
    assert ts.opt.count == 2
