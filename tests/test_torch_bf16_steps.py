"""The bf16 train steps of ERFNet-RAP against the JAX package's on the CPU
(a file of its own beside test_torch_bf16_train.py: most of its time is JAX
compiling): one step-2 step and one two-phase step-3 step, the port's with
`compute_dtype="bfloat16"` (its kernels as their plain versions), JAX's
`make_distill_step` / `make_two_phase_distill_step` with a bf16 `apply_fn`
as its Trainer makes it (mdilss_tpu/train/loop.py:267-276), from the same
bf16-valued weights (JAX's init, random BN), batch and dropout masks.

Held to the error budget of `_torch_port.within_budget` against the port's
float64 plain path taking the same step (the same phases and Adam steps on
its own gradients): the losses (BF16_EPS_LOSS), the updated running
statistics, and every trained parameter's move divided by its LR; besides,
every frozen parameter bitwise unchanged, every trained one within 2 lr per
Adam step of JAX's, the teacher unchanged, and the parameters, Adam's state
and the losses float32."""
import copy

import numpy as np
import torch

import jax
import jax.numpy as jnp

from _torch_port import (BF16_EPS_LOSS, bf16_exact, bf16_exact_tree, lr_moves, randomize_bn,
                         within_budget)
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
ADAM = dict(lr_scale=optim.poly_lr_factor(1, 150), weight_decay=1e-4)


def _rap_models(classes, seed, rng):
    """JAX's (params, bn) with random BN and bf16 weight values, and the port's
    ERFNetRAP holding them."""
    params, bn = randomize_bn(*erfnet_rap.init(jax.random.key(seed), list(classes),
                                               len(classes)), rng)
    params = bf16_exact_tree(params)
    model = ERFNetRAP(list(classes), len(classes), device="cpu")
    model.load_state_dict(from_jax(params, bn), strict=True)
    return params, bn, model


def _apply_bf16(p, s, x, task, **kw):
    """JAX's bf16 forward, as its Trainer's apply_fn casts x."""
    return erfnet_rap.apply(p, s, x.astype(jnp.bfloat16), task, **kw)


def _batch(rng, n_masks: int):
    w = (rng.random(6) * 5 + 0.5).astype(np.float32)
    w[5] = 0.0
    x = bf16_exact(rng.random((2, 32, 64, 3)))
    y = rng.integers(0, 6, (2, 32, 64)).astype(np.int32)
    return w, x, y, [make_dropout_masks(rng, 2) for _ in range(n_masks)]


def _running(model, state: dict | None = None) -> np.ndarray:
    return np.concatenate([(b if state is None else state[k]).double().numpy().ravel()
                           for k, b in model.named_buffers() if "running" in k])


def _compare(tag, model, m64, before, jts, lr, metrics, jm, ref_losses) -> None:
    """The budget on the losses, the running statistics and the LR-normalised
    moves; frozen parameters bitwise, trained ones within 2 lr per Adam step
    of JAX's."""
    want = from_jax(jts.params, jts.bn)
    for k, v in ref_losses.items():
        assert metrics[k].dtype == torch.float32
        within_budget(f"{tag} {k}", float(metrics[k]), float(jm[k]), float(v), eps=BF16_EPS_LOSS)
    within_budget(f"{tag} running stats", _running(model), _running(model, want), _running(m64))
    within_budget(f"{tag} moves / lr", lr_moves(model, before, lr),
                  lr_moves(model, before, lr, want), lr_moves(model, before, lr,
                                                              dict(m64.named_parameters())))
    n_adam, got = int(jts.opt.count), model.state_dict()
    for k, p in model.named_parameters():
        assert p.dtype == torch.float32
        if lr[k] == 0.0:
            assert torch.equal(got[k], before[k]) and torch.equal(got[k], want[k]), k
        else:
            np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=0,
                                       atol=2 * n_adam * lr[k] + 1e-6, err_msg=k)


def test_bf16_distill_step_within_budget_of_jax():
    """One step-2 step: [6, 6] student at task 1, [6] eval-mode teacher,
    2x32x64."""
    rng = np.random.default_rng(0)
    params, bn, student = _rap_models([6, 6], 0, rng)
    tparams, tbn, teacher = _rap_models([6], 1, rng)
    w, x, y, mks = _batch(rng, 2)
    s64, t64 = copy.deepcopy(student).double(), copy.deepcopy(teacher).double()
    before = {k: v.clone() for k, v in student.state_dict().items()}

    jstep = jax.jit(jsteps.make_distill_step(
        _apply_bf16, current_task=1, prev_tasks=(0,), class_weight=jnp.asarray(w),
        lr_tree=jmasks.rap_lr_tree(params, current_task=1, shared_lr=SHARED_LR, ds_lr=DS_LR),
        num_epochs=150, remat_prev=False))
    jts, jm = jstep(jsteps.init_train_state(params, bn), jsteps.ModelState(tparams, tbn),
                    jnp.asarray(x), jnp.asarray(y), mks, None, 1)

    lr = rap_lr_tree(student, current_task=1, shared_lr=SHARED_LR, ds_lr=DS_LR)
    step = steps.make_distill_step(current_task=1, prev_tasks=(0,), class_weight=w, lr_tree=lr,
                                   num_epochs=150, compute_dtype="bfloat16")
    xt, yt = torch.from_numpy(x), torch.from_numpy(y).long()
    ts, m = step(steps.init_train_state(student), teacher, xt, yt, mks, 1)
    assert ts.opt.m.dtype == torch.float32 and ts.opt.count == 1

    loss, ce, kld, grads, _ = steps.distill_loss_and_grads(
        s64, t64, xt.double(), yt, mks, current_task=1, prev_tasks=(0,),
        class_weight=torch.from_numpy(w), lambda_c=0.1)
    params64 = dict(s64.named_parameters())
    optim.apply_updates(params64, grads, optim.init(params64), lr, **ADAM)
    _compare("step2", student, s64, before, jts, lr, m, jm, {"loss": loss, "ce": ce, "kld": kld})


def test_bf16_two_phase_step_within_budget_of_jax():
    """One step-3 step: [6, 6, 6] student at task 2, train-mode [6, 6]
    teacher, two phases (two Adam steps), 2x32x64; the teacher bitwise
    unchanged."""
    rng = np.random.default_rng(1)
    params, bn, student = _rap_models([6, 6, 6], 2, rng)
    tparams, tbn, teacher = _rap_models([6, 6], 3, rng)
    w, x, y, mks = _batch(rng, 3)
    s64, t64 = copy.deepcopy(student).double(), copy.deepcopy(teacher).double()
    before = {k: v.clone() for k, v in student.state_dict().items()}
    t_before = {k: v.clone() for k, v in teacher.state_dict().items()}

    jstep = jax.jit(jsteps.make_two_phase_distill_step(
        _apply_bf16, current_task=2, prev_tasks=(1, 0), class_weight=jnp.asarray(w),
        lr_tree=jmasks.rap_lr_tree(params, current_task=2, shared_lr=SHARED_LR, ds_lr=DS_LR),
        num_epochs=150))
    jts, jm = jstep(jsteps.init_train_state(params, bn), jsteps.ModelState(tparams, tbn),
                    jnp.asarray(x), jnp.asarray(y), mks, None, 1)

    lr = rap_lr_tree(student, current_task=2, shared_lr=SHARED_LR, ds_lr=DS_LR)
    step = steps.make_two_phase_distill_step(current_task=2, prev_tasks=(1, 0), class_weight=w,
                                             lr_tree=lr, num_epochs=150,
                                             compute_dtype="bfloat16")
    xt, yt = torch.from_numpy(x), torch.from_numpy(y).long()
    ts, m = step(steps.init_train_state(student), teacher, xt, yt, mks, 1)
    assert ts.opt.count == 2
    assert all(torch.equal(v, t_before[k]) for k, v in teacher.state_dict().items())

    # the float64 reference takes the same two phases, Adam on its own gradients
    params64 = dict(s64.named_parameters())
    ce, _, grads = steps.ce_loss_and_grads(s64, xt.double(), yt, mks[0], task=2,
                                           class_weight=torch.from_numpy(w))
    opt = optim.apply_updates(params64, grads, optim.init(params64), lr, **ADAM)
    kd, kld, grads = steps.kd_loss_and_grads(s64, t64, xt.double(), mks[1:], prev_tasks=(1, 0))
    optim.apply_updates(params64, grads, opt, lr, **ADAM)
    _compare("step3", student, s64, before, jts, lr, m, jm, {"loss": ce + kd, "ce": ce,
                                                              "kld": kld})
