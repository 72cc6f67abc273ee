"""bf16 training of the multi-head and ablation models against the JAX
package on the CPU (a file of its own beside test_torch_bf16_train.py: most
of its time is JAX compiling): one CE step of erfnet_multi_task (the
multitask baseline's domain turn) and one step-2 step of erfnet_RCM, each
with a bf16 `apply_fn` in JAX and `compute_dtype="bfloat16"` in the port,
from the same bf16-valued weights (random BN, random non-symmetric RCM
matrices), batch and dropout masks; and every model class's training and
eval forward keeping a bf16 input bf16 from the first downsampler to the
logits, with float32 parameters and gradients.

The losses (BF16_EPS_LOSS), the updated running statistics and every trained
parameter's move divided by its LR are held to the error budget of
`_torch_port.within_budget` against the port's float64 plain path taking the
same step (see test_torch_bf16_train.py); every frozen parameter bitwise
unchanged, every trained one within 2 lr of JAX's (one Adam step moves an
element by at most lr)."""
import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_port import (BF16_EPS_LOSS, ablation_jax_model, ablation_port_model, bf16_exact,
                         bf16_exact_tree, lr_moves, randomize_bn, within_budget)
from mdilss_tpu.ckpt import export_state_dict
from mdilss_tpu.models import erfnet_ablations as A
from mdilss_tpu.models import erfnet_multihead as jmh
from mdilss_tpu.train import masks as jmasks
from mdilss_tpu.train import steps as jsteps
from mdilss_tpu_torch.ckpt import from_jax
from mdilss_tpu_torch.models import ERFNet, ERFNetAblation, ERFNetMultiHead, ERFNetRAP
from mdilss_tpu_torch.models.blocks import NonBottleneck1dAblation
from mdilss_tpu_torch.models.topology import make_dropout_masks
from mdilss_tpu_torch.train import optim, steps
from mdilss_tpu_torch.train.masks import ablation_lr_tree, multihead_lr_tree

torch.set_num_threads(1)
BF16 = torch.bfloat16
LR, SHARED_LR, DS_LR = 5e-4, 5e-6, 5e-4
ADAM = dict(lr_scale=optim.poly_lr_factor(1, 150), weight_decay=1e-4)


def _bf16(apply):
    """JAX's bf16 forward of `apply`, as its Trainer's apply_fn casts x."""
    return lambda p, s, x, task, **kw: apply(p, s, x.astype(jnp.bfloat16), task, **kw)


def _running(model, state: dict | None = None) -> np.ndarray:
    return np.concatenate([(b if state is None else state[k]).double().numpy().ravel()
                           for k, b in model.named_buffers() if "running" in k])


def _check_params(model, before: dict, want: dict, lr: dict) -> int:
    """Frozen parameters bitwise as before and as JAX's, trained ones within 2 lr
    of JAX's; returns the number of trained parameters that moved."""
    got, moved = model.state_dict(), 0
    for k, v in want.items():
        if "running" in k or "num_batches_tracked" in k:
            continue
        if lr[k] == 0.0:
            assert torch.equal(got[k], before[k]) and torch.equal(got[k], v), k
        else:
            np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=0,
                                       atol=2 * lr[k] + 1e-6, err_msg=k)
            moved += not torch.equal(got[k], before[k])
    return moved


def _batch(rng, n_classes: int):
    w = (rng.random(n_classes) * 5 + 0.5).astype(np.float32)
    w[-1] = 0.0
    x = bf16_exact(rng.random((2, 32, 64, 3)))
    y = rng.integers(0, n_classes, (2, 32, 64)).astype(np.int32)
    return w, x, y


def test_bf16_multitask_ce_step_within_budget_of_jax():
    """One CE step of erfnet_multi_task [6, 7, 8] on head 1, the multitask
    baseline's LRs (encoder LR / 3), 2x32x64, in bf16."""
    rng = np.random.default_rng(3)
    nc, task = [6, 7, 8], 1
    params, bn = randomize_bn(*jmh.init(jax.random.key(2), nc), rng)
    params = bf16_exact_tree(params)
    model = ERFNetMultiHead(nc, kind="multi_task", device="cpu")
    model.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in
                           export_state_dict(params, bn, kind="multi_task").items()}, strict=True)
    m64 = copy.deepcopy(model).double()
    before = {k: v.clone() for k, v in model.state_dict().items()}
    w, x, y = _batch(rng, nc[task])
    mk = make_dropout_masks(rng, 2)

    jlr = jmasks.multihead_lr_tree(params, encoder_lr=LR / 3, decoder_lrs=[LR] * 3)
    jstep = jax.jit(jsteps.make_ce_step(_bf16(jmh.apply), task=task, class_weight=jnp.asarray(w),
                                        lr_tree=jlr, num_epochs=150))
    jts, jm = jstep(jsteps.init_train_state(params, bn), jnp.asarray(x), jnp.asarray(y), mk,
                    None, 1)
    lr = multihead_lr_tree(model, encoder_lr=LR / 3, decoder_lrs=[LR] * 3)
    step = steps.make_ce_step(task=task, class_weight=w, lr_tree=lr, num_epochs=150,
                              compute_dtype="bfloat16")
    xt, yt = torch.from_numpy(x), torch.from_numpy(y).long()
    ts, m = step(steps.init_train_state(model), xt, yt, mk, 1)
    ce, _, grads = steps.ce_loss_and_grads(m64, xt.double(), yt, mk, task=task,
                                           class_weight=torch.from_numpy(w))
    params64 = dict(m64.named_parameters())
    optim.apply_updates(params64, grads, optim.init(params64), lr, **ADAM)
    within_budget("multitask ce", float(m["ce"]), float(jm["ce"]), float(ce), eps=BF16_EPS_LOSS)
    want = {k: torch.from_numpy(np.array(v)) for k, v in
            export_state_dict(jts.params, jts.bn, kind="multi_task").items()}
    within_budget("multitask running stats", _running(model), _running(model, want), _running(m64))
    within_budget("multitask moves / lr", lr_moves(model, before, lr),
                  lr_moves(model, before, lr, want), lr_moves(model, before, lr, params64))
    assert _check_params(model, before, want, lr) > 0 and ts.opt.count == 1


def test_bf16_rcm_step2_within_budget_of_jax():
    """One step-2 step of erfnet_RCM ([6, 6] student at task 1, [6] eval-mode
    teacher, 2x32x64) in bf16."""
    rng = np.random.default_rng(5)
    params, bn = ablation_jax_model("rcm", [6, 6], 5)
    tparams, tbn = ablation_jax_model("rcm", [6], 6)
    params, tparams = bf16_exact_tree(params), bf16_exact_tree(tparams)
    student, teacher = (ablation_port_model("rcm", params, bn),
                        ablation_port_model("rcm", tparams, tbn))
    s64, t64 = copy.deepcopy(student).double(), copy.deepcopy(teacher).double()
    before = {k: v.clone() for k, v in student.state_dict().items()}
    w, x, y = _batch(rng, 6)
    mks = [make_dropout_masks(rng, 2) for _ in range(2)]

    jstep = jax.jit(jsteps.make_distill_step(
        _bf16(A.model_module("rcm").apply), current_task=1, prev_tasks=(0,),
        class_weight=jnp.asarray(w), num_epochs=150, remat_prev=False,
        lr_tree=jmasks.ablation_lr_tree(params, variant="rcm", current_task=1,
                                        shared_lr=SHARED_LR, ds_lr=DS_LR)))
    jts, jm = jstep(jsteps.init_train_state(params, bn), jsteps.ModelState(tparams, tbn),
                    jnp.asarray(x), jnp.asarray(y), mks, None, 1)
    lr = ablation_lr_tree(student, variant="rcm", current_task=1, shared_lr=SHARED_LR,
                          ds_lr=DS_LR)
    step = steps.make_distill_step(current_task=1, prev_tasks=(0,), class_weight=w, lr_tree=lr,
                                   num_epochs=150, compute_dtype="bfloat16")
    xt, yt = torch.from_numpy(x), torch.from_numpy(y).long()
    _, m = step(steps.init_train_state(student), teacher, xt, yt, mks, 1)
    ref = steps.distill_loss_and_grads(s64, t64, xt.double(), yt, mks, current_task=1,
                                       prev_tasks=(0,), class_weight=torch.from_numpy(w),
                                       lambda_c=0.1)
    params64 = dict(s64.named_parameters())
    optim.apply_updates(params64, ref[3], optim.init(params64), lr, **ADAM)
    for i, k in enumerate(("loss", "ce", "kld")):
        within_budget(f"rcm step2 {k}", float(m[k]), float(jm[k]), float(ref[i]),
                      eps=BF16_EPS_LOSS)
    want = from_jax(jts.params, jts.bn)
    within_budget("rcm step2 running stats", _running(student), _running(student, want),
                  _running(s64))
    within_budget("rcm step2 moves / lr", lr_moves(student, before, lr),
                  lr_moves(student, before, lr, want), lr_moves(student, before, lr, params64))
    assert _check_params(student, before, want, lr) > 0


def _every_model():
    torch.manual_seed(0)
    return {"rap": ERFNetRAP([5, 6], 2, device="cpu"),
            "erfnet": ERFNet(5, device="cpu"),
            "multi_task": ERFNetMultiHead([5, 6], kind="multi_task", device="cpu"),
            **{v: ERFNetAblation([5, 6], 2, v, device="cpu") for v in ("bn", "onlyrap", "ras",
                                                                        "rcm")}}


@pytest.mark.parametrize("name", ["rap", "erfnet", "multi_task", "bn", "onlyrap", "ras", "rcm"])
def test_bf16_input_stays_bf16_to_the_logits(name):
    """A bf16 input stays bf16 through every layer of the training forward
    (every downsampler, nb1d block, upsampler and the head) and of the eval
    forward; the parameters and their gradients stay float32."""
    model = _every_model()[name]
    task = 0 if name == "erfnet" else 1
    seen = []

    def record(module, args, out):
        if torch.is_tensor(out):
            seen.append((type(module).__name__, out.dtype))

    layers = [m for m in model.modules() if not list(m.children())
              or isinstance(m, NonBottleneck1dAblation) or hasattr(m, "dilated")]
    hooks = [m.register_forward_hook(record) for m in layers
             if not isinstance(m, torch.nn.BatchNorm2d)]
    x = torch.rand(2, 32, 64, 3).to(BF16)
    rng = np.random.default_rng(0)
    model.train()
    logits = model(x, task, make_dropout_masks(rng, 2))
    assert logits.dtype == BF16
    grads = torch.autograd.grad(logits.float().square().mean(),
                                [p for p in model.parameters()], allow_unused=True)
    assert all(g is None or g.dtype == torch.float32 for g in grads)
    assert any(g is not None for g in grads)
    model.eval()
    assert model(x, task).dtype == BF16
    for h in hooks:
        h.remove()
    assert seen and all(dt == BF16 for _, dt in seen), [s for s in seen if s[1] != BF16][:5]
    assert all(p.dtype == torch.float32 for p in model.parameters())
