"""The port's ablation models through `build_trainer` and the train step,
against the JAX package's on the CPU (a file of its own beside
tests/test_torch_ablations.py and test_torch_ablations_eval.py: most of its
time is JAX compiling).

  * build_trainer: step 1 from an ImageNet encoder file (the shared convs
    grafted through an ERFNet-RAP template, no BN taken, even onlyrap's
    shared BN), step 2 and step 3 from the previous step's checkpoint (a JAX
    Orbax directory and a port checkpoint directory holding the same
    weights): the initial student and teacher bit for bit JAX's, but the
    freshly drawn parts.
  * One step-2 distillation step from the same weights, masks and batch:
    loss, ce and kld 1e-4 relative, every trained element within 2 lr of
    JAX's (Adam's first step moves an element by ~lr, its sign by the
    gradient's float32 noise), every frozen one bit for bit, the running
    statistics 1e-4 relative L2."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_port import ABLATION_VARIANTS as VARIANTS
from _torch_port import ablation_jax_model as jax_model
from _torch_port import ablation_port_model as port_model
from _torch_port import randomize_bn, rel_l2
from mdilss_tpu import config as JC
from mdilss_tpu.ckpt import export_state_dict, orbax_io
from mdilss_tpu.models import erfnet_ablations as A
from mdilss_tpu.models import erfnet_multihead as jmh
from mdilss_tpu.models.topology import make_dropout_masks
from mdilss_tpu.train import masks as jmasks
from mdilss_tpu.train import steps as jsteps
from mdilss_tpu.train.protocols import build_trainer as jax_build_trainer
from mdilss_tpu_torch import config as C
from mdilss_tpu_torch.ckpt import from_jax, torch_io
from mdilss_tpu_torch.models import ERFNetAblation
from mdilss_tpu_torch.train import steps
from mdilss_tpu_torch.train.loop import init_model
from mdilss_tpu_torch.models.erfnet_ablations import REFERENCE_NAMES
from mdilss_tpu_torch.train.masks import ablation_lr_tree
from mdilss_tpu_torch.train.protocols import build_trainer

torch.set_num_threads(1)
TINY = dict(synthetic=True, synthetic_size=2, batch_size=2, height=32, width=64,
            num_workers=1, num_epochs=1)
SHARED_LR, DS_LR = 5e-6, 5e-4
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


def _export(ts_like) -> dict:
    return from_jax(ts_like.params, ts_like.bn)


@pytest.mark.parametrize("variant", VARIANTS)
def test_step1_grafts_the_shared_encoder_convs_like_jax(tmp_path, variant):
    """An ImageNet encoder file (a single-task ERFNet's encoder with random BN
    under `module.features.*`): the shared convs equal JAX's grafted ones and
    the file's; every other entry, BN included (onlyrap's shared `bn1` has a
    name in the file), keeps the port's seeded init."""
    rng = np.random.default_rng(0)
    params, bn = randomize_bn(*jmh.init(jax.random.key(7), [20]), rng)
    enc = {k: torch.from_numpy(np.array(v)) for k, v in
           export_state_dict(params, bn, kind="multi_task").items() if k.startswith("encoder.")}
    path = str(tmp_path / "enc.pth.tar")
    torch.save({"state_dict": {"module.features." + k: v for k, v in enc.items()}}, path)
    kw = dict(model=MODEL[variant], pretrained_encoder=path, **TINY)
    jtr = jax_build_trainer(JC.step1(savedir=str(tmp_path / "j"), **kw))
    tr = build_trainer(C.step1(savedir=str(tmp_path / "p"), **kw), device="cpu")
    got, want = tr.ts.model.state_dict(), _export(jtr.ts)
    fresh = init_model(tr.cfg).state_dict()
    assert set(got) == set(want) == set(fresh)
    shared = [k for k in got if k in enc and ".bn" not in k and "num_batches" not in k]
    assert len(shared) == 2 * (3 + 4 * 13)  # 3 downsamplers, 13 blocks, weight and bias
    for k in shared:
        assert torch.equal(got[k], want[k]) and torch.equal(got[k], enc[k]), k
    for k in got:
        if k not in shared:
            assert torch.equal(got[k], fresh[k]), k
    if variant == "onlyrap":
        key = "encoder.layers.2.bn1.weight"
        assert key in enc and not torch.equal(got[key], enc[key])


@pytest.mark.parametrize("protocol,classes", [("step2", [20, 20]), ("step3", [20, 20, 27])])
@pytest.mark.parametrize("variant", VARIANTS)
def test_incremental_teacher_and_student_equal_jax(tmp_path, variant, protocol, classes):
    """From the previous step's checkpoint (JAX's Orbax directory, the port's
    checkpoint directory, the same weights): the teacher bit for bit JAX's,
    the student bit for bit JAX's but the new head's output_conv, which is
    the port's seeded draw."""
    from mdilss_tpu_torch.ckpt.surgery import extend_for_new_task

    params, state = jax_model(variant, classes[:-1], 3)
    jdir, pdir = _save_both(tmp_path, variant, params, state)
    kw = dict(model=MODEL[variant], **TINY)
    jtr = jax_build_trainer(getattr(JC, protocol)(savedir=str(tmp_path / "j"), state=jdir, **kw))
    tr = build_trainer(getattr(C, protocol)(savedir=str(tmp_path / "p"), state=pdir, **kw),
                       device="cpu")
    teacher, jteacher = tr.teacher.state_dict(), _export(jtr.teacher)
    assert set(teacher) == set(jteacher) == set(from_jax(params, state))
    assert all(torch.equal(teacher[k], v) for k, v in jteacher.items())
    got, want = tr.ts.model.state_dict(), _export(jtr.ts)
    head = f"decoder.{len(classes) - 1}.output_conv."
    assert set(got) == set(want)
    for k, v in want.items():
        if not k.startswith(head):
            assert torch.equal(got[k], v), k
    drawn = extend_for_new_task(from_jax(params, state), classes[-1],
                                generator=torch.Generator().manual_seed(tr.cfg.seed))
    assert torch.equal(got[head + "weight"], drawn[head + "weight"])
    assert isinstance(tr.teacher, ERFNetAblation) and tr.teacher.variant == variant


@pytest.mark.parametrize("variant", VARIANTS)
def test_distill_step_matches_jax(variant):
    """One step-2 step, [6, 6] student at task 1, [6] eval-mode teacher,
    2x64x128, the same weights (random BN and Wt), masks and batch."""
    rng = np.random.default_rng(5)
    params, bn = jax_model(variant, [6, 6], 5)
    tparams, tbn = jax_model(variant, [6], 6)
    w = (rng.random(6) * 5 + 0.5).astype(np.float32)
    w[5] = 0.0
    x = rng.standard_normal((2, 64, 128, 3), dtype=np.float32)
    y = rng.integers(0, 6, (2, 64, 128)).astype(np.int32)
    mks = [make_dropout_masks(rng, 2) for _ in range(2)]
    init = from_jax(params, bn)
    student, teacher = port_model(variant, params, bn), port_model(variant, tparams, tbn)

    jstep = jax.jit(jsteps.make_distill_step(
        A.model_module(variant).apply, current_task=1, prev_tasks=(0,),
        class_weight=jnp.asarray(w), num_epochs=150, remat_prev=False,
        lr_tree=jmasks.ablation_lr_tree(params, variant=variant, current_task=1,
                                        shared_lr=SHARED_LR, ds_lr=DS_LR)))
    jts, jm = jstep(jsteps.init_train_state(params, bn), jsteps.ModelState(tparams, tbn),
                    jnp.asarray(x), jnp.asarray(y), mks, None, 1)
    lr = ablation_lr_tree(student, variant=variant, current_task=1, shared_lr=SHARED_LR,
                          ds_lr=DS_LR)
    step = steps.make_distill_step(current_task=1, prev_tasks=(0,), class_weight=w, lr_tree=lr,
                                   num_epochs=150)
    _, m = step(steps.init_train_state(student), teacher, torch.from_numpy(x),
                torch.from_numpy(y).long(), mks, 1)
    for k in ("loss", "ce", "kld"):
        assert np.isfinite(float(m[k]))
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-4, err_msg=k)
    want, got = from_jax(jts.params, jts.bn), student.state_dict()
    frozen = 0
    for k, v in want.items():
        if "num_batches_tracked" in k:
            continue
        g, v = got[k].numpy(), v.numpy()
        if "running" in k:
            assert rel_l2(g, v) <= 1e-4, k
        elif lr[k] == 0.0:  # the old task's slices and decoder
            np.testing.assert_array_equal(g, v, err_msg=k)
            np.testing.assert_array_equal(g, init[k].numpy(), err_msg=k)
            frozen += 1
        else:
            np.testing.assert_allclose(g, v, rtol=0, atol=2 * lr[k] + 1e-6, err_msg=k)
    assert frozen
