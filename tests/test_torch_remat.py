"""Remat on the CPU (the plain pairs; 2-image batches at 32x64): a training
forward whose regions keep only their inputs and replay in the backward
(`models.topology._ckpt`, `ops.norm.replaying`) against the same forward
without regions, bitwise, for a RAP, a multi-head and an ablation model; the
regions are JAX's (5 + 2 in the encoder, 4 in a decoder); the three step
makers with `remat` / `remat_prev` against themselves without, bitwise, in
float32 and bfloat16, with the pair calls the nesting implies; and one
step-2 step against JAX's `make_distill_step` with an `apply_fn` that
passes `remat=True` and `remat_prev=True`, as JAX's Trainer builds it; and
`step1 --remat` -> `step2 --remat` through the command line.

No difference is allowed anywhere: the regions replay the forward's own
graph, so every gradient is summed in the same order as without them. (Were
a parameter to gather its gradient from three or more forwards in another
order, that would be the one admissible cause of a difference; none shows.)
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_port import randomize_bn
from mdilss_tpu.models import erfnet_rap
from mdilss_tpu.train import masks as jmasks
from mdilss_tpu.train import steps as jsteps
from mdilss_tpu_torch.ckpt import from_jax, torch_io
from mdilss_tpu_torch.cli import main as cli_main
from mdilss_tpu_torch.models import ERFNetAblation, ERFNetMultiHead, ERFNetRAP, topology
from mdilss_tpu_torch.models.blocks import NonBottleneck1d
from mdilss_tpu_torch.ops import nb1d_train, norm
from mdilss_tpu_torch.train import steps
from mdilss_tpu_torch.train.masks import rap_lr_tree

torch.set_num_threads(1)

N, H, W = 2, 32, 64
SHARED_LR, DS_LR = 5e-6, 5e-4
MODELS = {
    "rap": lambda: ERFNetRAP([5, 4], 2, device="cpu"),
    "multi_task": lambda: ERFNetMultiHead([5, 4], kind="multi_task", device="cpu"),
    "erfnet_RCM": lambda: ERFNetAblation([5, 4], 2, "rcm", device="cpu"),
}
# BN layers per training forward: 3 downsamplers, 13 encoder and 4 decoder
# nb1d blocks with two each, 2 upsamplers
BN_PER_FORWARD = 3 + 2 * (13 + 4) + 2


def _model(kind: str, seed: int = 0) -> torch.nn.Module:
    """`kind` with torch's initialisation from `seed`, random BN (affine and
    running statistics) and, for RCM, random non-symmetric matrices."""
    torch.manual_seed(seed)
    model = MODELS[kind]()
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, torch.nn.BatchNorm2d):
                mod.weight.copy_(0.5 + torch.rand(mod.weight.shape, generator=gen))
                mod.bias.copy_(0.1 * torch.randn(mod.bias.shape, generator=gen))
                mod.running_mean.copy_(0.1 * torch.randn(mod.running_mean.shape, generator=gen))
                mod.running_var.copy_(0.5 + torch.rand(mod.running_var.shape, generator=gen))
        for name, p in model.named_parameters():
            if ".Wt_" in name:
                p.add_(0.3 / p.shape[0] ** 0.5 * torch.randn(p.shape, generator=gen))
    return model


def _inputs(seed: int, n_masks: int = 1):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.random((N, H, W, 3), dtype=np.float32))
    y = torch.from_numpy(rng.integers(0, 4, (N, H, W)))
    return x, y, [topology.make_dropout_masks(rng, N) for _ in range(n_masks)]


def _running(model) -> dict:
    return {k: v.clone() for k, v in model.named_buffers() if "running" in k}


def _assert_equal(a: dict, b: dict, what: str):
    assert a.keys() == b.keys(), what
    bad = [k for k in a if not ((a[k] is None and b[k] is None) or torch.equal(a[k], b[k]))]
    assert not bad, f"{what}: {bad[:5]}"


@pytest.fixture
def updates(monkeypatch):
    """Every `update_running_stats` call, as the replay depth it was made at."""
    depths = []
    orig = norm.update_running_stats

    def spy(*args, **kw):
        depths.append(norm._REPLAY.depth)
        return orig(*args, **kw)

    monkeypatch.setattr(norm, "update_running_stats", spy)  # batch_norm_train's
    monkeypatch.setattr(nb1d_train, "update_running_stats", spy)  # nb1d_train_apply's
    return depths


@pytest.fixture
def regions(monkeypatch):
    """Every `topology._ckpt` call, as (the region's function, its args)."""
    calls = []
    orig = topology._ckpt

    def spy(fn, *args):
        calls.append((fn, args))
        return orig(fn, *args)

    monkeypatch.setattr(topology, "_ckpt", spy)
    return calls


@pytest.fixture
def pair_calls(monkeypatch):
    """The plain pairs' calls, forward and backward (the CPU counts no launches)."""
    counts = {"fwd": 0, "bwd": 0}
    for kind in counts:
        orig = getattr(nb1d_train, f"{kind}_pair_plain")

        def spy(*args, _orig=orig, _kind=kind):
            counts[_kind] += 1
            return _orig(*args)

        monkeypatch.setattr(nb1d_train, f"{kind}_pair_plain", spy)
    return counts


def _forward_backward(model, remat: bool, seed: int = 3):
    x, _, (masks,) = _inputs(seed)
    model.train()
    logits = model(x, 1, masks, remat=remat)
    cot = torch.from_numpy(np.random.default_rng(seed + 1).standard_normal(
        logits.shape).astype(np.float32))
    params = dict(model.named_parameters())
    grads = torch.autograd.grad((logits * cot).sum(), list(params.values()), allow_unused=True)
    return logits.detach(), dict(zip(params, grads))


@pytest.mark.parametrize("kind", list(MODELS))
def test_remat_forward_and_backward_are_bitwise(kind, updates):
    """A training forward and backward with remat=True equals remat=False bit
    for bit: the logits, every gradient, every running statistic; and the
    statistics are the pre-forward ones plus exactly one update: those of a
    forward alone, from BN_PER_FORWARD updates, none made in a replay."""
    plain = _model(kind)
    before = _running(plain)
    logits, grads = _forward_backward(plain, remat=False)
    once = _running(plain)
    # the BN layers of the shared encoder, head 1, and (RAP, RCM) task 1's slices
    assert sum(not torch.equal(once[k], before[k]) for k in before) == 2 * BN_PER_FORWARD
    assert updates == [0] * BN_PER_FORWARD
    updates.clear()

    remat = _model(kind)
    _assert_equal(_running(remat), before, "initial running statistics")
    r_logits, r_grads = _forward_backward(remat, remat=True)
    assert torch.equal(r_logits, logits)
    _assert_equal(r_grads, grads, "gradients")
    _assert_equal(_running(remat), once, "running statistics")
    assert updates.count(0) == BN_PER_FORWARD  # in the forward
    assert all(d > 0 for d in updates[BN_PER_FORWARD:])  # in the replays: skipped


def test_regions_are_jax_s(regions, updates, monkeypatch):
    """remat=True makes JAX's regions: each group64 block (encoder layers 1-5),
    each group128 chain of four (layers 7-10, 11-14), each decoder nb1d block;
    the downsamplers, upsamplers and output conv outside. A replay updates no
    running statistic. remat=False, an eval forward and a no_grad training
    forward make no region and never reach torch.utils.checkpoint."""
    model = _model("rap")
    _forward_backward(model, remat=True)
    enc = [(args[2], len(args) - 3) for fn, args in regions if fn == model.encoder._span]
    assert enc == list(topology.ENCODER_REGIONS) == [(1, 1), (2, 1), (3, 1), (4, 1), (5, 1),
                                                      (7, 4), (11, 4)]
    assert all(torch.is_tensor(args[3]) for fn, args in regions if fn == model.encoder._span)
    head = model.decoder[1]
    dec = [fn for fn, _ in regions if fn != model.encoder._span]
    assert dec == [head.layers[i] for i in topology.DECODER_REGIONS]
    assert all(isinstance(fn, NonBottleneck1d) for fn in dec) and len(dec) == 4
    assert updates.count(0) == BN_PER_FORWARD
    assert len(updates) > BN_PER_FORWARD and all(d > 0 for d in updates[BN_PER_FORWARD:])

    regions.clear()
    used = []
    monkeypatch.setattr(topology, "checkpoint", lambda *a, **k: used.append(a))
    monkeypatch.setattr(torch.utils.checkpoint, "checkpoint", lambda *a, **k: used.append(a))
    x, _, (masks,) = _inputs(4)
    _forward_backward(model, remat=False)
    with torch.no_grad():
        model(x, 1, masks, remat=True)
    model.eval()
    model(x, 1, remat=True)
    assert not regions and not used


def _maker(kind: str, student, dt: str, **flags):
    """(step maker's step, a teacher, the student's current task, previous tasks)."""
    cur, prev = {"ce": (0, ()), "distill": (1, (0,)), "two_phase": (2, (1, 0))}[kind]
    w = np.ones(len(student.decoder[cur].output_conv.bias), np.float32)
    w[-1] = 0.0
    kw = dict(class_weight=w, lr_tree=rap_lr_tree(student, current_task=cur, shared_lr=SHARED_LR,
                                                  ds_lr=DS_LR),
              num_epochs=150, compute_dtype=dt, iou_train=True, **flags)
    if kind == "ce":
        return steps.make_ce_step(task=cur, **kw), None
    make = steps.make_distill_step if kind == "distill" else steps.make_two_phase_distill_step
    return make(current_task=cur, prev_tasks=prev, **kw), prev


STEP_CLASSES = {"ce": [5], "distill": [5, 4], "two_phase": [5, 4, 3]}
# pair calls (forward, backward) per step: without regions, one forward pass per
# student and train-mode teacher forward and one backward per student forward; with
# remat each student forward replays once more, and with remat_prev each previous-task
# forward twice more (its own replay, then its regions' replay inside it)
PAIRS = {("ce", False): (34, 34), ("ce", True): (68, 34),
         ("distill", False): (68, 68), ("distill", True): (170, 68),
         ("two_phase", False): (170, 102), ("two_phase", True): (340, 102)}


def _step_run(kind: str, dt: str, seed: int, pair_calls, **flags):
    torch.manual_seed(seed)
    classes = STEP_CLASSES[kind]
    student = ERFNetRAP(classes, len(classes), device="cpu")
    teacher = ERFNetRAP(classes[:-1], len(classes) - 1, device="cpu") if len(classes) > 1 else None
    step, prev = _maker(kind, student, dt, **flags)
    x, y, masks = _inputs(seed + 1, 1 + len(prev or ()))
    y = y % classes[-1] if kind != "ce" else y % classes[0]
    pair_calls.update(fwd=0, bwd=0)
    ts = steps.init_train_state(student)
    if teacher is None:
        ts, m = step(ts, x, y, masks[0], 1)
    else:
        t_before = {k: v.clone() for k, v in teacher.state_dict().items()}
        ts, m = step(ts, teacher, x, y, masks, 1)
        _assert_equal(teacher.state_dict(), t_before, "the teacher")
    state = {k: v.clone() for k, v in student.state_dict().items()}
    state.update(opt_m=ts.opt.m, opt_v=ts.opt.v, opt_count=torch.tensor(ts.opt.count))
    return m, state, (pair_calls["fwd"], pair_calls["bwd"])


@pytest.mark.parametrize("kind,dt,flags", [
    *[(k, dt, dict(remat=True) if k == "ce" else dict(remat=True, remat_prev=True))
      for k in ("ce", "distill", "two_phase") for dt in ("float32", "bfloat16")],
    ("distill", "float32", dict(remat=True, remat_prev=False)),
    ("two_phase", "float32", dict(remat=False, remat_prev=True)),
])
def test_remat_steps_are_bitwise(kind, dt, flags, pair_calls):
    """make_ce_step, make_distill_step (step 2) and make_two_phase_distill_step
    (step 3, train-mode teacher) with remat / remat_prev equal the same step
    without them bit for bit: the losses and the confusion matrix, every
    parameter after Adam, every running statistic, Adam's moments; the
    teacher's buffers unchanged. The plain pairs run as often as the regions'
    nesting implies (PAIRS, and in between for one flag alone)."""
    m0, s0, calls0 = _step_run(kind, dt, 10, pair_calls)
    m1, s1, calls1 = _step_run(kind, dt, 10, pair_calls, **flags)
    _assert_equal(dict(m1), dict(m0), "metrics")
    _assert_equal(s1, s0, "the student's state and Adam's")
    assert calls0 == PAIRS[kind, False]
    # remat replays each student forward's regions once; remat_prev replays each
    # previous-task forward once as a whole (with its regions' forwards, if any)
    n_prev = len(STEP_CLASSES[kind]) - 1
    fwd = calls0[0] + 34 * (1 + n_prev) * flags["remat"] + 34 * n_prev * flags.get(
        "remat_prev", False)
    assert calls1 == (fwd, calls0[1])
    if flags["remat"] and flags.get("remat_prev", True):
        assert calls1 == PAIRS[kind, True]


def test_remat_distill_step_matches_jax():
    """One step-2 step ([6,6] student, [6] teacher, 2x32x64) with remat=True
    and remat_prev=True against JAX's make_distill_step whose apply_fn passes
    remat=True (JAX's Trainer's, mdilss_tpu/train/loop.py:267-276) and
    remat_prev=True, from test_torch_train_step's weights, masks and batch
    (its draws) and at its first step's tolerances."""
    rng = np.random.default_rng(0)
    params, bn = randomize_bn(*erfnet_rap.init(jax.random.key(0), [6, 6], 2), rng)
    tparams, tbn = randomize_bn(*erfnet_rap.init(jax.random.key(1), [6], 1), rng)
    w = (rng.random(6) * 5 + 0.5).astype(np.float32)
    w[5] = 0.0
    x = rng.standard_normal((2, 32, 64, 3), dtype=np.float32)
    y = rng.integers(0, 6, (2, 32, 64)).astype(np.int32)
    mks = [topology.make_dropout_masks(rng, 2) for _ in range(2)]

    def apply_fn(p, s, xx, task, **kw):
        return erfnet_rap.apply(p, s, xx.astype(jnp.float32), task, remat=True, **kw)

    jstep = jax.jit(jsteps.make_distill_step(
        apply_fn, current_task=1, prev_tasks=(0,), class_weight=jnp.asarray(w),
        lr_tree=jmasks.rap_lr_tree(params, current_task=1, shared_lr=SHARED_LR, ds_lr=DS_LR),
        num_epochs=150, remat_prev=True))
    jts, jm = jstep(jsteps.init_train_state(params, bn), jsteps.ModelState(tparams, tbn),
                    jnp.asarray(x), jnp.asarray(y), mks, None, 1)

    student = ERFNetRAP([6, 6], 2, device="cpu")
    student.load_state_dict(from_jax(params, bn), strict=True)
    teacher = ERFNetRAP([6], 1, device="cpu")
    teacher.load_state_dict(from_jax(tparams, tbn), strict=True)
    lr = rap_lr_tree(student, current_task=1, shared_lr=SHARED_LR, ds_lr=DS_LR)
    step = steps.make_distill_step(current_task=1, prev_tasks=(0,), class_weight=w, lr_tree=lr,
                                   num_epochs=150, remat=True, remat_prev=True)
    _, m = step(steps.init_train_state(student), teacher, torch.from_numpy(x),
                torch.from_numpy(y).long(), mks, 1)
    for k in ("loss", "ce", "kld"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-4, err_msg=k)
    want, got = from_jax(jts.params, jts.bn), student.state_dict()
    init = from_jax(params, bn)
    for k, v in want.items():
        if "num_batches_tracked" in k:
            continue
        g, v = got[k].numpy(), v.numpy()
        if "running" in k:
            assert np.linalg.norm(g - v) <= 1e-4 * np.linalg.norm(v), k
        elif lr[k] == 0.0:
            np.testing.assert_array_equal(g, v, err_msg=k)
            np.testing.assert_array_equal(g, init[k].numpy(), err_msg=k)
        else:
            np.testing.assert_allclose(g, v, atol=2 * lr[k] + 1e-6, err_msg=k)


def test_cli_remat_chain_equals_no_remat(tmp_path):
    """`step1 --remat` then `step2 --remat` through cli.main (TINY, --device
    cpu) give the best checkpoints of the same chain without --remat, bit for
    bit; step 2's LR-0 parameters stay step1/best's."""
    tiny = ["--height", "32", "--width", "64", "--batch-size", "2", "--num-epochs", "1",
            "--synthetic", "--synthetic-size", "4", "--num-workers", "0", "--device", "cpu"]
    for name, extra in (("plain", []), ("remat", ["--remat"])):
        root = tmp_path / name
        cli_main(["step1", "--savedir", str(root / "step1")] + tiny + extra)
        cli_main(["step2", "--order", "CS_BDD", "--state", str(root / "step1" / "best"),
                  "--savedir", str(root / "step2")] + tiny + extra)
    for stage in ("step1", "step2"):
        a, b = (torch_io.load_state(str(tmp_path / n / stage / "best"), "rap")
                for n in ("plain", "remat"))
        _assert_equal(a, b, f"{stage}/best")
    s1 = torch_io.load_state(str(tmp_path / "remat" / "step1" / "best"), "rap")
    s2 = torch_io.load_state(str(tmp_path / "remat" / "step2" / "best"), "rap")
    student = ERFNetRAP([20, 20], 2, device="cpu")
    lr = rap_lr_tree(student, current_task=1, shared_lr=SHARED_LR, ds_lr=DS_LR)
    frozen = [k for k, v in lr.items() if v == 0.0 and k in s1]
    assert frozen and all(torch.equal(s1[k], s2[k]) for k in frozen)
