"""The port's data-parallel steps (mdilss_tpu_torch/parallel, the sync-BN of
ops/norm.py and ops/nb1d_train.py, the steps' `mesh`) at world 2 on the CPU.

One `torchrun --nproc_per_node 2` launch of tests/_torch_dist_worker.py (gloo,
one thread per rank, the port only) runs every case on a global batch of 4
(2 rows per rank) at 64x128 and writes each rank's results; meanwhile this
process runs JAX's steps on a 2-device mesh (`make_mesh(2)`,
`jit_train_step` / `jit_distill_step`) and the port on one process on the
same weights (JAX's init through `from_jax`), batches and dropout masks.
The sharded steps compute the math of the unsharded ones (global BN
statistics, the global batch's losses, summed gradients), so they are held
to JAX's mesh at `tests/test_torch_train_step.py`'s tolerances and to the
port's single process at `tests/test_multichip.py`'s criterion."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_port import (BF16_EPS_LOSS, finish, randomize_bn, rel_l2, torchrun,
                         within_budget)
from mdilss_tpu.models import erfnet_rap
from mdilss_tpu.parallel import jit_distill_step, jit_train_step, make_mesh, replicate, shard_batch
from mdilss_tpu.train import masks as jmasks
from mdilss_tpu.train import steps as jsteps
from mdilss_tpu_torch.ckpt import from_jax
from mdilss_tpu_torch.models import ERFNetRAP
from mdilss_tpu_torch.models.blocks import NonBottleneck1dRAP
from mdilss_tpu_torch.models.topology import make_dropout_masks
from mdilss_tpu_torch.ops.nb1d_train import PLAIN_PAIRS, nb1d_train_apply
from mdilss_tpu_torch.ops.norm import batch_norm_train
from mdilss_tpu_torch.train import steps
from mdilss_tpu_torch.train.masks import rap_lr_tree

torch.set_num_threads(1)

SHARED_LR, DS_LR = 5e-6, 5e-4
B, H, W = 4, 64, 128  # the global batch: 2 rows on each of the 2 ranks
STEP_CASES = {"ce": 2, "distill": 2, "two_phase": 1}  # case: steps taken


def _batch(rng, n_masks: int):
    return (rng.standard_normal((B, H, W, 3), dtype=np.float32),
            rng.integers(0, 6, (B, H, W)).astype(np.int32),
            [make_dropout_masks(rng, B) for _ in range(n_masks)])


def _inputs():
    """Every case's weights and data, as JAX's (params, bn) and the port's
    state dicts."""
    rng = np.random.default_rng(0)
    tg = torch.Generator().manual_seed(0)
    jax_w = {}
    ce = randomize_bn(*erfnet_rap.init(jax.random.key(0), [6], 1), rng)
    st = randomize_bn(*erfnet_rap.init(jax.random.key(1), [6, 6], 2), rng)
    te = randomize_bn(*erfnet_rap.init(jax.random.key(2), [6], 1), rng)
    jax_w.update(ce=ce, student=st, teacher=te)
    w = (rng.random(6) * 5 + 0.5).astype(np.float32)
    w[5] = 0.0
    distill = dict(student=from_jax(*st), classes=[6, 6], teacher=from_jax(*te),
                   teacher_classes=[6], w=w, batches=[_batch(rng, 2) for _ in range(2)])
    block = NonBottleneck1dRAP(64, 2, 2, 0.3)
    with torch.no_grad():  # BN scales and variances in [0.5, 1.5], the rest ~ N(0, 0.1)
        for k, t in block.state_dict().items():
            if t.is_floating_point():
                positive = "running_var" in k or (k.startswith("bns") and k.endswith("weight"))
                t.copy_(torch.rand(t.shape, generator=tg) + 0.5 if positive
                        else torch.randn(t.shape, generator=tg) * 0.1)
    ey = rng.integers(0, 6, (B, H, W))
    ey[-1] = 5  # the last image all ignore, as a padded eval row
    inp = {
        # float64: the relus do not flip between two summation orders
        "bn": dict(weight=torch.rand(16, generator=tg) + 0.5, bias=torch.randn(16, generator=tg),
                   running_mean=torch.randn(16, generator=tg) * 0.1,
                   running_var=torch.rand(16, generator=tg) + 0.5,
                   x=torch.randn(B, 16, H, W, generator=tg).double() * 2 + 0.5,
                   cot=torch.randn(B, 16, H, W, generator=tg).double()),
        "nb1d": dict(state=block.double().state_dict(), dilated=2,
                     x=torch.randn(B, 64, H, W, generator=tg).double(),
                     cot=torch.randn(B, 64, H, W, generator=tg).double(),
                     mask=torch.rand(B, 64, generator=tg) < 0.7),
        "ce": dict(student=from_jax(*ce), classes=[6], w=w,
                   batches=[_batch(rng, 1) for _ in range(2)]),
        "distill": distill,
        "two_phase": {**distill, "batches": [_batch(rng, 2)]},
        "eval": dict(x=rng.standard_normal((B, H, W, 3), dtype=np.float32), y=ey),
    }
    return inp, jax_w


def _model(sd, classes):
    m = ERFNetRAP(list(classes), len(classes), device="cpu")
    m.load_state_dict(sd, strict=True)
    return m


def _port_world1(inp, kind: str, n: int, **kw):
    """The port's step `kind` on one process, whole batches: [(metrics, state)]."""
    c = inp[kind]
    task = 0 if kind == "ce" else 1
    student = _model(c["student"], c["classes"])
    lr = rap_lr_tree(student, current_task=task, shared_lr=SHARED_LR, ds_lr=DS_LR)
    common = dict(class_weight=c["w"], lr_tree=lr, num_epochs=150, **kw)
    if kind == "ce":
        step = steps.make_ce_step(task=0, iou_train=True, **common)
    elif kind == "distill":
        step = steps.make_distill_step(current_task=1, prev_tasks=(0,), **common)
    else:
        step = steps.make_two_phase_distill_step(current_task=1, prev_tasks=(0,),
                                                 iou_train=True, **common)
    teacher = None if kind == "ce" else _model(c["teacher"], c["teacher_classes"])
    ts, out = steps.init_train_state(student), []
    for x, y, mks in c["batches"][:n]:
        args = (torch.from_numpy(x), torch.from_numpy(y).long())
        ts, m = (step(ts, *args, mks[0], 1) if kind == "ce"
                 else step(ts, teacher, *args, mks, 1))
        out.append(({k: v.clone() for k, v in m.items()},
                    {**{k: v.clone() for k, v in student.state_dict().items()},
                     "opt_m": ts.opt.m.clone(), "opt_v": ts.opt.v.clone()}))
    return out


def _jax_mesh(inp, jw, kind: str, n: int):
    """JAX's step `kind` on a 2-device mesh: [(metrics, port-grammar state)]."""
    mesh = make_mesh(2)
    c = inp[kind]
    params, bn = jw["ce"] if kind == "ce" else jw["student"]
    params, bn = jax.tree.map(jnp.array, params), jax.tree.map(jnp.array, bn)  # donated
    task = 0 if kind == "ce" else 1
    lr = jmasks.rap_lr_tree(params, current_task=task, shared_lr=SHARED_LR, ds_lr=DS_LR)
    common = dict(class_weight=jnp.asarray(c["w"]), lr_tree=lr, num_epochs=150)
    if kind == "ce":
        step = jit_train_step(jsteps.make_ce_step(erfnet_rap.apply, task=0, **common), mesh)
    else:
        make = (jsteps.make_distill_step if kind == "distill"
                else jsteps.make_two_phase_distill_step)
        extra = dict(remat_prev=False) if kind == "distill" else {}
        step = jit_distill_step(make(erfnet_rap.apply, current_task=1, prev_tasks=(0,),
                                     **common, **extra), mesh)
        teacher = replicate(mesh, jsteps.ModelState(*jw["teacher"]))
    ts, out = replicate(mesh, jsteps.init_train_state(params, bn)), []
    for x, y, mks in c["batches"][:n]:
        xs, ys = shard_batch(mesh, x, y)
        ts, m = (step(ts, xs, ys, mks[0], None, 1) if kind == "ce"
                 else step(ts, teacher, xs, ys, mks, None, 1))
        out.append(({k: np.asarray(v) for k, v in m.items()},
                    from_jax(jax.device_get(ts.params), jax.device_get(ts.bn))))
    return out


def _rank(npz, case: str) -> dict:
    p = f"{case}|"
    return {k[len(p):]: npz[k] for k in npz.files if k.startswith(p)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the two ranks' results, the inputs, JAX's mesh steps, the port's
    single-process steps)."""
    d = tmp_path_factory.mktemp("dist")
    inp, jw = _inputs()
    torch.save(inp, d / "inputs.pt")
    proc = torchrun(["tests/_torch_dist_worker.py", "steps", d / "inputs.pt", d])
    try:
        jax_runs = {k: _jax_mesh(inp, jw, k, n) for k, n in STEP_CASES.items()}
        port1 = {k: _port_world1(inp, k, n) for k, n in STEP_CASES.items()}
    finally:
        finish(proc)
    ranks = [np.load(d / f"steps_rank{r}.npz") for r in (0, 1)]
    return ranks, inp, jax_runs, port1


def _grads_world1(out, cot, wrt: dict) -> dict:
    g = torch.autograd.grad((out * cot).sum(), list(wrt.values()), allow_unused=True)
    return {("dx" if k == "x" else k): v for k, v in zip(wrt, g) if v is not None}


@pytest.mark.parametrize("case", ["bn", "nb1d"])
def test_sync_bn_matches_world_1(runs, case):
    """batch_norm_train and the training block (plain pairs) in float64 at
    world 2 under `synced` against one process on the whole batch, to 1e-5
    relative (float64, so no relu flips between the two orders of the
    statistics' sums; in float32 a handful of the 2M outputs lie within
    rounding of 0 and their gradients flip): the output and
    dx (the ranks' rows together), the parameters' gradients summed over the
    ranks (the BN parameters' included: returned reduced by the block, they
    would count twice) and the running statistics."""
    ranks, inp, _, _ = runs
    c = inp[case]
    x = c["x"].clone().requires_grad_()
    if case == "bn":
        bn = torch.nn.BatchNorm2d(16, eps=1e-3).double()
        with torch.no_grad():
            for k in ("weight", "bias", "running_mean", "running_var"):
                getattr(bn, k).copy_(c[k])
        out = batch_norm_train(x, bn)
        want = {"out": out, **_grads_world1(out, c["cot"], {"x": x, "weight": bn.weight,
                                                            "bias": bn.bias}),
                "running_mean": bn.running_mean, "running_var": bn.running_var}
    else:
        block = NonBottleneck1dRAP(64, 2, 2, 0.3).double()
        block.load_state_dict(c["state"])
        block.train()
        out = nb1d_train_apply(block, x, 1, 0.3, c["mask"], pairs=PLAIN_PAIRS)
        want = {"out": out, **_grads_world1(out, c["cot"], {"x": x,
                                                            **dict(block.named_parameters())}),
                **{k: v for k, v in block.state_dict().items() if "running" in k}}
    r0, r1 = _rank(ranks[0], case), _rank(ranks[1], case)
    assert set(r0) == set(want), set(r0) ^ set(want)
    assert any(k.startswith("bns_") and k.endswith("weight") for k in want) or case == "bn"
    for k, v in want.items():
        v = v.detach().numpy()
        got = np.concatenate([r0[k], r1[k]]) if k in ("out", "dx") else r0[k]
        if k not in ("out", "dx"):
            np.testing.assert_array_equal(r0[k], r1[k], err_msg=k)
        np.testing.assert_allclose(got, v, rtol=1e-5, atol=1e-12, err_msg=k)


def _states(npz, case: str, i: int) -> tuple[dict, dict]:
    r = _rank(npz, case)
    p = f"step{i}/"
    state = {k[len(p) + 6:]: v for k, v in r.items() if k.startswith(p + "state/")}
    metrics = {k[len(p) + 7:]: v for k, v in r.items() if k.startswith(p + "metric/")}
    state.update(opt_m=r[p + "opt_m"], opt_v=r[p + "opt_v"])
    return metrics, state


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_steps_match_jax_on_a_mesh(runs, case):
    """The CE, distill and two-phase steps at world 2 against JAX's on a
    2-device mesh, as test_torch_train_step.py holds one process to JAX:
    step 1's losses at 1e-4 relative and running statistics at 1e-4 rel L2,
    step 2's at 1e-3 and 5e-3; trained parameters within 2 lr per Adam step,
    frozen ones bitwise JAX's and their initial values."""
    ranks, inp, jax_runs, _ = runs
    c = inp[case]
    lr = rap_lr_tree(_model(c["student"], c["classes"]), current_task=0 if case == "ce" else 1,
                     shared_lr=SHARED_LR, ds_lr=DS_LR)
    for i, (jm, want) in enumerate(jax_runs[case], 1):
        metrics, got = _states(ranks[0], case, i)
        n_adam = i * (2 if case == "two_phase" else 1)
        tol_loss, tol_bn = (1e-4, 1e-4) if i == 1 else (1e-3, 5e-3)
        for k in ("loss", "ce", "kld"):
            if k in jm:
                assert np.isfinite(metrics[k])
                np.testing.assert_allclose(metrics[k], jm[k], rtol=tol_loss, err_msg=k)
        if "cm" in metrics:
            assert metrics["cm"].sum() == B * H * W  # every pixel counted once
        for k, v in want.items():
            if "num_batches_tracked" in k:
                continue
            g, v = got[k], v.numpy()
            if "running" in k:
                assert rel_l2(g, v) <= tol_bn, k
            elif lr[k] == 0.0:
                np.testing.assert_array_equal(g, v, err_msg=k)
                np.testing.assert_array_equal(g, c["student"][k].numpy(), err_msg=k)
            else:
                np.testing.assert_allclose(g, v, atol=2 * n_adam * lr[k] + 1e-6, err_msg=k)


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_steps_match_world_1(runs, case):
    """World 2 against the port's single process. The first call at
    tests/test_multichip.py's criterion per Adam step taken (Adam turns a
    sign flip of a near-zero gradient into a full lr step): the loss to 1e-5
    relative, every parameter within 1.1e-3 per Adam step and at most 1% of
    them beyond 2e-5, the running statistics to 1e-4 relative (rel L2). The
    second call starts from the first one's sign noise, which this chaotic
    BN+relu stack's gradient amplifies (test_torch_train_step.py): held as
    that test holds its second step, the loss to 1e-3, the running
    statistics to 5e-3 and each trained element within 2 lr per Adam step."""
    ranks, inp, _, port1 = runs
    c = inp[case]
    lr = rap_lr_tree(_model(c["student"], c["classes"]), current_task=0 if case == "ce" else 1,
                     shared_lr=SHARED_LR, ds_lr=DS_LR)
    for i, (m1, s1) in enumerate(port1[case], 1):
        metrics, got = _states(ranks[0], case, i)
        n_adam = i * (2 if case == "two_phase" else 1)
        np.testing.assert_allclose(metrics["loss"], float(m1["loss"]),
                                   rtol=1e-5 if i == 1 else 1e-3)
        params = [k for k in lr]
        for k in s1:
            if "running" in k:
                assert rel_l2(got[k], s1[k].numpy()) <= (1e-4 if i == 1 else 5e-3), k
        if i == 1:
            d = np.concatenate([np.abs(got[k] - s1[k].numpy()).ravel() for k in params])
            assert d.max() <= 1.1e-3 * n_adam, d.max()
            assert (d > 2e-5).mean() <= 0.01, (d > 2e-5).mean()
        else:
            for k in params:
                np.testing.assert_allclose(got[k], s1[k].numpy(),
                                           atol=2 * n_adam * lr[k] + 1e-6, err_msg=k)


def test_bf16_distill_step_within_budget_of_world_1(runs):
    """A bf16 step-2 step at world 2 as far from the float64 step as the
    single-process bf16 step is (`within_budget`): the losses and the
    running statistics."""
    ranks, inp, _, _ = runs
    metrics, got = _states(ranks[0], "distill_bf16", 1)
    (m1, s1), = _port_world1(inp, "distill", 1, compute_dtype="bfloat16")
    c = inp["distill"]
    s64 = _model(c["student"], c["classes"]).double()
    t64 = _model(c["teacher"], c["teacher_classes"]).double()
    x, y, mks = c["batches"][0]
    loss, ce, kld, grads, _ = steps.distill_loss_and_grads(
        s64, t64, torch.from_numpy(x).double(), torch.from_numpy(y).long(), mks,
        current_task=1, prev_tasks=(0,), class_weight=torch.from_numpy(c["w"]), lambda_c=0.1)
    for k, v in (("loss", loss), ("ce", ce), ("kld", kld)):
        within_budget(f"world 2 {k}", metrics[k], float(m1[k]), float(v), eps=BF16_EPS_LOSS)
    keys = [k for k in s1 if "running" in k]
    run64 = dict(s64.named_buffers())
    within_budget("world 2 running stats", np.concatenate([got[k].ravel() for k in keys]),
                  np.concatenate([s1[k].numpy().ravel() for k in keys]),
                  np.concatenate([run64[k].numpy().ravel() for k in keys]))


def test_remat_is_bitwise_at_world_2(runs):
    """remat=True, remat_prev=True at world 2: the same step bit for bit (the
    replays issue the forward's collectives again)."""
    ranks, _, _, _ = runs
    for npz in ranks:
        (m_a, s_a), (m_b, s_b) = _states(npz, "distill", 1), _states(npz, "distill_remat", 1)
        assert m_a.keys() == m_b.keys() and s_a.keys() == s_b.keys()
        for k in m_a:
            np.testing.assert_array_equal(m_a[k], m_b[k], err_msg=k)
        for k in s_a:
            np.testing.assert_array_equal(s_a[k], s_b[k], err_msg=k)


def test_eval_confusion_matrix_counts_every_pixel_once(runs):
    """The eval step at world 2: the confusion matrix exactly world 1's, every
    pixel counted once; the CE the global batch's."""
    ranks, inp, _, _ = runs
    c, e = inp["ce"], inp["eval"]
    step = steps.make_eval_step(task=0, class_weight=c["w"], num_classes=6)
    loss, cm = step(_model(c["student"], c["classes"]), torch.from_numpy(e["x"]),
                    torch.from_numpy(e["y"]).long())
    for npz in ranks:
        r = _rank(npz, "eval")
        np.testing.assert_array_equal(r["cm"], cm.numpy())
        assert r["cm"].sum() == B * H * W
        np.testing.assert_allclose(r["loss"], float(loss), rtol=1e-5)


@pytest.mark.parametrize("case", [*STEP_CASES, "distill_bf16", "distill_remat"])
def test_ranks_hold_the_same_weights(runs, case):
    """After every step both ranks hold the same parameters, running
    statistics, Adam state and metrics, bit for bit."""
    ranks, _, _, _ = runs
    a, b = _rank(ranks[0], case), _rank(ranks[1], case)
    assert a.keys() == b.keys() and any("/state/" in k for k in a)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)

