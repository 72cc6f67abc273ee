"""The port's spatial axis (mdilss_tpu_torch/parallel/halo.py, the mesh's
`spatial` axis, the halos of ops/nb1d_infer.py, ops/nb1d_train.py and
models/blocks.py) on gloo processes on the CPU.

Two `torchrun` launches of tests/_torch_dist_worker.py "spatial" (the port
only, one thread per rank): 4 ranks, which run the 2x2 mesh (2 data x 2
spatial) and a 1x4 mesh, and 2 ranks, the 1x2 mesh. Meanwhile this process
runs the same computations whole: `halo` against slicing the whole image,
each conv kind in float64 (to 1e-12: the halos give the unsharded step's
math, and float64 keeps every relu on its side), the CE, distill,
two-phase and eval steps on one process at 64x128 (tests/test_multichip.py's
criterion, `tests/test_multichip.py:60-72`), and JAX's CE step on
`make_mesh(8, spatial=2)`, tests/test_multichip.py's setup."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_port import BF16_EPS_LOSS, finish, randomize_bn, rel_l2, torchrun, within_budget
from mdilss_tpu.models import erfnet_rap
from mdilss_tpu.parallel import jit_train_step, replicate, shard_batch
from mdilss_tpu.parallel import make_mesh as jax_make_mesh
from mdilss_tpu.train import masks as jmasks
from mdilss_tpu.train import steps as jsteps
from mdilss_tpu_torch.ckpt import from_jax
from mdilss_tpu_torch.models import ERFNetRAP
from mdilss_tpu_torch.models.blocks import (DownsamplerBlock, NonBottleneck1dAblation,
                                            NonBottleneck1dRAP, UpsamplerBlock)
from mdilss_tpu_torch.models.topology import make_dropout_masks
from mdilss_tpu_torch.ops.nb1d_infer import nb1d_infer, prepare_operands
from mdilss_tpu_torch.ops.nb1d_train import PLAIN_PAIRS, nb1d_train_apply
from mdilss_tpu_torch.train import steps
from mdilss_tpu_torch.train.masks import rap_lr_tree

torch.set_num_threads(1)

SHARED_LR, DS_LR = 5e-6, 5e-4
B, H, W = 4, 64, 128  # the global batch of the steps
HALO_DS = (1, 2, 4, 8, 16)  # against 4-row slabs: shorter, equal, longer
NB = (2, 16, 16, 8)  # an nb1d block's input and output [N, C, H, W]: 8 rows a slab at S = 2
CONVS = {  # kind: (module of dilation d, input shape, output shape, d)
    "down": (lambda d: DownsamplerBlock(16, 64, None), (2, 16, 32, 16), (2, 64, 16, 8), 1),
    "up": (lambda d: UpsamplerBlock(16, 8), NB, (2, 8, 32, 16), 1),
    **{f"ablation_d{d}": (lambda d: NonBottleneck1dAblation(16, d, 1, "rcm"), NB, NB, d)
       for d in (2, 16)},
    **{f"block_d{d}": (lambda d: NonBottleneck1dRAP(16, d, 1), NB, NB, d) for d in HALO_DS},
    **{f"infer_d{d}": (lambda d: NonBottleneck1dRAP(16, d, 1), NB, NB, d) for d in (1, 16)},
}
MESHES = {"1x2": 2, "2x2": 4}  # mesh: world
STEPS = ("ce", "distill", "two_phase")


def _batch(rng, n_masks: int):
    return (rng.standard_normal((B, H, W, 3), dtype=np.float32),
            rng.integers(0, 6, (B, H, W)).astype(np.int32),
            [make_dropout_masks(rng, B) for _ in range(n_masks)])


def _random_state(module, gen) -> dict:
    """`module` in float64 with BN scales and variances in [0.5, 1.5] and
    everything else ~ N(0, 0.1); its state dict."""
    module = module.double()
    with torch.no_grad():
        for k, t in module.state_dict().items():
            if t.is_floating_point():
                positive = "running_var" in k or ("bn" in k and k.endswith("weight"))
                t.copy_(torch.rand(t.shape, generator=gen, dtype=t.dtype) + 0.5 if positive
                        else torch.randn(t.shape, generator=gen, dtype=t.dtype) * 0.1)
    return module.state_dict()


def _inputs():
    rng = np.random.default_rng(0)
    gen = torch.Generator().manual_seed(0)
    ce = randomize_bn(*erfnet_rap.init(jax.random.key(0), [6], 1), rng)
    st = randomize_bn(*erfnet_rap.init(jax.random.key(1), [6, 6], 2), rng)
    te = randomize_bn(*erfnet_rap.init(jax.random.key(2), [6], 1), rng)
    w = (rng.random(6) * 5 + 0.5).astype(np.float32)
    w[5] = 0.0
    ey = rng.integers(0, 6, (B, H, W))
    ey[-1] = 5  # the last image all ignore, as a padded eval row
    convs = {}
    for kind, (make, shape, out_shape, d) in CONVS.items():
        convs[kind] = dict(state=_random_state(make(d), gen), d=d,
                           x=torch.randn(shape, generator=gen, dtype=torch.float64),
                           cot=torch.randn(out_shape, generator=gen, dtype=torch.float64))
    # tests/test_multichip.py's setup: the JAX init as it is, a batch of 8 at 32x64
    mp, mb = erfnet_rap.init(jax.random.key(0), [6], 1)
    mrng = np.random.default_rng(0)
    mw = np.ones(6, np.float32)
    mw[5] = 0
    inp = {
        "ce": dict(student=from_jax(*ce), classes=[6], w=w, batches=[_batch(rng, 1)]),
        "distill": dict(student=from_jax(*st), classes=[6, 6], teacher=from_jax(*te),
                        teacher_classes=[6], w=w, batches=[_batch(rng, 2)]),
        "eval": dict(x=rng.standard_normal((B, H, W, 3), dtype=np.float32), y=ey),
        "sp_halo": {"S2": torch.randn(2, 3, 8, 5, generator=gen, dtype=torch.float64),
                    "S4": torch.randn(1, 3, 16, 5, generator=gen, dtype=torch.float64)},
        "sp_convs": convs,
        "multichip": dict(student=from_jax(mp, mb), w=mw,
                          x=mrng.random((8, 32, 64, 3), np.float32),
                          y=mrng.integers(0, 6, size=(8, 32, 64)).astype(np.int32)),
    }
    return inp, (mp, mb)


def _model(sd, classes):
    m = ERFNetRAP(list(classes), len(classes), device="cpu")
    m.load_state_dict(sd, strict=True)
    return m


def _one_process(inp, kind: str, **kw):
    """The port's step `kind` on one process on the whole first batch:
    (metrics, state)."""
    c = inp["ce" if kind == "ce" else "distill"]
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
    x, y, mks = c["batches"][0]
    args = (torch.from_numpy(x), torch.from_numpy(y).long())
    ts = steps.init_train_state(student)
    if kind == "ce":
        ts, m = step(ts, *args, mks[0], 1)
    else:
        ts, m = step(ts, _model(c["teacher"], c["teacher_classes"]), *args, mks, 1)
    return ({k: v.clone() for k, v in m.items()},
            {**{k: v.clone() for k, v in student.state_dict().items()},
             "opt_m": ts.opt.m.clone(), "opt_v": ts.opt.v.clone()})


def _conv_whole(c, kind: str) -> dict:
    """The conv kind on the whole input in float64, one process."""
    make, _, _, d = CONVS[kind]
    m = make(d).double()
    m.load_state_dict(c["state"])
    m.train(not kind.startswith("infer"))
    if kind.startswith("infer"):
        return {"out": nb1d_infer(c["x"].contiguous(memory_format=torch.channels_last),
                                  prepare_operands(m, 0, torch.float64), d)}
    x = c["x"].clone().requires_grad_()
    if kind.startswith("block"):
        out = nb1d_train_apply(m, x, 0, 0.0, None, pairs=PLAIN_PAIRS)
    else:
        out = m(x, 0) if kind.startswith("ablation") else m(x)
    params = dict(m.named_parameters())
    g = torch.autograd.grad((out * c["cot"]).sum(), [x, *params.values()], allow_unused=True)
    rec = {"out": out, "dx": g[0],
           **{f"grad/{k}": v for k, v in zip(params, g[1:]) if v is not None},
           **{f"state/{k}": v for k, v in m.state_dict().items() if "running" in k}}
    return {k: v.detach() for k, v in rec.items()}


def _jax_multichip(inp, jw):
    """JAX's CE step on make_mesh(8, spatial=2) (4 data x 2 spatial), no
    dropout: (loss, port-grammar state)."""
    c = inp["multichip"]
    params, bn = (jax.tree.map(jnp.array, t) for t in jw)
    lr = jmasks.rap_lr_tree(params, current_task=0, shared_lr=5e-4, ds_lr=5e-4)
    mesh = jax_make_mesh(8, spatial=2)
    step = jit_train_step(jsteps.make_ce_step(erfnet_rap.apply, task=0, class_weight=c["w"],
                                              lr_tree=lr, num_epochs=10), mesh)
    ts = replicate(mesh, jsteps.init_train_state(params, bn))
    ts, m = step(ts, *shard_batch(mesh, c["x"], c["y"]), None, None, 1)
    return float(m["loss"]), from_jax(jax.device_get(ts.params), jax.device_get(ts.bn))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """({mesh: the ranks' results}, the inputs, the whole computations)."""
    d = tmp_path_factory.mktemp("spatial")
    inp, jw = _inputs()
    torch.save(inp, d / "inputs.pt")
    procs = {}
    for name, world in MESHES.items():
        (d / name).mkdir()
        procs[name] = torchrun(["tests/_torch_dist_worker.py", "spatial", d / "inputs.pt",
                                d / name], nproc=world)
    try:
        whole = {"jax_ce": _jax_multichip(inp, jw),
                 "steps": {k: _one_process(inp, k) for k in STEPS},
                 "bf16": _one_process(inp, "distill", compute_dtype="bfloat16"),
                 "convs": {k: _conv_whole(c, k) for k, c in inp["sp_convs"].items()}}
        c, e = inp["ce"], inp["eval"]
        whole["eval"] = steps.make_eval_step(task=0, class_weight=c["w"], num_classes=6)(
            _model(c["student"], c["classes"]), torch.from_numpy(e["x"]),
            torch.from_numpy(e["y"]).long())
    finally:
        for p in procs.values():
            finish(p)
    ranks = {name: [np.load(d / name / f"spatial_rank{r}.npz") for r in range(world)]
             for name, world in MESHES.items()}
    return ranks, inp, whole


def _case(npz, case: str) -> dict:
    p = f"{case}|"
    return {k[len(p):]: npz[k] for k in npz.files if k.startswith(p)}


def _block(x: np.ndarray, r: dict, axis: int) -> np.ndarray:
    """Rank r's block of a whole array: its data index's images (axis 0), its
    spatial index's rows (`axis`)."""
    x = np.asarray(x)
    nb, hb = x.shape[0] // int(r["data"]), x.shape[axis] // int(r["spatial"])
    i, s = int(r["data_index"]), int(r["spatial_index"])
    x = x[i * nb:(i + 1) * nb]
    return np.take(x, np.arange(s * hb, (s + 1) * hb), axis=axis)


@pytest.mark.parametrize("mesh,d", [(m, d) for m in ("S2", "S4") for d in HALO_DS])
def test_halo_matches_slicing(runs, mesh, d):
    """`halo(x, top, bottom)` at S = 2 (the 2x2 mesh) and S = 4, 4 rows a
    slab, d rows above and below, above only, below only, in float64: the
    output is the whole image's rows around the slab, clipped at the image's
    edges (no rows past them), and the gradient of sum(out * cot) summed over
    the ranks is exactly the whole image's (each halo row's back at its
    owner)."""
    ranks, inp, _ = runs
    x = inp["sp_halo"][mesh].numpy()
    n_sp = 2 if mesh == "S2" else 4
    h = x.shape[2] // n_sp
    for top, bottom in ((d, d), (d, 0), (0, d)):
        k = f"{mesh}/d{d}/{top},{bottom}"
        grads = {}
        for npz in ranks["2x2"]:
            r = _case(npz, "sp_halo")
            i, s = int(r[f"{mesh}/data_index"]), int(r[f"{mesh}/spatial_index"])
            nb = x.shape[0] // (4 // n_sp)
            rows = slice(max(0, s * h - top), min(n_sp * h, (s + 1) * h + bottom))
            want = x[i * nb:(i + 1) * nb, :, rows]
            np.testing.assert_array_equal(r[f"{k}/out"], want, err_msg=k)
            g = grads.setdefault(i, np.zeros_like(x[i * nb:(i + 1) * nb]))
            g[:, :, rows] += r[f"{k}/cot"]
        for npz in ranks["2x2"]:
            r = _case(npz, "sp_halo")
            i, s = int(r[f"{mesh}/data_index"]), int(r[f"{mesh}/spatial_index"])
            np.testing.assert_allclose(r[f"{k}/dx"], grads[i][:, :, s * h:(s + 1) * h],
                                       rtol=1e-15, atol=1e-15, err_msg=k)


@pytest.mark.parametrize("kind", list(CONVS))
def test_conv_sharded_equals_whole(runs, kind):
    """Each conv kind on the 2x2 mesh against the whole batch on one process,
    float64, to 1e-12: the downsampler (3x3 s2, 1 row above), the upsampler
    (transposed 3x3 s2, 1 row below), an ablation block's 3x1 convs (d rows
    each side), the training block on its plain pairs (1 and d rows, the
    stats over the slab only) and K1's plain version (1 + d rows), every
    training BN over the 4 ranks: each rank's block of the output and of dx,
    the parameters' gradients summed over the ranks, the running
    statistics."""
    ranks, _, whole = runs
    want = whole["convs"][kind]
    for npz in ranks["2x2"]:
        r = _case(npz, "sp_convs")
        got = {k[len(kind) + 1:]: v for k, v in r.items() if k.startswith(kind + "/")}
        assert set(got) == set(want), set(got) ^ set(want)
        for k, v in want.items():
            v = v.numpy()
            if k in ("out", "dx"):
                v = _block(v, r, 2)
            np.testing.assert_allclose(got[k], v, rtol=1e-12, atol=1e-12, err_msg=k)


def _states(npz, case: str):
    r = _case(npz, case)
    p = "step1/"
    state = {k[len(p) + 6:]: v for k, v in r.items() if k.startswith(p + "state/")}
    metrics = {k[len(p) + 7:]: v for k, v in r.items() if k.startswith(p + "metric/")}
    state.update(opt_m=r[p + "opt_m"], opt_v=r[p + "opt_v"])
    return metrics, state


def _held_to(metrics, state, want_metrics, want_state, params, n_adam: int) -> None:
    """tests/test_multichip.py's criterion per Adam step: the loss to 1e-5
    relative, every parameter within 1.1e-3 and at most 1% of them beyond
    2e-5, the running statistics to 1e-4 relative (rel L2)."""
    np.testing.assert_allclose(metrics["loss"], float(want_metrics["loss"]), rtol=1e-5)
    for k, v in want_state.items():
        if "running" in k:
            assert rel_l2(state[k], np.asarray(v)) <= 1e-4, k
    d = np.concatenate([np.abs(state[k] - np.asarray(want_state[k])).ravel() for k in params])
    assert d.max() <= 1.1e-3 * n_adam, d.max()
    assert (d > 2e-5).mean() <= 0.01, (d > 2e-5).mean()


@pytest.mark.parametrize("mesh,kind", [(m, k) for m in MESHES for k in STEPS])
def test_step_matches_one_process(runs, mesh, kind):
    """The CE, distill and two-phase steps on the 1x2 and 2x2 meshes (this
    rank's images and rows of a global batch of 4 at 64x128, dropout masks
    by data index) against one process on the whole batch, at
    tests/test_multichip.py's criterion; the train confusion matrix counts
    every pixel once."""
    ranks, inp, whole = runs
    c = inp["ce" if kind == "ce" else "distill"]
    params = list(rap_lr_tree(_model(c["student"], c["classes"]),
                              current_task=0 if kind == "ce" else 1, shared_lr=SHARED_LR,
                              ds_lr=DS_LR))
    wm, ws = whole["steps"][kind]
    for npz in ranks[mesh]:
        metrics, state = _states(npz, f"sp_{kind}")
        _held_to(metrics, state, wm, {k: v.numpy() for k, v in ws.items()}, params,
                 2 if kind == "two_phase" else 1)
        if "cm" in metrics:
            assert metrics["cm"].sum() == B * H * W


@pytest.mark.parametrize("mesh", list(MESHES))
def test_eval_step_matches_one_process(runs, mesh):
    """The eval step on the 1x2 and 2x2 meshes (K1's plain version with its
    halos): the confusion matrix equal to one process's, every pixel
    counted once; the CE the global batch's."""
    ranks, _, whole = runs
    loss, cm = whole["eval"]
    for npz in ranks[mesh]:
        r = _case(npz, "sp_eval")
        np.testing.assert_array_equal(r["cm"], cm.numpy())
        assert r["cm"].sum() == B * H * W
        np.testing.assert_allclose(r["loss"], float(loss), rtol=1e-5)


def test_ce_step_matches_jax_on_a_spatial_mesh(runs):
    """tests/test_multichip.py's CE step (batch 8, 32x64, its weights and
    data) on the port's 2x2 mesh against JAX's `make_mesh(8, spatial=2)`
    step, at that file's criterion: the loss to 1e-5 relative, every
    parameter within 1.1e-3 and at most 1% beyond 2e-5."""
    ranks, inp, whole = runs
    loss, want = whole["jax_ce"]
    params = list(rap_lr_tree(_model(inp["multichip"]["student"], [6]), current_task=0,
                              shared_lr=5e-4, ds_lr=5e-4))
    for npz in ranks["2x2"]:
        metrics, state = _states(npz, "sp_multichip_ce")
        assert int(_case(npz, "sp_multichip_ce")["data"]) == 2
        _held_to(metrics, state, {"loss": loss}, {k: v.numpy() for k, v in want.items()},
                 params, 1)


def test_remat_is_bitwise_with_spatial(runs):
    """remat=True, remat_prev=True on the 2x2 mesh: the distill step bit for
    bit as without (a region's replay exchanges its halos again, in step on
    every rank)."""
    ranks, _, _ = runs
    for npz in ranks["2x2"]:
        (m_a, s_a), (m_b, s_b) = _states(npz, "sp_distill"), _states(npz, "sp_distill_remat")
        assert m_a.keys() == m_b.keys() and s_a.keys() == s_b.keys()
        for k in m_a:
            np.testing.assert_array_equal(m_a[k], m_b[k], err_msg=k)
        for k in s_a:
            np.testing.assert_array_equal(s_a[k], s_b[k], err_msg=k)


def test_bf16_step_within_budget_on_a_spatial_mesh(runs):
    """A bf16 distill step on the 2x2 mesh as far from the float64 step as
    the single-process bf16 step is (`within_budget`): the losses and the
    running statistics."""
    ranks, inp, whole = runs
    metrics, got = _states(ranks["2x2"][0], "sp_distill_bf16")
    m1, s1 = whole["bf16"]
    c = inp["distill"]
    s64 = _model(c["student"], c["classes"]).double()
    t64 = _model(c["teacher"], c["teacher_classes"]).double()
    x, y, mks = c["batches"][0]
    loss, ce, kld, _, _ = steps.distill_loss_and_grads(
        s64, t64, torch.from_numpy(x).double(), torch.from_numpy(y).long(), mks,
        current_task=1, prev_tasks=(0,), class_weight=torch.from_numpy(c["w"]), lambda_c=0.1)
    for k, v in (("loss", loss), ("ce", ce), ("kld", kld)):
        within_budget(f"2x2 {k}", metrics[k], float(m1[k]), float(v), eps=BF16_EPS_LOSS)
    keys = [k for k in s1 if "running" in k]
    run64 = dict(s64.named_buffers())
    within_budget("2x2 running stats", np.concatenate([got[k].ravel() for k in keys]),
                  np.concatenate([s1[k].numpy().ravel() for k in keys]),
                  np.concatenate([run64[k].numpy().ravel() for k in keys]))


@pytest.mark.parametrize("mesh", list(MESHES))
def test_ranks_hold_the_same_weights(runs, mesh):
    """After every step every rank of the mesh holds the same parameters,
    running statistics, Adam state and metrics, bit for bit."""
    ranks, _, _ = runs
    cases = [f"sp_{k}" for k in STEPS] + (
        ["sp_distill_remat", "sp_distill_bf16", "sp_multichip_ce"] if mesh == "2x2" else [])
    for case in cases:
        a = _states(ranks[mesh][0], case)
        for npz in ranks[mesh][1:]:
            b = _states(npz, case)
            for x, y in zip(a, b):
                assert x.keys() == y.keys()
                for k in x:
                    np.testing.assert_array_equal(x[k], y[k], err_msg=f"{case} {k}")
