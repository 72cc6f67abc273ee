"""One rank of the port's sharded CPU tests (tests/test_torch_parallel.py,
tests/test_torch_parallel_trainer.py: the data axis at world 2;
tests/test_torch_spatial.py, tests/test_torch_spatial_trainer.py: the
spatial axis at world 2 or 4), under

    python -m torch.distributed.run --standalone --nproc_per_node 2 \
        tests/_torch_dist_worker.py GROUP INPUTS OUT_DIR

It imports the port only (never JAX), joins the gloo group through
`parallel.make_mesh`, runs every case of GROUP ("steps" or "trainer" at world
2; "spatial" or "spatial_trainer" at world 2 or 4) on the inputs the test
wrote (`torch.save` of a dict), and writes this rank's results to
OUT_DIR/GROUP_rank<r>.npz (keys "case|name"), which the test reads.
"""
import contextlib
import functools
import io
import sys

import numpy as np
import torch

torch.set_num_threads(1)

from mdilss_tpu_torch import config as C  # noqa: E402
from mdilss_tpu_torch.data.device_cache import DeviceCache, cache_bytes  # noqa: E402
from mdilss_tpu_torch.data.loader import Loader, SyntheticSource  # noqa: E402
from mdilss_tpu_torch.models import ERFNetRAP  # noqa: E402
from mdilss_tpu_torch.models.blocks import NonBottleneck1dRAP  # noqa: E402
from mdilss_tpu_torch.models.topology import shard_dropout_masks  # noqa: E402
from mdilss_tpu_torch.ops.nb1d_train import PLAIN_PAIRS, nb1d_train_apply  # noqa: E402
from mdilss_tpu_torch.ops.norm import batch_norm_train, synced  # noqa: E402
from mdilss_tpu_torch.parallel import (all_reduce_grads, make_mesh, replicate,  # noqa: E402
                                       shard_height, shard_rows)
from mdilss_tpu_torch.parallel import halo as H  # noqa: E402
from mdilss_tpu_torch.train import steps  # noqa: E402
from mdilss_tpu_torch.train.loop import Trainer  # noqa: E402
from mdilss_tpu_torch.train.masks import rap_lr_tree  # noqa: E402

assert "jax" not in sys.modules and "mdilss_tpu" not in sys.modules

SHARED_LR, DS_LR = 5e-6, 5e-4
GLOBAL_BATCH = 4


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _grads_of(out, cot, wrt: dict, mesh):
    """{name: gradient of sum(out * cot)}, the parameters' summed over the ranks."""
    g = torch.autograd.grad((out * cot).sum(), list(wrt.values()), allow_unused=True)
    grads = dict(zip(wrt, g))
    x_grad = grads.pop("x")
    return {"dx": x_grad, **all_reduce_grads(grads, mesh)}


def case_bn(inp, mesh, rec):
    """Training BN under `synced`: output, dx, summed weight / bias gradients,
    running statistics."""
    inp = inp["bn"]
    bn = torch.nn.BatchNorm2d(inp["x"].shape[1], eps=1e-3).to(inp["x"].dtype)
    with torch.no_grad():
        for k in ("weight", "bias", "running_mean", "running_var"):
            getattr(bn, k).copy_(inp[k])
    x = shard_rows(inp["x"], mesh).clone().requires_grad_()
    with synced(mesh):
        out = batch_norm_train(x, bn)
        g = _grads_of(out, shard_rows(inp["cot"], mesh), {"x": x, "weight": bn.weight,
                                                          "bias": bn.bias}, mesh)
    rec.update(out=out, **g, running_mean=bn.running_mean, running_var=bn.running_var)


def case_nb1d(inp, mesh, rec):
    """A RAP block's training forward on the plain pairs under `synced`."""
    inp = inp["nb1d"]
    block = NonBottleneck1dRAP(inp["x"].shape[1], inp["dilated"], 2, 0.3).to(inp["x"].dtype)
    block.load_state_dict(inp["state"])
    block.train()
    x = shard_rows(inp["x"], mesh).clone().requires_grad_()
    params = dict(block.named_parameters())
    with synced(mesh):
        out = nb1d_train_apply(block, x, 1, 0.3, shard_rows(inp["mask"], mesh),
                               pairs=PLAIN_PAIRS)
        g = _grads_of(out, shard_rows(inp["cot"], mesh), {"x": x, **params}, mesh)
    rec.update(out=out, **{k: v for k, v in g.items() if v is not None},
               **{k: v for k, v in block.state_dict().items() if "running" in k})


def _model(sd: dict, classes) -> ERFNetRAP:
    m = ERFNetRAP(list(classes), len(classes), device="cpu")
    m.load_state_dict(sd, strict=True)
    return m


def _record_state(rec, prefix: str, ts, metrics) -> None:
    for k, v in ts.model.state_dict().items():  # copies: the next step updates in place
        rec[f"{prefix}/state/{k}"] = v.clone()
    rec[f"{prefix}/opt_m"], rec[f"{prefix}/opt_v"] = ts.opt.m.clone(), ts.opt.v.clone()
    rec[f"{prefix}/opt_count"] = np.int64(ts.opt.count)
    for k, v in metrics.items():
        rec[f"{prefix}/metric/{k}"] = v


def _run_step(inp, mesh, rec, kind: str, n_batches: int, **kw) -> None:
    """`n_batches` calls of the step maker `kind` on this rank's rows of each
    global batch and of its masks; the state and metrics after each call."""
    task = 0 if kind == "ce" else 1
    student = replicate(_model(inp["student"], inp["classes"]), mesh)
    lr = rap_lr_tree(student, current_task=task, shared_lr=SHARED_LR, ds_lr=DS_LR)
    common = dict(class_weight=inp["w"], lr_tree=lr, num_epochs=150, mesh=mesh, **kw)
    if kind == "ce":
        step = steps.make_ce_step(task=0, **common)
    else:
        make = steps.make_distill_step if kind == "distill" else steps.make_two_phase_distill_step
        step = make(current_task=1, prev_tasks=(0,), **common)
        teacher = replicate(_model(inp["teacher"], inp["teacher_classes"]), mesh)
    ts = steps.init_train_state(student)
    for i, (x, y, mks) in enumerate(inp["batches"][:n_batches]):
        xs = shard_rows(torch.from_numpy(x), mesh)
        ys = shard_rows(torch.from_numpy(y).long(), mesh)
        if kind == "ce":
            ts, m = step(ts, xs, ys, shard_dropout_masks(mks[0], mesh), 1)
        else:
            ts, m = step(ts, teacher, xs, ys, [shard_dropout_masks(k, mesh) for k in mks], 1)
        _record_state(rec, f"step{i + 1}", ts, m)


def case_ce(inp, mesh, rec):
    _run_step(inp["ce"], mesh, rec, "ce", 2, iou_train=True)


def case_distill(inp, mesh, rec):
    _run_step(inp["distill"], mesh, rec, "distill", 2)


def case_two_phase(inp, mesh, rec):
    _run_step(inp["two_phase"], mesh, rec, "two_phase", 1, iou_train=True)


def case_distill_bf16(inp, mesh, rec):
    _run_step(inp["distill"], mesh, rec, "distill", 1, compute_dtype="bfloat16")


def case_distill_remat(inp, mesh, rec):
    _run_step(inp["distill"], mesh, rec, "distill", 1, remat=True, remat_prev=True)


def case_eval(inp, mesh, rec):
    e = inp["eval"]
    model = replicate(_model(inp["ce"]["student"], inp["ce"]["classes"]), mesh)
    step = steps.make_eval_step(task=0, class_weight=inp["ce"]["w"], num_classes=6, mesh=mesh)
    loss, cm = step(model, shard_rows(torch.from_numpy(e["x"]), mesh),
                    shard_rows(torch.from_numpy(e["y"]).long(), mesh))
    rec.update(loss=loss, cm=cm)


def case_cache(inp, mesh, rec):
    """The DeviceCache mesh arm over 11 rows (padded to 12), batches of 4:
    a shuffled epoch and an eval pass, this rank's block of every batch."""
    src = SyntheticSource(6, n=11, height=32, width=64)
    for shuffle in (True, False):
        ld = Loader(src, batch_size=GLOBAL_BATCH, height=32, width=64, shuffle=shuffle,
                    num_threads=1, shard=(mesh.rank, mesh.data))
        cache = DeviceCache(ld, device="cpu", mesh=mesh)
        rec[f"{shuffle}/rows_held"] = np.int64(cache.images.shape[0])
        ld.set_epoch(2)
        for i, ((ci, cl, cv), (si, sl, sv)) in enumerate(
                zip(cache.epoch_batches(2, shuffle=shuffle), ld)):
            rec.update({f"{shuffle}/{i}/{k}": v for k, v in dict(
                images=ci, labels=cl, valid=cv, s_images=si, s_labels=sl, s_valid=sv).items()})
        rec[f"{shuffle}/n_batches"] = np.int64(len(ld))


def _trainer_cfg(out_dir: str, name: str, **kw):
    base = dict(synthetic=True, synthetic_size=10, batch_size=GLOBAL_BATCH, height=32,
                width=64, num_workers=1, num_epochs=1, savedir=f"{out_dir}/{name}")
    return C.step1(**{**base, **kw})


def case_budget(inp, mesh, rec):
    """The Trainer's cache plan on the mesh: a budget of 6 rows fits the 10
    rows sharded (full, charged 5 rows), one of 3 rows would need a hybrid
    cache and streams, saying so."""
    row = cache_bytes(1, 32, 64)
    for name, rows in (("full", 6), ("hybrid", 3)):
        tr = Trainer(_trainer_cfg(inp["out"], f"budget_{name}", device_cache=str(rows * row)),
                     device="cpu")
        before = tr._cache_budget
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            cache = tr._cache_for("cityscapes", "train")
        rec.update({f"{name}/kind": np.array(type(cache).__name__),
                    f"{name}/before": np.int64(before), f"{name}/after": np.int64(tr._cache_budget),
                    f"{name}/printed": np.array(buf.getvalue())})


def case_gcd(inp, mesh, rec):
    """A global batch of 3 on 2 ranks: D = gcd(3, 2) = 1, rank 1 trains
    nothing and returns rank 0's result."""
    tr = Trainer(_trainer_cfg(inp["out"], "gcd", batch_size=3, synthetic_size=6,
                              num_epochs=2), device="cpu")
    final = tr.fit()
    rec.update(data=np.int64(tr.mesh.data), member=np.bool_(tr.mesh.member),
               final=np.array(repr(sorted((k, v) for k, v in final.items()
                                          if k != "epoch_seconds"))))


def case_fused(inp, mesh, rec):
    try:
        Trainer(_trainer_cfg(inp["out"], "fused", fused_train=True), device="cpu")
        rec["error"] = np.array("")
    except ValueError as e:
        rec["error"] = np.array(str(e))


# ---- the spatial axis (tests/test_torch_spatial*.py) ---------------------------------------
# "spatial" at world 4 runs the 2x2 mesh (2 data x 2 spatial) and a 1x4 mesh; at world 2, the
# 1x2 mesh. A rank's block of a global batch: its data index's images, its spatial index's rows.

def _block(x, mesh, axis: int):
    return shard_height(shard_rows(x, mesh), mesh, axis)


def _where(mesh, rec) -> None:
    rec.update(data_index=np.int64(mesh.data_index), spatial_index=np.int64(mesh.spatial_index),
               data=np.int64(mesh.data), spatial=np.int64(mesh.spatial))


def case_sp_halo(inp, mesh, rec):
    """`halo` in float64 on the 2x2 mesh (S = 2) and a 1x4 mesh (S = 4), 4 rows a
    slab: d in 1, 2, 4, 8, 16 rows above and below, above only, below only;
    the output and the gradient of sum(out * cot) for a cot drawn per rank."""
    if mesh.world != 4:
        return
    for name, sp in (("S2", _sp_mesh(2)),
                     ("S4", make_mesh(1, spatial=4, device="cpu"))):
        x = inp["sp_halo"][name]
        rec[f"{name}/data_index"], rec[f"{name}/spatial_index"] = (
            np.int64(sp.data_index), np.int64(sp.spatial_index))
        for d in (1, 2, 4, 8, 16):
            for top, bottom in ((d, d), (d, 0), (0, d)):
                k = f"{name}/d{d}/{top},{bottom}"
                xl = _block(x, sp, 2).clone().requires_grad_()
                out = H.halo(xl, top, bottom, sp)
                cot = torch.randn(out.shape, dtype=torch.float64, generator=torch.Generator(
                ).manual_seed(1000 * d + 10 * top + bottom + 100000 * sp.rank))
                g, = torch.autograd.grad((out * cot).sum(), xl)
                rec.update({f"{k}/out": out, f"{k}/cot": cot, f"{k}/dx": g})


def case_sp_convs(inp, mesh, rec):
    """Each conv kind on the 2x2 mesh in float64 under `synced`, training-mode
    BN over the 4 ranks (nb1d_infer in eval mode): the output and dx (this
    rank's block), every parameter's gradient summed over the mesh and the
    running statistics."""
    if mesh.world != 4:
        return
    from mdilss_tpu_torch.models.blocks import (DownsamplerBlock, NonBottleneck1dAblation,
                                                UpsamplerBlock)
    from mdilss_tpu_torch.ops.nb1d_infer import nb1d_infer, prepare_operands

    sp = _sp_mesh(2)
    _where(sp, rec)
    for kind, c in inp["sp_convs"].items():
        if kind == "down":
            m, fn = DownsamplerBlock(16, 64, None), lambda m, t: m(t)
        elif kind == "up":
            m, fn = UpsamplerBlock(16, 8), lambda m, t: m(t)
        elif kind.startswith("ablation"):
            m = NonBottleneck1dAblation(16, c["d"], 1, "rcm")
            fn = lambda m, t: m(t, 0)  # noqa: E731
        elif kind.startswith("block"):
            m = NonBottleneck1dRAP(16, c["d"], 1)
            fn = lambda m, t: nb1d_train_apply(m, t, 0, 0.0, None, pairs=PLAIN_PAIRS)  # noqa
        else:
            m = NonBottleneck1dRAP(16, c["d"], 1)
            fn = lambda m, t: nb1d_infer(  # noqa: E731
                t.contiguous(memory_format=torch.channels_last),
                prepare_operands(m, 0, torch.float64), m.dilated)
        m = m.double()
        m.load_state_dict(c["state"])
        infer = kind.startswith("infer")
        m.train(not infer)
        x = _block(c["x"], sp, 2).clone().requires_grad_(not infer)
        params = dict(m.named_parameters())
        with synced(sp):
            out = fn(m, x)
            if not infer:
                g = torch.autograd.grad((out * _block(c["cot"], sp, 2)).sum(),
                                        [x, *params.values()], allow_unused=True)
                rec[f"{kind}/dx"] = g[0]
                rec.update({f"{kind}/grad/{k}": v for k, v in all_reduce_grads(
                    dict(zip(params, g[1:])), sp).items() if v is not None})
        rec[f"{kind}/out"] = out
        if not infer:
            rec.update({f"{kind}/state/{k}": v for k, v in m.state_dict().items()
                        if "running" in k})


@functools.lru_cache
def _sp_mesh(batch: int = GLOBAL_BATCH):
    """The spatial mesh of this world: 2x2 at world 4, 1x2 at world 2 (made
    once per batch size: every rank makes the same groups)."""
    return make_mesh(batch, spatial=2, device="cpu")


def _run_sp_step(inp, rec, kind: str, **kw) -> None:
    """One call of the step maker `kind` on this rank's block of the first
    global batch; the state and metrics after it."""
    sp = _sp_mesh()
    _where(sp, rec)
    task = 0 if kind == "ce" else 1
    student = _model(inp["student"], inp["classes"])
    lr = rap_lr_tree(student, current_task=task, shared_lr=SHARED_LR, ds_lr=DS_LR)
    common = dict(class_weight=inp["w"], lr_tree=lr, num_epochs=150, mesh=sp, **kw)
    if kind == "ce":
        step = steps.make_ce_step(task=0, iou_train=True, **common)
    else:
        make = steps.make_distill_step if kind == "distill" else steps.make_two_phase_distill_step
        step = make(current_task=1, prev_tasks=(0,), **common)
        teacher = _model(inp["teacher"], inp["teacher_classes"])
    ts = steps.init_train_state(student)
    x, y, mks = inp["batches"][0]
    xs = _block(torch.from_numpy(x), sp, 1)
    ys = _block(torch.from_numpy(y).long(), sp, 1)
    if kind == "ce":
        ts, m = step(ts, xs, ys, shard_dropout_masks(mks[0], sp), 1)
    else:
        ts, m = step(ts, teacher, xs, ys, [shard_dropout_masks(k, sp) for k in mks], 1)
    _record_state(rec, "step1", ts, m)


def case_sp_ce(inp, mesh, rec):
    _run_sp_step(inp["ce"], rec, "ce")


def case_sp_distill(inp, mesh, rec):
    _run_sp_step(inp["distill"], rec, "distill")


def case_sp_two_phase(inp, mesh, rec):
    _run_sp_step(inp["distill"], rec, "two_phase", iou_train=True)


def case_sp_distill_remat(inp, mesh, rec):
    if mesh.world == 4:
        _run_sp_step(inp["distill"], rec, "distill", remat=True, remat_prev=True)


def case_sp_distill_bf16(inp, mesh, rec):
    if mesh.world == 4:
        _run_sp_step(inp["distill"], rec, "distill", compute_dtype="bfloat16")


def case_sp_eval(inp, mesh, rec):
    sp = _sp_mesh()
    _where(sp, rec)
    e = inp["eval"]
    step = steps.make_eval_step(task=0, class_weight=inp["ce"]["w"], num_classes=6, mesh=sp)
    loss, cm = step(_model(inp["ce"]["student"], inp["ce"]["classes"]),
                    _block(torch.from_numpy(e["x"]), sp, 1),
                    _block(torch.from_numpy(e["y"]).long(), sp, 1))
    rec.update(loss=loss, cm=cm)


def case_sp_multichip_ce(inp, mesh, rec):
    """tests/test_multichip.py's CE step (a batch of 8 at 32x64, no
    dropout) on the 2x2 mesh."""
    if mesh.world != 4:
        return
    c = inp["multichip"]
    sp = _sp_mesh(8)
    _where(sp, rec)
    student = _model(c["student"], [6])
    lr = rap_lr_tree(student, current_task=0, shared_lr=5e-4, ds_lr=5e-4)
    step = steps.make_ce_step(task=0, class_weight=c["w"], lr_tree=lr, num_epochs=10, mesh=sp)
    ts, m = step(steps.init_train_state(student), _block(torch.from_numpy(c["x"]), sp, 1),
                 _block(torch.from_numpy(c["y"]).long(), sp, 1), None, 1)
    _record_state(rec, "step1", ts, m)


SP_TINY = dict(synthetic=True, synthetic_size=4, batch_size=2, height=32, width=64,
               num_workers=1, num_epochs=1)
# tests/test_torch_trainer.py's configs that raised before the spatial axis was ported
SP_CONFIGS = {"step3_rcm": ("step3", dict(model="erfnet_RCM")), "step1": ("step1", {}),
              "step2_remat": ("step2", dict(remat=True))}


def case_sp_trainer(inp, mesh, rec):
    """tests/test_multichip.py:181-195 on the 2x2 mesh: a step-2 Trainer
    epoch (8 synthetic images, a batch of 8 at 32x64) with the device
    cache."""
    from mdilss_tpu_torch.train.protocols import build_trainer

    cfg = C.step2(num_epochs=1, savedir=f"{inp['out']}/sp_trainer", synthetic=True,
                  synthetic_size=8, batch_size=8, height=32, width=64, num_workers=1,
                  device_cache="auto", spatial_shards=2)
    tr = build_trainer(cfg, device="cpu")
    _where(tr.mesh, rec)
    final = tr.fit()
    cache = tr._cache_for(cfg.datasets[1], "train")
    rec.update(final=np.array(repr(sorted((k, v) for k, v in final.items()
                                          if k != "epoch_seconds"))),
               train_loss=np.float64(final["train_loss"]),
               cache=np.array(type(cache).__name__), cache_meshed=np.bool_(
                   getattr(cache, "mesh", None) is not None))


def case_sp_configs(inp, mesh, rec):
    """The configs build their Trainer on the 2x2 mesh."""
    from mdilss_tpu_torch.train.protocols import build_trainer

    for name, (make, kw) in SP_CONFIGS.items():
        cfg = getattr(C, make)(savedir=f"{inp['out']}/sp_{name}", spatial_shards=2,
                               **SP_TINY, **kw)
        tr = build_trainer(cfg, device="cpu")
        rec.update({f"{name}/data": np.int64(tr.mesh.data),
                    f"{name}/spatial": np.int64(tr.mesh.spatial),
                    f"{name}/model": np.array(type(tr.ts.model).__name__)})


def case_sp_uneven(inp, mesh, rec):
    try:
        Trainer(C.step1(savedir=f"{inp['out']}/sp_uneven", spatial_shards=2,
                        **{**SP_TINY, "height": 40}), device="cpu")
        rec["error"] = np.array("")
    except ValueError as e:
        rec["error"] = np.array(str(e))


GROUPS = {
    "steps": (case_bn, case_nb1d, case_ce, case_distill, case_two_phase, case_distill_bf16,
              case_distill_remat, case_eval),
    "trainer": (case_cache, case_budget, case_gcd, case_fused),
    "spatial": (case_sp_halo, case_sp_convs, case_sp_ce, case_sp_distill, case_sp_two_phase,
                case_sp_distill_remat, case_sp_distill_bf16, case_sp_eval, case_sp_multichip_ce),
    "spatial_trainer": (case_sp_trainer, case_sp_configs, case_sp_uneven),
}


def main(group: str, inputs: str, out_dir: str) -> None:
    inp = torch.load(inputs, weights_only=False) if inputs != "-" else {}
    inp["out"] = out_dir
    mesh = make_mesh(GLOBAL_BATCH, device="cpu")
    if group in ("steps", "trainer"):
        assert mesh.world == 2 and mesh.data == 2, mesh
    out = {}
    for case in GROUPS[group]:
        rec: dict = {}
        case(inp, mesh, rec)
        out.update({f"{case.__name__[5:]}|{k}": _np(v) for k, v in rec.items()})
    np.savez(f"{out_dir}/{group}_rank{mesh.rank}.npz", **out)


if __name__ == "__main__":
    main(*sys.argv[1:])
