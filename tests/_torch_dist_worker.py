"""One rank of the port's data-parallel CPU tests (tests/test_torch_parallel.py,
tests/test_torch_parallel_trainer.py), under

    python -m torch.distributed.run --standalone --nproc_per_node 2 \
        tests/_torch_dist_worker.py GROUP INPUTS OUT_DIR

It imports the port only (never JAX), joins the gloo group through
`parallel.make_mesh`, runs every case of GROUP ("steps" or "trainer") on the
inputs the test wrote (`torch.save` of a dict), and writes this rank's
results to OUT_DIR/GROUP_rank<r>.npz (keys "case|name"), which the test
reads.
"""
import contextlib
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
                                       shard_rows)
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


GROUPS = {
    "steps": (case_bn, case_nb1d, case_ce, case_distill, case_two_phase, case_distill_bf16,
              case_distill_remat, case_eval),
    "trainer": (case_cache, case_budget, case_gcd, case_fused),
}


def main(group: str, inputs: str, out_dir: str) -> None:
    inp = torch.load(inputs, weights_only=False) if inputs != "-" else {}
    inp["out"] = out_dir
    mesh = make_mesh(GLOBAL_BATCH, device="cpu")
    assert mesh.world == 2 and mesh.data == 2, mesh
    out = {}
    for case in GROUPS[group]:
        rec: dict = {}
        case(inp, mesh, rec)
        out.update({f"{case.__name__[5:]}|{k}": _np(v) for k, v in rec.items()})
    np.savez(f"{out_dir}/{group}_rank{mesh.rank}.npz", **out)


if __name__ == "__main__":
    main(*sys.argv[1:])
