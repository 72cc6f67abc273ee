"""bf16 training of the port (compute_dtype="bfloat16") against the JAX
package's bf16 training on the CPU, the port's kernels as their plain
versions and JAX's Pallas kernels in interpret mode:

  * the K2 / K3 pairs (fwd_pair / bwd_pair, bf16 activations) against JAX's
    `fwd_pair` / `bwd_pair` in bf16;
  * the training block (nb1d_train_apply) against JAX's fused training block
    (`nb1d_fused_train_apply`, its Pallas pairs in interpret mode);
  * augment's bf16 images bit for bit JAX's `augment_batch(out_dtype=bf16)`;
  * the Trainer in bf16: its artifacts, and resume bitwise.

The tolerance is an error budget (`_torch_port.within_budget`): with ref the
port's float64 plain path (held to JAX at 1e-5 in float32 by
test_torch_nb1d_train.py and test_torch_train_step.py), every bf16 output of
the port satisfies rel_l2(port, ref) <= BF16_K * rel_l2(jax, ref) + BF16_EPS,
BF16_K = 1.5 and BF16_EPS = 1e-5. The weights and inputs are bf16 values, so
all three paths start from the same numbers. `pytest -s` prints each
output's errors and the direct port-vs-JAX relative L2. The bf16 steps are in
test_torch_bf16_steps.py (ERFNet-RAP step 2 and step 3) and
test_torch_bf16_models.py (the multi-head and ablation models), files of
their own: most of their time is JAX compiling.
"""
import copy
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_port import (bf16_exact, bf16_exact_tree, jax_augment_draws, randomize_bn, to_nchw,
                         within_budget)
from mdilss_tpu.data.transforms import augment_batch as jax_augment
from mdilss_tpu.models import blocks as B
from mdilss_tpu.ops.pallas.nb1d_train import bwd_pair, fwd_pair, make_nb1d_train
from mdilss_tpu_torch import config as C
from mdilss_tpu_torch.ckpt.convert import nb_block_state_dict
from mdilss_tpu_torch.data.transforms import augment_batch
from mdilss_tpu_torch.models import ERFNetRAP
from mdilss_tpu_torch.models.blocks import NonBottleneck1d, NonBottleneck1dRAP
from mdilss_tpu_torch.ops import nb1d_train as T
from mdilss_tpu_torch.train import steps
from mdilss_tpu_torch.train.loop import Trainer

torch.set_num_threads(1)
BF16 = torch.bfloat16
N, H, W = 2, 16, 32


def _cl(a: np.ndarray, dtype) -> torch.Tensor:
    """NHWC numpy -> NCHW channels_last torch tensor of `dtype`."""
    return to_nchw(a).to(dtype).contiguous(memory_format=torch.channels_last)


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().permute(0, 2, 3, 1).double().numpy()


def _f32(a) -> np.ndarray:
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


# ---- the pairs (K2, K3) ---------------------------------------------------------------------

PAIR_CASES = [(16, 1, False, False), (16, 2, True, True), (64, 2, True, True),
              (16, 4, False, True), (64, 1, True, False)]


@pytest.mark.parametrize("c,d,rap,pre", PAIR_CASES)
def test_bf16_pairs_within_budget_of_jax(c, d, rap, pre):
    """y and the stats of fwd_pair, du and every weight gradient of
    bwd_pair, from bf16 x and gy, against JAX's kernels in bf16."""
    rng = np.random.default_rng(10 * c + d)
    mk = lambda *s, scale=1.0: bf16_exact(rng.normal(size=s) * scale)  # noqa: E731
    x, gy = mk(N, H, W, c), mk(N, H, W, c)
    w31, b31, w13 = mk(3, 1, c, c, scale=0.125), mk(c, scale=0.125), mk(1, 3, c, c, scale=0.125)
    rapw = mk(c, c, scale=0.125) if rap else None
    pr = (np.abs(mk(c)), mk(c, scale=0.25)) if pre else None

    jx, jgy = jnp.asarray(x, jnp.bfloat16), jnp.asarray(gy, jnp.bfloat16)
    jw = [jnp.asarray(a) for a in (w31, b31, w13)]
    jrap = None if rapw is None else jnp.asarray(rapw)
    jpre = None if pr is None else tuple(map(jnp.asarray, pr))
    y_j, st_j = fwd_pair(jx, *jw, jrap, jpre, d=d, interpret=True)
    g_j = bwd_pair(jx, jgy, *jw, jrap, jpre, d=d, interpret=True)
    assert y_j.dtype == g_j[0].dtype == jnp.bfloat16

    def tw(a):  # HWIO -> torch OIHW
        return torch.from_numpy(np.ascontiguousarray(a.transpose(3, 2, 0, 1)))

    args = (tw(w31), torch.from_numpy(b31), tw(w13),
            None if rapw is None else torch.from_numpy(rapw),
            None if pr is None else tuple(map(torch.from_numpy, pr)))
    y, st = T.fwd_pair(_cl(x, BF16), *args, d)
    du, dw31, db31, dw13, drap = T.bwd_pair(_cl(x, BF16), _cl(gy, BF16), *args, d)
    assert y.dtype == du.dtype == BF16 and st.dtype == dw31.dtype == torch.float32
    assert y.is_contiguous(memory_format=torch.channels_last)

    a64 = [None if a is None else (tuple(t.double() for t in a) if isinstance(a, tuple)
                                   else a.double()) for a in args]
    y_r, st_r = T.fwd_pair_plain(_cl(x, torch.float64), *a64, d)
    r = T.bwd_pair_plain(_cl(x, torch.float64), _cl(gy, torch.float64), *a64, d)

    hwio = lambda t: t.detach().double().numpy().transpose(2, 3, 1, 0)  # noqa: E731
    within_budget("y", _nhwc(y), _f32(y_j), _nhwc(y_r))
    within_budget("stats", st.numpy(), _f32(st_j), st_r.numpy())
    within_budget("du", _nhwc(du), _f32(g_j[0]), _nhwc(r[0]))
    within_budget("dw31", hwio(dw31), _f32(g_j[1]), hwio(r[1]))
    within_budget("db31", db31.numpy(), _f32(g_j[2]), r[2].numpy())
    within_budget("dw13", hwio(dw13), _f32(g_j[3]), hwio(r[3]))
    if rap:
        within_budget("drap", drap.numpy(), _f32(g_j[4]), r[4].numpy())
    else:
        assert drap is None


# ---- the training block (K4 on the plain pairs) -----------------------------------------------

@pytest.mark.parametrize("c,d,rap,drop", [(16, 2, True, 0.3), (16, 1, False, 0.0)])
def test_bf16_train_block_within_budget_of_jax(c, d, rap, drop, monkeypatch):
    """The training block in bf16 against JAX's fused training block (its
    Pallas pairs in interpret mode) in bf16: output, the gradients of x and
    of every parameter under a random cotangent, the updated running
    statistics; the output bf16 and the dropout multiplier float32."""
    monkeypatch.setattr(B, "_fused_train_block",
                        lambda dd, use_rap, interp: make_nb1d_train(d=dd, use_rap=use_rap,
                                                                    interpret=True))
    rng = np.random.default_rng(c + d + rap)
    if rap:
        p, s = B.nb1d_rap_init(jax.random.key(3), c, d, 2)
        blk, task = NonBottleneck1dRAP(c, d, 2, drop), 1
    else:
        p, s = B.nb1d_init(jax.random.key(3), c, d)
        blk, task = NonBottleneck1d(c, d, drop), None
    p, s = randomize_bn(p, s, rng)
    p = bf16_exact_tree(p)
    blk.load_state_dict(nb_block_state_dict(p, s), strict=True)
    blk.train()
    x = bf16_exact(rng.normal(size=(N, H, W, c)))
    mask = rng.random((N, 1, 1, c)) < (1 - drop)
    cot = rng.normal(size=(N, H, W, c)).astype(np.float32)

    def jax_block(pp, xx):
        return B.nb1d_fused_train_apply(pp, s, xx, task=task, dilated=d, dropprob=drop,
                                        drop_mask=jnp.asarray(mask))

    jx = jnp.asarray(x, jnp.bfloat16)
    out_j, s_j = jax_block(p, jx)
    assert out_j.dtype == jnp.bfloat16
    gp_j, gx_j = jax.grad(
        lambda pp, xx: jnp.sum(jax_block(pp, xx)[0].astype(jnp.float32) * cot),
        argnums=(0, 1))(p, jx)

    keep, cot_t = torch.from_numpy(mask.reshape(N, c)), to_nchw(cot)
    runs, blk64 = {}, copy.deepcopy(blk).double()
    for name, b, dt, acc in (("port", blk, BF16, torch.float32),
                             ("ref", blk64, torch.float64, torch.float64)):
        xi = _cl(x, dt).requires_grad_()
        out = T.nb1d_train_apply(b, xi, task, drop, keep)
        grads = torch.autograd.grad((out.to(acc) * cot_t.to(acc)).sum(),
                                    [xi] + list(b.parameters()), allow_unused=True)
        runs[name] = (out, grads, b)
    out, grads, _ = runs["port"]
    assert out.dtype == BF16 and grads[0].dtype == BF16
    assert all(g is None or g.dtype == torch.float32 for g in grads[1:])

    names = [k for k, _ in blk.named_parameters()]
    want_grads = nb_block_state_dict(gp_j, None)

    def flat(gs, b):
        return np.concatenate([
            (np.zeros(tuple(prm.shape)) if g is None else g.double().numpy()).ravel()
            for g, prm in zip(gs, b.parameters())])

    def running(sd):
        return np.concatenate([v.double().numpy().ravel() for k, v in sorted(sd.items())
                               if "running" in k])

    within_budget("block out", _nhwc(out), _f32(out_j), _nhwc(runs["ref"][0]))
    within_budget("block dx", _nhwc(grads[0]), _f32(gx_j), _nhwc(runs["ref"][1][0]))
    within_budget("block dparams", flat(grads[1:], blk),
                  np.concatenate([want_grads[k].double().numpy().ravel() for k in names]),
                  flat(runs["ref"][1][1:], runs["ref"][2]))
    within_budget("block running stats", running(blk.state_dict()),
                  running(nb_block_state_dict(p, s_j)), running(runs["ref"][2].state_dict()))


# ---- augment and the Trainer ----------------------------------------------------------------

def test_augment_bf16_images_equal_jax():
    """augment_batch(out_dtype=bfloat16) bit for bit JAX's
    augment_batch(out_dtype=jnp.bfloat16) on the same draws; the labels as in
    float32."""
    rng = np.random.default_rng(4)
    imgs = rng.integers(0, 256, (3, 16, 24, 3), dtype=np.uint8)
    lbls = rng.integers(0, 256, (3, 16, 24), dtype=np.uint8)
    key = jax.random.key(7)
    x_j, y_j = jax_augment(jnp.asarray(imgs), jnp.asarray(lbls), key, num_classes=20,
                           out_dtype=jnp.bfloat16)
    flip, tx, ty = jax_augment_draws(key, 3)
    x, y = augment_batch(torch.from_numpy(imgs), torch.from_numpy(lbls), flip, tx, ty,
                         num_classes=20, out_dtype=BF16)
    x32, y32 = augment_batch(torch.from_numpy(imgs), torch.from_numpy(lbls), flip, tx, ty,
                             num_classes=20)
    assert x.dtype == BF16 and x_j.dtype == jnp.bfloat16
    np.testing.assert_array_equal(x.view(torch.int16).numpy(),
                                  np.asarray(x_j).view(np.int16))
    assert torch.equal(x, x32.to(BF16)) and torch.equal(y, y32)
    np.testing.assert_array_equal(y.numpy(), np.asarray(y_j))


TINY = dict(synthetic=True, synthetic_size=4, batch_size=2, height=32, width=64,
            num_workers=2, compute_dtype="bfloat16")


def test_trainer_bf16_artifacts_and_resume_bitwise(tmp_path):
    """The step-2 Trainer in bf16: its artifacts, float32 parameters, Adam
    state and checkpoints, bf16 augment and forwards; 2 epochs with a stop
    after the first and a resume bitwise equal to the straight run."""
    def teacher():
        torch.manual_seed(5)
        return ERFNetRAP([20], 1, device="cpu")

    kw = dict(num_epochs=2, iou_train=True, **TINY)
    a = Trainer(C.step2(savedir=str(tmp_path / "a"), **kw), teacher=teacher(), device="cpu")
    seen = []
    step = a.train_steps["BDD"]

    def spy(ts, tch, images, labels, masks, epoch):
        seen.append(images.dtype)
        return step(ts, tch, images, labels, masks, epoch)

    a.train_steps["BDD"] = spy
    final = a.fit()
    assert seen and set(seen) == {BF16}
    assert np.isfinite(final["train_loss"]) and np.isfinite(final["val_loss_BDD"])
    for f in ("opts.txt", "model.txt", "automated_log.txt", "best.txt", "metrics.jsonl"):
        assert (tmp_path / "a" / f).exists(), f
    assert json.loads((tmp_path / "a" / "opts.txt").read_text())["compute_dtype"] == "bfloat16"
    assert all(v.dtype in (torch.float32, torch.int64) for v in a.ts.model.state_dict().values())
    assert a.ts.opt.m.dtype == a.ts.opt.v.dtype == torch.float32
    ck = torch.load(tmp_path / "a" / "ckpt" / "2.pt", weights_only=False)
    assert all(v.dtype != BF16 for v in ck["state_dict"].values()
               if isinstance(v, torch.Tensor))

    Trainer(C.step2(savedir=str(tmp_path / "b"), **kw), teacher=teacher(), device="cpu").fit(
        stop_after=1)
    b = Trainer(C.step2(savedir=str(tmp_path / "b"), resume=True, **kw), teacher=teacher(),
                device="cpu")
    assert b.start_epoch == 2
    b.fit()
    sa, sb = a.ts.model.state_dict(), b.ts.model.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert torch.equal(a.ts.opt.m, b.ts.opt.m) and torch.equal(a.ts.opt.v, b.ts.opt.v)
    rows = [[json.loads(line) for line in (tmp_path / r / "metrics.jsonl").read_text().split("\n")
             if line] for r in ("a", "b")]
    for r in rows[0] + rows[1]:
        del r["epoch_seconds"]
    assert rows[0] == rows[1]
    assert ((tmp_path / "a" / "automated_log.txt").read_text()
            == (tmp_path / "b" / "automated_log.txt").read_text())


def test_what_trains_in_bf16_and_what_raises(tmp_path):
    """compute_dtype takes float32 and bfloat16 (names or torch dtypes); float16
    and float64 raise ValueError in the step makers and the Trainer."""
    assert steps.compute_dtype_of("bfloat16") is BF16
    assert steps.compute_dtype_of(torch.float32) is torch.float32
    for bad in ("float16", torch.float16, "float64"):
        with pytest.raises(ValueError, match="float32 or bfloat16"):
            steps.make_ce_step(task=0, class_weight=np.ones(3, np.float32), lr_tree={},
                               num_epochs=1, compute_dtype=bad)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        Trainer(C.step1(savedir=str(tmp_path / "h"), **{**TINY, "compute_dtype": "float16"}),
                device="cpu")
