"""The port's multi-head and single-task models (mdilss_tpu_torch/models/
erfnet_multihead.py, erfnet.py) and their LR dicts and CE steps
(train/masks.py `multihead_lr_tree`, the ft / fe / multitask settings of the
Trainer) against the JAX package's (models/erfnet_multihead.py, erfnet.py,
train/masks.py, train/steps.py) on the CPU, on the same weights (JAX's init
with random BN, exported by `mdilss_tpu.ckpt.export_state_dict` and loaded
with strict=True), inputs and dropout masks (2x32x64)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_port import randomize_bn, rel_l2
from mdilss_tpu.ckpt import export_state_dict
from mdilss_tpu.models import erfnet as jerfnet
from mdilss_tpu.models import erfnet_multihead as jmh
from mdilss_tpu.train import masks as jmasks
from mdilss_tpu.train import steps as jsteps
from mdilss_tpu_torch.models import ERFNet, ERFNetMultiHead
from mdilss_tpu_torch.models.topology import make_dropout_masks
from mdilss_tpu_torch.train import steps
from mdilss_tpu_torch.train.masks import multihead_lr_tree

torch.set_num_threads(1)

LR = 5e-4
CLASSES = {"erfnet": [6], "multi_task": [6, 7, 8], "ftp1": [6, 7], "ftp2": [6, 7, 8]}


def _sd(params, bn, kind) -> dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.array(v)) for k, v in
            export_state_dict(params, bn, kind=kind).items()}


def _jax_model(kind, seed, rng):
    nc = CLASSES[kind]
    if kind == "erfnet":
        return randomize_bn(*jerfnet.init(jax.random.key(seed), nc[0]), rng)
    return randomize_bn(*jmh.init(jax.random.key(seed), nc), rng)


def _port_model(kind, params, bn):
    nc = CLASSES[kind]
    model = ERFNet(nc[0], device="cpu") if kind == "erfnet" else ERFNetMultiHead(
        nc, kind=kind, device="cpu")
    model.load_state_dict(_sd(params, bn, kind), strict=True)
    return model


@pytest.mark.parametrize("kind", list(CLASSES))
def test_eval_logits_match_jax(kind):
    """Every head's eval logits within 1e-5 rel L2 of `erfnet.apply` /
    `erfnet_multihead.apply`, on `export_state_dict(kind=...)` weights that
    load with strict=True; the heads in the kind's grammar."""
    rng = np.random.default_rng(0)
    params, bn = _jax_model(kind, 1, rng)
    model = _port_model(kind, params, bn)
    heads = {"erfnet": ["decoder"], "multi_task": ["decoder.0", "decoder.1", "decoder.2"],
             "ftp1": ["decoder_old", "decoder_new"],
             "ftp2": ["decoder_old1", "decoder_old2", "decoder_new"]}[kind]
    assert model.head_prefixes == heads
    x = rng.standard_normal((2, 32, 64, 3), dtype=np.float32)
    if kind == "erfnet":
        fwd = jax.jit(lambda p, s, x_, t: jerfnet.apply(p, s, x_)[0], static_argnums=3)
    else:
        fwd = jax.jit(lambda p, s, x_, t: jmh.apply(p, s, x_, t)[0], static_argnums=3)
    for t in range(len(CLASSES[kind])):
        want = fwd(params, bn, jnp.asarray(x), t)
        got = model(torch.from_numpy(x), t)
        assert got.shape == (2, 32, 64, CLASSES[kind][t])
        assert rel_l2(got.numpy(), np.asarray(want)) <= 1e-5, (kind, t)
    with pytest.raises(IndexError):
        model(torch.from_numpy(x), len(CLASSES[kind]))


# protocol -> (kind, task trained, encoder LR, the heads' LRs), as the Trainer sets them
CE_CASES = {
    "ft": ("ftp1", 1, LR, [0.0, LR]),
    "fe": ("ftp2", 2, 0.0, [0.0, 0.0, LR]),
    "multitask": ("multi_task", 1, LR / 3, [LR, LR, LR]),
}


@pytest.mark.parametrize("protocol", list(CE_CASES))
def test_ce_step_matches_jax(protocol, tmp_path):
    """One CE step of the ft, fe and multitask settings: the LR dict equal to
    JAX's `multihead_lr_tree` element for element and to the Trainer's; the
    loss within 1e-4 relative, the running statistics 1e-4 rel L2, each
    parameter within 2 lr of JAX's (Adam's first step is lr * sign(g)), the
    frozen ones bitwise unchanged."""
    from mdilss_tpu_torch import config as C
    from mdilss_tpu_torch.train.loop import Trainer

    kind, task, enc_lr, dec_lrs = CE_CASES[protocol]
    rng = np.random.default_rng(3)
    params, bn = _jax_model(kind, 2, rng)
    model = _port_model(kind, params, bn)
    lr = multihead_lr_tree(model, encoder_lr=enc_lr, decoder_lrs=dec_lrs)
    jlr = jmasks.multihead_lr_tree(params, encoder_lr=enc_lr, decoder_lrs=dec_lrs)
    wide = jax.tree.map(lambda a, p: np.broadcast_to(np.asarray(a, np.float32), p.shape),
                        jlr, params)
    for k, v in export_state_dict(wide, bn, kind=kind).items():
        if k in lr:
            assert np.all(v == np.float32(lr[k])), k
    assert set(lr) == {k for k, _ in model.named_parameters()}

    # the Trainer's LR dict for the protocol is the same
    nc = CLASSES[kind]
    datasets = ("cityscapes", "BDD", "IDD")[:len(nc)]
    tiny = dict(synthetic=True, synthetic_size=2, batch_size=2, height=32, width=64,
                num_workers=1, datasets=datasets, num_classes=tuple(nc),
                savedir=str(tmp_path / "run"))
    cfg = (C.multitask(**tiny) if protocol == "multitask" else
           C.ft_step(n_heads=len(nc), finetune=protocol == "ft", **tiny))
    assert Trainer(cfg, device="cpu")._lr_tree() == lr

    w = (rng.random(nc[task]) * 5 + 0.5).astype(np.float32)
    w[-1] = 0.0
    x = rng.standard_normal((2, 32, 64, 3), dtype=np.float32)
    y = rng.integers(0, nc[task], (2, 32, 64)).astype(np.int32)
    mk = make_dropout_masks(rng, 2)
    jstep = jax.jit(jsteps.make_ce_step(jmh.apply, task=task, class_weight=jnp.asarray(w),
                                        lr_tree=jlr, num_epochs=150))
    jts, jm = jstep(jsteps.init_train_state(params, bn), jnp.asarray(x), jnp.asarray(y), mk,
                    None, 1)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    step = steps.make_ce_step(task=task, class_weight=w, lr_tree=lr, num_epochs=150)
    ts, m = step(steps.init_train_state(model), torch.from_numpy(x),
                 torch.from_numpy(y).long(), mk, 1)
    for k in ("loss", "ce"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-4, err_msg=k)
    got = model.state_dict()
    moved = 0
    for k, v in _sd(jts.params, jts.bn, kind).items():
        if "num_batches_tracked" in k:
            continue
        if "running" in k:
            assert rel_l2(got[k].numpy(), v.numpy()) <= 1e-4, k
        elif lr[k] == 0.0:
            assert torch.equal(got[k], before[k]), k
        else:
            np.testing.assert_allclose(got[k].numpy(), v.numpy(), atol=2 * lr[k] + 1e-6,
                                       err_msg=k)
            moved += not torch.equal(got[k], before[k])
    assert moved > 0 and ts.opt.count == 1
