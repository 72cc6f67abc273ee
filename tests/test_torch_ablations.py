"""The port's four ablation models (mdilss_tpu_torch/models/erfnet_ablations.py,
the `NonBottleneck1dAblation` block, the weight bridge, surgery, the LR dict,
the kernel wrappers' guard and the CLI) against the JAX package's
reconstructions (mdilss_tpu/models/erfnet_ablations.py, blocks.py
`nb1d_ablation_apply`, ckpt/surgery.py, train/masks.py `ablation_lr_tree`) on
the CPU, on JAX-initialised weights with random BN and, for RCM, random
non-symmetric matrices Wt (its identity init would hide a transposed Wt).

Tolerances: one block, eval and training, 1e-5 elementwise (float32 in two
summation orders); the whole model's eval logits and features 1e-5 relative
L2. The whole model in training mode is held at 5e-4 relative L2: batch-
statistics BN over the 2x8x16 bottleneck map amplifies float32 rounding
through ~40 layers, and at this size the port's own float32 training logits
differ from its float64 ones by ~1e-4 relative L2, as do JAX's (JAX's
training BN computes in float32 even in a float64 forward, so the two cannot
be compared in float64). The running statistics that training writes are
held at 1e-5. What both packages do bit for bit (the bridge, surgery, the LR
dict) is compared bit for bit. The Trainer-level parity (build_trainer, a
step-2 step, evaluation and export against JAX) is in
tests/test_torch_ablations_jax.py."""
import copy
import dataclasses
import json
import os
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_port import ABLATION_VARIANTS as VARIANTS
from _torch_port import ablation_jax_model as jax_model
from _torch_port import ablation_port_model as port_model
from _torch_port import random_wt, randomize_bn, rel_l2
from mdilss_tpu.ckpt import surgery as jsurgery
from mdilss_tpu.models import erfnet_ablations as A
from mdilss_tpu.models.blocks import nb1d_ablation_apply, nb1d_ablation_init
from mdilss_tpu.models.topology import make_dropout_masks
from mdilss_tpu.train import masks as jmasks
from mdilss_tpu_torch import config as C
from mdilss_tpu_torch.ckpt import from_jax, params_from_jax, surgery, torch_io
from mdilss_tpu_torch.ckpt.convert import nb_block_state_dict
from mdilss_tpu_torch.cli import main as cli_main
from mdilss_tpu_torch.models import ERFNetAblation, blocks
from mdilss_tpu_torch.models.blocks import NonBottleneck1dAblation
from mdilss_tpu_torch.models.erfnet_ablations import REFERENCE_NAMES
from mdilss_tpu_torch.ops.nb1d_infer import prepare_operands
from mdilss_tpu_torch.ops.nb1d_train import nb1d_train_apply
from mdilss_tpu_torch.train import steps
from mdilss_tpu_torch.train.loop import Trainer
from mdilss_tpu_torch.train.masks import ablation_lr_tree, rap_lr_tree

torch.set_num_threads(1)

MODEL = {v: k for k, v in REFERENCE_NAMES.items()}
NC = [5, 7]
H, W = 64, 128
SHARED_LR, DS_LR = 5e-6, 5e-4
TOL_TRAIN_MODEL = 5e-4  # the module docstring gives the float32 floor


def _slot(t: int) -> re.Pattern:
    """Task `t`'s slice of an encoder entry."""
    return re.compile(
        rf"\.(bn_ini|bns_[12]|parallel_conv_[12]|series_conv_[12]|Wt_[12])\.{t}(\.|$)")


@pytest.mark.parametrize("variant", VARIANTS)
def test_parameter_surface_and_bridge(variant):
    """Each variant has its domain-specific family in the port's grammar; the
    bridge writes exactly the model's keys (strict load), RCM's Wt in JAX's
    (in, out) orientation, and params_from_jax its parameter entries."""
    params, state = jax_model(variant, NC, 0)
    sd = from_jax(params, state)
    model = ERFNetAblation(NC, 2, variant, device="cpu")
    assert set(model.state_dict()) == set(sd)
    model.load_state_dict(sd, strict=True)
    per_task_bn = variant != "onlyrap"
    has = {k: k in sd for k in (
        "encoder.layers.3.parallel_conv_1.1.weight", "encoder.layers.3.series_conv_2.0.bias",
        "encoder.layers.3.Wt_1.1", "encoder.layers.3.bns_1.1.weight",
        "encoder.layers.3.bn1.weight",
        "encoder.initial_block.bn_ini.1.running_var", "encoder.initial_block.bn.running_var",
        "encoder.layers.6.bn_ini.0.weight")}
    assert has == {
        "encoder.layers.3.parallel_conv_1.1.weight": variant == "onlyrap",
        "encoder.layers.3.series_conv_2.0.bias": variant == "ras",
        "encoder.layers.3.Wt_1.1": variant == "rcm",
        "encoder.layers.3.bns_1.1.weight": per_task_bn,
        "encoder.layers.3.bn1.weight": not per_task_bn,
        "encoder.initial_block.bn_ini.1.running_var": per_task_bn,
        "encoder.initial_block.bn.running_var": not per_task_bn,
        "encoder.layers.6.bn_ini.0.weight": per_task_bn}
    assert not any("parallel_conv" in k or "series_conv" in k or "Wt_" in k or "bns_" in k
                   for k in sd if k.startswith("decoder."))
    if variant == "rcm":  # layer 3 is group64 block 2; layer 9 is group128 rep 0, d8
        np.testing.assert_array_equal(sd["encoder.layers.3.Wt_1.1"].numpy(),
                                      np.asarray(params["encoder"]["group64"]["wt1"][2, 1]))
        g128 = params["encoder"]["group128"]
        np.testing.assert_array_equal(sd["encoder.layers.9.Wt_2.0"].numpy(),
                                      np.asarray(g128["d8"]["wt2"][0, 0]))
    got = params_from_jax(params)
    assert set(got) == {k for k, _ in model.named_parameters()}
    for k, v in got.items():
        assert torch.equal(v, sd[k]), k


def test_rcm_at_identity_equals_the_bn_block():
    """RCM's matrices start at the identity, so its block equals the bn block
    with the same convs and BN bit for bit, in eval and in training."""
    torch.manual_seed(0)
    bn = NonBottleneck1dAblation(16, 2, 2, "bn", dropprob=0.3)
    rcm = NonBottleneck1dAblation(16, 2, 2, "rcm", dropprob=0.3)
    for m in (bn, rcm):
        for b in m.modules():
            if isinstance(b, torch.nn.BatchNorm2d):
                torch.nn.init.uniform_(b.weight, 0.5, 1.5)
                torch.nn.init.normal_(b.bias, 0.0, 0.1)
    sd = bn.state_dict()
    rcm.load_state_dict({**rcm.state_dict(), **sd}, strict=True)
    assert all(torch.equal(p, torch.eye(16)) for k, p in rcm.named_parameters() if "Wt_" in k)
    x = torch.randn(2, 16, 12, 20)
    mask = torch.rand(2, 16) < 0.7
    for training in (False, True):
        a, b = copy.deepcopy(bn).train(training), copy.deepcopy(rcm).train(training)
        torch.testing.assert_close(a(x, 1, mask), b(x, 1, mask), rtol=0, atol=0)
        assert all(torch.equal(v, b.state_dict()[k]) for k, v in a.state_dict().items())


@pytest.mark.parametrize("training", [False, True])
@pytest.mark.parametrize("variant", VARIANTS)
def test_block_matches_jax(variant, training):
    """One C=64, d=2 block of task 1, random BN (and Wt), host dropout mask in
    training: the output and the updated running statistics 1e-5
    elementwise."""
    rng = np.random.default_rng(1)
    p, s = nb1d_ablation_init(jax.random.key(1), 64, 2, 2, variant)
    p, s = randomize_bn(p, s, rng)
    p = random_wt(p, rng)
    x = rng.standard_normal((2, 16, 32, 64)).astype(np.float32)
    keep = rng.random((2, 1, 1, 64)) < 0.7
    want, new_s = nb1d_ablation_apply(p, s, jnp.asarray(x), variant=variant, task=1, dilated=2,
                                      dropprob=0.3, training=training,
                                      drop_mask=jnp.asarray(keep) if training else None)
    block = NonBottleneck1dAblation(64, 2, 2, variant, dropprob=0.3)
    block.load_state_dict(nb_block_state_dict(p, s), strict=True)
    block.train(training)
    with torch.no_grad():
        got = block(torch.from_numpy(x).permute(0, 3, 1, 2), 1,
                    torch.from_numpy(keep.reshape(2, 64)) if training else None)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)
    want_sd = nb_block_state_dict(p, new_s)
    for k, v in block.state_dict().items():
        if "running" in k:
            np.testing.assert_allclose(v.numpy(), want_sd[k].numpy(), rtol=0, atol=1e-5,
                                       err_msg=k)


@pytest.mark.parametrize("variant", VARIANTS)
def test_model_matches_jax(variant):
    """Eval logits of both heads and the features of head 1 (the t-SNE tool's
    input) 1e-5 relative L2; training mode with host dropout masks: logits
    TOL_TRAIN_MODEL, every updated running statistic 1e-5, and only head 1's
    slices and decoder move."""
    params, state = jax_model(variant, NC, 2)
    model = port_model(variant, params, state)
    rng = np.random.default_rng(3)
    x = rng.random((2, H, W, 3), dtype=np.float32)
    for task in (0, 1):
        want, _, feats = A.apply(params, state, jnp.asarray(x), task, variant=variant,
                                 return_features=True)
        got, got_feats = model(torch.from_numpy(x), task, return_features=True)
        assert got.shape == (2, H, W, NC[task])
        assert rel_l2(got.numpy(), want) <= 1e-5
        for k in ("encoder", "penultimate"):
            assert rel_l2(got_feats[k].numpy(), feats[k]) <= 1e-5, k
    masks = make_dropout_masks(rng, 2)
    want, new_state = A.apply(params, state, jnp.asarray(x), 1, variant=variant, training=True,
                              drop_masks=masks)
    train = copy.deepcopy(model).train()
    got = train(torch.from_numpy(x), 1, masks)
    assert got.requires_grad
    assert rel_l2(got.detach().numpy(), want) <= TOL_TRAIN_MODEL
    want_sd, before = from_jax(params, new_state), model.state_dict()
    moved = set()
    for k, v in train.state_dict().items():
        if "running" in k:
            assert rel_l2(v.numpy(), want_sd[k].numpy()) <= 1e-5, k
            if not torch.equal(v, before[k]):
                moved.add(k)
    shared = {k for k in moved if not (k.startswith("decoder.1.") or _slot(1).search(k))}
    assert moved and bool(shared) == (variant == "onlyrap"), shared


@pytest.mark.parametrize("variant", VARIANTS)
def test_ablation_lr_tree_matches_jax(variant):
    """{name: LR} equal to JAX's tree name by name (each JAX leaf one value
    over the parameter), with JAX's two judgment calls: onlyrap's shared BN at
    shared_lr, ras's old-task adapters frozen."""
    classes = [6, 6, 6]
    params, _ = A.init(jax.random.key(0), classes, 3, variant=variant)
    model = ERFNetAblation(classes, 3, variant, device="cpu")
    for cur in (1, 2):
        jl = jmasks.ablation_lr_tree(params, variant=variant, current_task=cur,
                                     shared_lr=SHARED_LR, ds_lr=DS_LR)
        want = params_from_jax(jax.tree.map(
            lambda lr, p: np.broadcast_to(np.asarray(lr, np.float32), p.shape), jl, params))
        got = ablation_lr_tree(model, variant=variant, current_task=cur, shared_lr=SHARED_LR,
                               ds_lr=DS_LR)
        assert set(got) == set(want)
        for k, v in want.items():
            v = v.numpy()
            assert (v == v.flat[0]).all() and np.float32(got[k]) == v.flat[0], (cur, k)
    if variant == "onlyrap":
        assert got["encoder.layers.2.bn1.weight"] == got["encoder.initial_block.bn.bias"] \
            == SHARED_LR
    if variant == "ras":
        assert got["encoder.layers.2.series_conv_1.0.weight"] == 0.0
        assert got["encoder.layers.2.series_conv_1.2.weight"] == DS_LR
        # the RAP rule would train them with the shared convs
        assert rap_lr_tree(model, current_task=2, shared_lr=SHARED_LR, ds_lr=DS_LR)[
            "encoder.layers.2.series_conv_1.0.weight"] == SHARED_LR
    if variant == "rcm":
        assert got["encoder.layers.2.Wt_2.1"] == 0.0 and got["encoder.layers.2.Wt_2.2"] == DS_LR
    with pytest.raises(ValueError, match="variant"):
        ablation_lr_tree(model, variant="bn" if variant != "bn" else "rcm", current_task=1,
                         shared_lr=SHARED_LR, ds_lr=DS_LR)


def _jax_keep(params, state, n: int):
    """JAX's pytree of the first `n` tasks: the task axis is 0 on the
    downsamplers' per-task BN and 1 on grouped leaves
    (mdilss_tpu/ckpt/surgery.py:55-56)."""
    ds_keys = ("bns1", "bns2", "rap1", "rap2", "ser1", "ser2", "wt1", "wt2")

    def group(p, s):
        return ({k: jax.tree.map(lambda a: a[:, :n], v) if k in ds_keys else v
                 for k, v in p.items()},
                {k: jax.tree.map(lambda a: a[:, :n], v) if k in ds_keys else v
                 for k, v in s.items()})

    enc_p, enc_s = dict(params["encoder"]), dict(state["encoder"])
    for seg in ("initial", "down1", "down2"):
        if np.ndim(enc_p[seg]["bn"]["scale"]) == 2:
            enc_p[seg] = {**enc_p[seg], "bn": jax.tree.map(lambda a: a[:n], enc_p[seg]["bn"])}
            enc_s[seg] = {"bn": jax.tree.map(lambda a: a[:n], enc_s[seg]["bn"])}
    enc_p["group64"], enc_s["group64"] = group(enc_p["group64"], enc_s["group64"])
    g = {d: group(enc_p["group128"][d], enc_s["group128"][d]) for d in enc_p["group128"]}
    enc_p["group128"] = {d: v[0] for d, v in g.items()}
    enc_s["group128"] = {d: v[1] for d, v in g.items()}
    return ({"encoder": enc_p, "decoders": params["decoders"][:n]},
            {"encoder": enc_s, "decoders": state["decoders"][:n]})


@pytest.mark.parametrize("variant", VARIANTS)
def test_extend_and_keep_tasks_match_jax(variant):
    """extend_for_new_task bit for bit JAX's (but the new head's drawn
    output_conv): the new slot's affine and adapters (RCM's Wt too) from slot
    t-1, its running statistics fresh, onlyrap's shared BN untouched; and
    keep_tasks of a 3-task model bit for bit JAX's pytree of 2 tasks."""
    params, state = jax_model(variant, [6, 7], 4)
    sd = from_jax(params, state)
    want = from_jax(*jsurgery.extend_for_new_task(params, state, 8, jax.random.key(5)))
    got = surgery.extend_for_new_task({"module." + k: v for k, v in sd.items()}, 8,
                                      generator=torch.Generator().manual_seed(6))
    head = ("decoder.2.output_conv.weight", "decoder.2.output_conv.bias")
    assert set(got) == set(want)
    for k, v in want.items():
        if k not in head:
            assert torch.equal(got[k], v), k
    ERFNetAblation([6, 7, 8], 3, variant, device="cpu").load_state_dict(got, strict=True)
    if variant == "rcm":
        assert torch.equal(got["encoder.layers.4.Wt_1.2"], sd["encoder.layers.4.Wt_1.1"])
        assert not torch.equal(got["encoder.layers.4.Wt_1.2"], torch.eye(64))
    if variant == "onlyrap":
        assert torch.equal(got["encoder.layers.4.bn2.running_mean"],
                           sd["encoder.layers.4.bn2.running_mean"])
        assert torch.equal(got["encoder.layers.4.parallel_conv_2.2.bias"],
                           sd["encoder.layers.4.parallel_conv_2.1.bias"])
    else:
        assert torch.equal(got["encoder.layers.4.bns_2.2.running_var"], torch.ones(64))
        assert torch.equal(got["encoder.layers.4.bns_2.2.weight"],
                           sd["encoder.layers.4.bns_2.1.weight"])
    three = from_jax(*jax_model(variant, [6, 7, 8], 7))
    kept = surgery.keep_tasks(three, 2)
    want = from_jax(*_jax_keep(*jax_model(variant, [6, 7, 8], 7), 2))
    assert set(kept) == set(want)
    assert all(torch.equal(kept[k], v) for k, v in want.items())


@pytest.mark.parametrize("variant", VARIANTS)
def test_training_task_1_leaves_task_0_bitwise(variant):
    """One CE step of task 1 with the shared convs frozen (shared_lr 0) leaves
    task 0's eval logits bit for bit; not so for onlyrap, whose shared BN's
    running statistics every task's training forward moves. Perturbing task
    1's slices alone leaves task 0 bitwise in every variant."""
    params, state = jax_model(variant, [5, 5], 8)
    model = port_model(variant, params, state)
    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.random((2, 32, 64, 3), dtype=np.float32))
    y = torch.from_numpy(rng.integers(0, 5, (2, 32, 64)))
    before = model(x, 0)
    lr = ablation_lr_tree(model, variant=variant, current_task=1, shared_lr=0.0, ds_lr=DS_LR)
    step = steps.make_ce_step(task=1, class_weight=np.ones(5, np.float32), lr_tree=lr,
                              num_epochs=150)
    ts = steps.init_train_state(model)
    p0 = {k: p.detach().clone() for k, p in model.named_parameters()}
    ts, _ = step(ts, x, y, make_dropout_masks(rng, 2), 1)
    moved = [k for k, p in model.named_parameters() if not torch.equal(p, p0[k])]
    assert moved and all(k.startswith("decoder.1.") or _slot(1).search(k) for k in moved)
    model.eval()
    after = model(x, 0)
    assert torch.equal(before, after) == (variant != "onlyrap")
    with torch.no_grad():
        for k, p in model.named_parameters():
            if _slot(1).search(k):
                p.add_(0.7)
    assert torch.equal(model(x, 0), after)


def test_only_the_decoder_blocks_reach_the_kernel_wrappers(monkeypatch):
    """The ablation encoder's blocks run their own forward: an eval forward
    reaches the inference kernel's wrapper from the decoder's 4 nb1d blocks
    only, a training forward the training wrapper likewise; and the wrappers
    refuse an ablation block (onlyrap's has parallel_conv_k, which must not
    pass for a RAP block's)."""
    calls = {"infer": 0, "train": 0}

    def counting(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(blocks, "nb1d_infer", counting("infer", blocks.nb1d_infer))
    monkeypatch.setattr(blocks, "nb1d_train_apply", counting("train", blocks.nb1d_train_apply))
    x = torch.rand(2, 32, 64, 3)
    for variant in VARIANTS:
        model = ERFNetAblation(NC, 2, variant, device="cpu")
        calls.update(infer=0, train=0)
        model(x, 1)
        model.train()(x, 1, make_dropout_masks(np.random.default_rng(0), 2)).sum().backward()
        assert calls == {"infer": 4, "train": 4}, (variant, calls)
        block = model.encoder.layers[1]
        assert isinstance(block, NonBottleneck1dAblation)
        with pytest.raises(ValueError, match="ablation block"):
            prepare_operands(block, 1, torch.float32)
        with pytest.raises(ValueError, match="ablation block"):
            nb1d_train_apply(block, torch.rand(2, 64, 8, 16), 1)


def test_what_an_ablation_model_refuses(tmp_path):
    """fused_train with an ablation model raises ("fused"), as the JAX
    package's encoder does; an ablation kind from a `.pth.tar` raises naming
    the missing torch grammar, through load_state, load_checkpoint,
    export_checkpoint and build_trainer; a multi-head protocol refuses an
    ablation model."""
    from mdilss_tpu_torch.evaluate import load_checkpoint
    from mdilss_tpu_torch.serving import export_checkpoint
    from mdilss_tpu_torch.train.protocols import build_trainer

    tiny = dict(synthetic=True, synthetic_size=2, batch_size=2, height=32, width=64,
                num_workers=0, num_epochs=1)
    with pytest.raises(ValueError, match="fused"):
        Trainer(C.step1(model="erfnet_RCM", fused_train=True, savedir=str(tmp_path / "a"),
                        **tiny), device="cpu")
    path = str(tmp_path / "m.pth.tar")
    model = ERFNetAblation([5], 1, "bn", device="cpu")
    torch.save({"state_dict": {"module." + k: v for k, v in model.state_dict().items()}}, path)
    grammar = "no torch checkpoint grammar"
    with pytest.raises(ValueError, match=grammar):
        torch_io.load_state(path, "erfnet_bn")
    with pytest.raises(ValueError, match=grammar):
        load_checkpoint(path, kind="erfnet_bn", device="cpu")
    with pytest.raises(ValueError, match=grammar):
        export_checkpoint(path, kind="erfnet_bn", out_dir=str(tmp_path / "s"),
                          platforms=("cpu",))
    with pytest.raises(ValueError, match=grammar):
        build_trainer(C.step2(model="erfnet_bn", state=path, savedir=str(tmp_path / "b"),
                              **tiny), device="cpu")
    cfg = C.multitask(savedir=str(tmp_path / "c"), **tiny)
    with pytest.raises(ValueError, match="protocol 'multitask' with model 'erfnet_onlyRAP'"):
        Trainer(dataclasses.replace(cfg, model="erfnet_onlyRAP"), device="cpu")


# ---- the command line: step1 -> step2 -> step3 --model erfnet_RCM, then the analysis tools ----
CLI_TINY = ["--height", "32", "--width", "64", "--batch-size", "2", "--num-epochs", "1",
            "--synthetic", "--synthetic-size", "4", "--num-workers", "0", "--no-device-cache",
            "--device", "cpu"]
CLI_EVAL = ["--synthetic", "--height", "32", "--width", "64", "--device", "cpu"]


@pytest.fixture(scope="module")
def rcm_chain(tmp_path_factory):
    root = tmp_path_factory.mktemp("ablation_chain")
    cli_main(["step1", "--model", "erfnet_RCM", "--savedir", str(root / "step1")] + CLI_TINY)
    cli_main(["step2", "--model", "erfnet_RCM", "--state", str(root / "step1" / "best"),
              "--savedir", str(root / "step2")] + CLI_TINY)
    cli_main(["step3", "--model", "erfnet_RCM", "--state", str(root / "step2" / "best"),
              "--savedir", str(root / "step3")] + CLI_TINY)
    return root


def _last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_cli_rcm_chain(rcm_chain):
    """The chain's checkpoints hold the RCM model of 1, 2 and 3 tasks; in
    each step every LR-0 parameter (the old tasks' slices and heads) is
    bit for bit the previous step's, and the current task's Wt moved."""
    from mdilss_tpu_torch.evaluate import infer_num_classes

    for stage, nc in (("step1", [20]), ("step2", [20, 20]), ("step3", [20, 20, 27])):
        opts = json.loads((rcm_chain / stage / "opts.txt").read_text())
        assert opts["model"] == "erfnet_RCM" and opts["protocol"] == stage
        assert infer_num_classes(str(rcm_chain / stage / "best")) == nc
    for prev, cur, task in (("step1", "step2", 1), ("step2", "step3", 2)):
        a = torch_io.load_state(str(rcm_chain / prev / "best"), "erfnet_RCM")
        b = torch_io.load_state(str(rcm_chain / cur / "best"), "erfnet_RCM")
        model = ERFNetAblation([20, 20, 27][:task + 1], task + 1, "rcm", device="cpu")
        lr = ablation_lr_tree(model, variant="rcm", current_task=task, shared_lr=SHARED_LR,
                              ds_lr=DS_LR)
        frozen = [k for k, v in lr.items() if v == 0.0]
        assert frozen and all(torch.equal(a[k], b[k]) for k in frozen)
        wt = f"encoder.layers.8.Wt_1.{task}"
        assert not torch.equal(b[wt], a[f"encoder.layers.8.Wt_1.{task - 1}"])


def test_cli_eval_predict_tsne_export_rcm(rcm_chain, tmp_path, capsys):
    """eval, predict, tsne and export --kind erfnet_RCM of step3/best; the
    exported head serves the in-process forward's logits; an ablation kind on
    a file exits naming the missing grammar."""
    from mdilss_tpu_torch import serving
    from mdilss_tpu_torch.evaluate import load_checkpoint

    best = str(rcm_chain / "step3" / "best")
    capsys.readouterr()
    cli_main(["eval", best, "--kind", "erfnet_RCM", "--datasets", "cityscapes", "BDD", "IDD"]
             + CLI_EVAL)
    res = _last_json(capsys)
    assert set(res) == {"cityscapes", "BDD", "IDD"} and all(0 <= v <= 1 for v in res.values())
    cli_main(["predict", best, "--kind", "erfnet_RCM", "--task", "2", "--dataset", "IDD",
              "--out-dir", str(tmp_path / "pred"), "--max-images", "2"] + CLI_EVAL)
    assert _last_json(capsys) == {"written": 2, "out_dir": str(tmp_path / "pred")}
    out = str(tmp_path / "serving")
    cli_main(["export", best, out, "--kind", "erfnet_RCM", "--tasks", "2", "--dtype", "float32",
              "--height", "32", "--width", "64", "--platforms", "cpu"])
    meta = _last_json(capsys)
    assert meta["kind"] == "erfnet_RCM" and meta["num_classes"] == [20, 20, 27]
    x = [np.random.default_rng(1).integers(0, 256, (1, 32, 64, 3), np.uint8)]
    got, = serving.serve_batches(out, 2, x, device="cpu")
    fn = serving.build_infer_fn(load_checkpoint(best, kind="erfnet_RCM", device="cpu"), 2,
                                compute_dtype=torch.float32)
    want, = serving.serve_fn_batches(fn, x, 32, 64)
    assert got.shape == (1, 32, 64, 27) and rel_l2(got, want) <= 1e-6
    with pytest.raises(SystemExit) as e:
        cli_main(["eval", os.path.join(best, "1.pt"), "--kind", "erfnet_RCM"] + CLI_EVAL)
    assert "no torch checkpoint grammar" in str(e.value.code)
    pytest.importorskip("sklearn")
    pytest.importorskip("matplotlib")
    cli_main(["tsne", best, "--kind", "erfnet_RCM", "--task", "1", "--which", "penultimate",
              "--first-image", "--n-samples", "40", "--out", str(tmp_path / "t" / "tsne.png")]
             + CLI_EVAL)
    assert _last_json(capsys)["n_points"] == 40 and os.path.getsize(tmp_path / "t" / "tsne.png")
