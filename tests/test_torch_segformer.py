"""SegFormerRAP (models/segformer_rap.py) on the CPU at a small spec, held to
the plain reference of the benchmark (benchmark/reference/segformer_rap.py)
on seeded random weights: eval and training logits, a step-2 and a step-3
step through `train.steps`, the LR dict's three groups, the keep-masks, the
options it refuses, the checkpoint surgery on its names, a Trainer chain
step1 -> step2 -> step3 with `evaluate_checkpoint`, and the B5 preset's
parameter counts on the meta device."""
import dataclasses
import re

import numpy as np
import pytest
import torch

from benchmark.reference import segformer_rap as ref
from mdilss_tpu_torch import config as C
from mdilss_tpu_torch.ckpt.surgery import extend_for_new_task, keep_tasks
from mdilss_tpu_torch.evaluate import evaluate_checkpoint
from mdilss_tpu_torch.models import SegFormerRAP
from mdilss_tpu_torch.models import segformer_rap as sr
from mdilss_tpu_torch.ops import attention
from mdilss_tpu_torch.train import steps
from mdilss_tpu_torch.train.masks import rap_lr_tree
from mdilss_tpu_torch.train.protocols import build_trainer

torch.set_num_threads(1)
SMALL = sr.SegFormerSpec(embed_dims=(8, 16, 24, 32), num_heads=(1, 2, 3, 4), depths=(1, 1, 2, 1),
                         decoder_dim=32)
SPEC = dataclasses.asdict(SMALL)  # the reference's spec: the same keys
N, H, W = 2, 64, 128
EPOCH, EPOCHS, LAMBDA, WD = 1, 150, 0.1, 1e-4


def _model(num_classes, seed: int = 0, dtype=torch.float32) -> SegFormerRAP:
    """A model at SMALL with its per-domain LayerNorms and BN drawn apart
    (the published initialisation makes every domain's alike)."""
    torch.manual_seed(seed)
    m = SegFormerRAP(num_classes, len(num_classes), spec=SMALL, device="cpu")
    with torch.no_grad():
        for k, v in m.state_dict().items():
            if not (re.search(r"\.(norm\d?|bn)\.", k) and v.is_floating_point()):
                continue
            if k.endswith("running_var"):
                v.uniform_(0.5, 1.5)
            else:
                v.add_(0.1 * torch.randn_like(v))
    return m.to(dtype)


def _batch(num_classes: int, seed: int = 1):
    g = torch.Generator().manual_seed(seed)
    x = torch.rand(N, H, W, 3, generator=g)
    y = torch.randint(0, num_classes, (N, H, W), generator=g)
    return x, y


def _keep(masks: dict) -> dict:
    return {k: torch.as_tensor(v) for k, v in masks.items()}


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.double() - b.double()).norm() / b.double().norm().clamp_min(1e-30))


@pytest.mark.parametrize("task", [0, 1])
def test_eval_logits_are_the_references(task):
    m = _model([5, 7], dtype=torch.float64)
    x = _batch(5)[0].double()
    want = ref.Forward(m.state_dict(), task, SPEC, train=False)(x)
    got = m(x, task)
    assert got.shape == (N, H, W, (5, 7)[task]) and not got.requires_grad
    assert float((got - want).abs().max()) <= 1e-12
    got32 = _model([5, 7])(x.float(), task)
    assert _rel(got32, want) <= 1e-5


def test_training_logits_and_running_statistics_with_masks_are_the_references():
    m = _model([5, 7], dtype=torch.float64).train()
    x = _batch(7)[0].double()
    masks = m.make_dropout_masks(np.random.default_rng(3), N)
    sd = {k: v.clone() for k, v in m.state_dict().items()}
    want = ref.Forward(sd, 1, SPEC, train=True, update_running=True, keep_masks=_keep(masks))(x)
    got = m(x, 1, masks).detach()
    assert float((got - want).abs().max()) <= 1e-12
    after = {k: v.clone() for k, v in m.state_dict().items()}  # the reference updated sd's
    running = [k for k in sd if k.endswith(("running_mean", "running_var"))]
    assert running and all(float((after[k] - sd[k]).abs().max()) <= 1e-12 for k in running)
    before = _model([5, 7], dtype=torch.float64).state_dict()
    assert not torch.equal(after["decoder.1.bn.running_mean"], before["decoder.1.bn.running_mean"])
    assert torch.equal(after["decoder.0.bn.running_mean"], before["decoder.0.bn.running_mean"])
    assert not torch.equal(got, m(x, 1, None))  # the masks drop something


def test_return_features_and_the_shapes_it_refuses():
    m = _model([5, 7])
    x = _batch(5)[0]
    logits, feats = m(x, 0, return_features=True)
    assert torch.equal(logits, m(x, 0))
    assert feats["encoder"].shape == (N, H // 32, W // 32, 32)
    assert feats["penultimate"].shape == (N, H // 4, W // 4, 32)
    with pytest.raises(ValueError, match="multiples of 32"):
        m(torch.rand(N, 48, W, 3), 0)
    with pytest.raises(ValueError, match="remat"):
        m.train()(x, 0, None, remat=True)
    with pytest.raises(ValueError, match="keep-masks"):
        m(x, 0, m.make_dropout_masks(np.random.default_rng(0), N + 1))
    with pytest.raises(IndexError):
        m(x, 2)


def test_masks_are_drawn_from_the_generator_in_order():
    m = _model([5, 7])
    a = m.make_dropout_masks(np.random.default_rng(11), N)
    b = m.make_dropout_masks(np.random.default_rng(11), N)
    assert a.keys() == {"drop_path", "head"}
    assert a["drop_path"].shape == (5, 2, N) and a["head"].shape == (N, 32)
    assert all(np.array_equal(a[k], b[k]) for k in a)
    rng = np.random.default_rng(11)  # the reference's draws: its rates, in its order
    want = [ref.keep_masks(rng, SPEC, N) for _ in range(2)]
    rng = np.random.default_rng(11)
    got = [m.make_dropout_masks(rng, N) for _ in range(2)]
    assert all(np.array_equal(g[k], w[k]) for g, w in zip(got, want) for k in a)
    assert a["drop_path"][0].all()  # rate 0 for the first block


def test_the_lr_dict_has_three_groups():
    m = _model([5, 7, 9])
    lrs = rap_lr_tree(m, current_task=1, shared_lr=5e-6, ds_lr=5e-4)
    assert lrs == ref.base_lrs(list(lrs), current_task=1, shared_lr=5e-6, ds_lr=5e-4)
    groups = {v: sorted(k for k in lrs if lrs[k] == v) for v in set(lrs.values())}
    assert set(groups) == {0.0, 5e-6, 5e-4}
    assert "encoder.block3.1.adapter.1.weight" in groups[5e-4]
    assert "encoder.block1.0.attn.norm.1.bias" in groups[5e-4]
    assert "encoder.patch_embed2.norm.1.weight" in groups[5e-4]
    assert "encoder.norm4.1.weight" in groups[5e-4]
    assert "decoder.1.output_conv.weight" in groups[5e-4]
    for k in ("encoder.block1.0.norm1.0.weight", "encoder.block3.1.adapter.2.bias",
              "decoder.0.linear_fuse.weight", "decoder.2.bn.weight"):
        assert k in groups[0.0]
    for k in ("encoder.block1.0.attn.sr.weight", "encoder.block2.0.mlp.dwconv.weight",
              "encoder.patch_embed1.proj.weight", "encoder.block4.0.attn.kv.bias"):
        assert k in groups[5e-6]


def _leaves(ts) -> dict:
    params = list(ts.model.named_parameters())
    chunks = ts.opt.m.split([p.numel() for _, p in params])
    return {k: c.view_as(p) for (k, p), c in zip(params, chunks)}


@pytest.mark.parametrize("kind", ["distill", "two_phase"])
def test_a_step_is_the_references(kind):
    """One step-2 step (current task 1, eval-mode teacher) or step-3 batch
    (current task 2, teacher in training mode, two Adam steps) through
    `train.steps` against the reference's step from the same state: the
    losses, Adam's first moment (the gradients it took in), the parameters'
    change, the running statistics, and the frozen leaves and the teacher
    unmoved."""
    classes = [5, 7] if kind == "distill" else [5, 7, 6]
    cur = len(classes) - 1
    prev = tuple(range(cur - 1, -1, -1))
    student = _model(classes).train()
    sd0 = {k: v.clone() for k, v in student.state_dict().items()}
    teacher_sd = keep_tasks(sd0, cur)
    teacher = SegFormerRAP(classes[:cur], cur, spec=SMALL, device="cpu")
    teacher.load_state_dict(teacher_sd, strict=True)
    x, y = _batch(classes[cur])
    weight = np.linspace(1.0, 2.0, classes[cur]).astype(np.float32)
    weight[-1] = 0.0
    rng = np.random.default_rng(5)
    masks = [student.make_dropout_masks(rng, N) for _ in range(1 + len(prev))]
    lrs = rap_lr_tree(student, current_task=cur, shared_lr=5e-6, ds_lr=5e-4)
    make = steps.make_distill_step if kind == "distill" else steps.make_two_phase_distill_step
    step = make(current_task=cur, prev_tasks=prev, class_weight=weight, lr_tree=lrs,
                num_epochs=EPOCHS, lambda_c=LAMBDA, weight_decay=WD)
    ts, m = step(steps.init_train_state(student), teacher, x, y, masks, EPOCH)

    state = ref.State(sd0, ref.base_lrs(list(lrs), current_task=cur, shared_lr=5e-6,
                                        ds_lr=5e-4), weight_decay=WD)
    want, _ = ref.STEPS[kind](state, teacher_sd, x, y, [_keep(mk) for mk in masks], spec=SPEC,
                              current_task=cur, prev_tasks=prev,
                              class_weight=torch.as_tensor(weight), lambda_c=LAMBDA,
                              lr_scale=ref.poly_lr(EPOCH, EPOCHS))
    for k in ("loss", "ce", "kld"):
        assert abs(float(m[k]) - want[k]) <= 1e-5 * abs(want[k]), (k, float(m[k]), want[k])
    moments, after = _leaves(ts), ts.model.state_dict()
    # as `benchmark/compare.py` measures them: a leaf's gap over the larger of its
    # norm and the median leaf's (a bias that a softmax or the head's BN all but
    # absorbs has a gradient of rounding noise), and the change where the
    # gradient is above that noise
    norms = {k: float(state.m[k].norm()) for k, lr in lrs.items() if lr > 0}
    med = float(np.median(list(norms.values())))
    for k, norm in norms.items():
        # float32 in another order: the gradients to 1e-3; Adam's first steps
        # divide by sqrt(v), so an element whose gradient is near eps moves by a
        # share of its step more or less
        assert float((moments[k] - state.m[k]).norm()) <= 1e-3 * max(norm, med), k
        if norm >= 1e-3 * med:
            assert _rel(after[k] - sd0[k], state.params[k].detach() - sd0[k]) <= 3e-2, k
    for k in (k for k, lr in lrs.items() if lr == 0):
        assert torch.equal(after[k], sd0[k]), k
    for k, v in state.buffers.items():
        if k.endswith(("running_mean", "running_var")):
            assert _rel(after[k] - sd0[k], v - sd0[k]) <= 1e-4, k
    assert all(torch.equal(v, teacher_sd[k]) for k, v in teacher.state_dict().items())
    assert not teacher.training and ts.opt.count == (1 if kind == "distill" else 2)


def test_attention_counts_its_calls():
    m = _model([5, 7])
    x = _batch(5)[0]
    f0, g0 = attention.LAUNCHES_FWD, attention.LAUNCHES_GRAD
    m(x, 0)  # eval: no grad
    assert (attention.LAUNCHES_FWD - f0, attention.LAUNCHES_GRAD - g0) == (5, 0)
    m.train()(x, 1).sum().backward()
    assert (attention.LAUNCHES_FWD - f0, attention.LAUNCHES_GRAD - g0) == (10, 5)


def test_stages_and_head_are_spans():
    from mdilss_tpu_torch.utils import profiling

    m = _model([5, 7])
    profiling.start_tracing(syncs=False)
    try:
        m(_batch(5)[0], 1)
    finally:
        rec = profiling.stop_tracing()
    assert [(s[3], s[6]) for s in rec["spans"]] == [
        ("model.stage", {"stage": i}) for i in range(4)] + [("model.head", None)]


def test_surgery_seeds_the_new_domain_from_the_last():
    sd = _model([5, 7]).state_dict()
    out = extend_for_new_task(sd, 9, generator=torch.Generator().manual_seed(0))
    m3 = SegFormerRAP([5, 7, 9], 3, spec=SMALL, device="cpu")
    m3.load_state_dict(out, strict=True)
    for k in ("encoder.block3.1.adapter.{}.weight", "encoder.norm2.{}.bias",
              "encoder.block1.0.attn.norm.{}.weight", "decoder.{}.linear_c.3.weight"):
        assert torch.equal(out[k.format(2)], sd[k.format(1)])
    assert torch.equal(out["decoder.2.bn.running_var"], sd["decoder.1.bn.running_var"])
    assert out["decoder.2.output_conv.weight"].shape == (9, 32, 1, 1)
    assert keep_tasks(out, 2).keys() == sd.keys()


def test_the_options_it_does_not_cover_raise(tmp_path):
    kw = dict(savedir=str(tmp_path / "x"), synthetic=True, batch_size=2, height=64, width=128,
              model="segformer_b5_rap")
    for bad, match in ((dict(fused_train=True), "fused_train"), (dict(remat=True), "remat"),
                       (dict(compute_dtype="bfloat16"), "bfloat16"),
                       (dict(spatial_shards=2), "spatial_shards"),
                       (dict(height=48), "multiples of 32")):
        with pytest.raises(ValueError, match=match):
            build_trainer(C.step1(**{**kw, **bad}), device="cpu")
    enc = tmp_path / "imagenet.pth.tar"
    torch.save({"state_dict": {}}, enc)
    with pytest.raises(ValueError, match="ImageNet encoder"):
        build_trainer(C.step1(pretrained_encoder=str(enc), **kw), device="cpu")


def test_the_step_chain_and_evaluate_checkpoint(tmp_path, monkeypatch):
    """step1 -> step2 -> step3 through `build_trainer` and the Trainer on
    synthetic data at SMALL, each from the last one's best checkpoint, and
    `evaluate_checkpoint` of the last."""
    monkeypatch.setitem(sr.SPECS, "b5", SMALL)
    kw = dict(synthetic=True, synthetic_size=4, batch_size=2, height=H, width=W, num_workers=1,
              num_epochs=1, model="segformer_b5_rap")
    runs = {}
    for make, classes in ((C.step1, (5,)), (C.step2, (5, 6)), (C.step3, (5, 6, 7))):
        d = tmp_path / make.__name__
        state = {} if make is C.step1 else {"state": str(runs[len(classes) - 1] / "best")}
        tr = build_trainer(make(savedir=str(d), num_classes=classes, **state, **kw), device="cpu")
        assert isinstance(tr.ts.model, SegFormerRAP)
        history = tr.fit()
        row = history[-1] if isinstance(history, list) else history
        assert np.isfinite(row["train_loss"])
        runs[len(classes)] = d
    assert tr.teacher.training is False and len(tr.teacher.decoder) == 2
    res = evaluate_checkpoint(str(runs[3] / "best"), kind="segformer_b5_rap",
                              datasets=("cityscapes", "BDD", "IDD"), synthetic=True,
                              height=H, width=W, device="cpu")
    assert set(res) == {"cityscapes", "BDD", "IDD"} and all(0 <= v <= 1 for v in res.values())


def test_the_b5_preset_counts_the_published_parameters():
    m = SegFormerRAP([20, 20], 2, device="meta")
    slot = re.compile(r"\.(?:norm\d?|adapter)\.(\d+)\.")
    counts = {"encoder": 0, "adapters": 0, "head": 0}
    for k, p in m.named_parameters():
        s = slot.search(k)
        if k.startswith("decoder.0."):
            counts["head"] += p.numel()
        elif ".adapter.0." in k:
            counts["adapters"] += p.numel()
        elif k.startswith("encoder.") and (s is None or s.group(1) == "0") and ".adapter." not in k:
            counts["encoder"] += p.numel()
    assert round(counts["encoder"] / 1e6, 2) == 81.44  # MiT-B5's 81.4M with one domain's norms
    assert round(counts["adapters"] / 1e6, 2) == 5.01
    assert round(counts["head"] / 1e6, 1) == 3.2
    assert [len(getattr(m.encoder, f"block{i}")) for i in range(1, 5)] == [3, 6, 40, 3]
