"""The port's Trainer on its own, on the CPU at the TINY size (synthetic, 4
images, batch 2, 32x64): run artifacts, the checkpoint files, bit-exact
resume, cached = hybrid = streaming trajectories, the best-epoch rule, the
train-IoU column, the profiler trace, the cache budget, a cache that cannot
be built, remat against no remat, and the options that wait for later
slices or that it refuses (the multi-head protocols are tested in
test_torch_multihead.py and test_torch_protocols.py)."""
import json
import os

import numpy as np
import pytest
import torch

from mdilss_tpu_torch import config as C
from mdilss_tpu_torch.ckpt import torch_io
from mdilss_tpu_torch.models import ERFNetRAP, topology
from mdilss_tpu_torch.train import loop, steps
from mdilss_tpu_torch.train.loop import Trainer

torch.set_num_threads(1)
TINY = dict(synthetic=True, synthetic_size=4, batch_size=2, height=32, width=64,
            num_workers=2)


def _rows(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def _state(tr: Trainer) -> dict:
    """Every parameter and buffer of the student, and Adam's state."""
    out = {k: v.clone() for k, v in tr.ts.model.state_dict().items()}
    out.update(opt_m=tr.ts.opt.m.clone(), opt_v=tr.ts.opt.v.clone(),
               opt_count=torch.tensor(tr.ts.opt.count))
    return out


def _assert_states_equal(a: dict, b: dict):
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_step1_trainer_artifacts(tmp_path):
    tr = Trainer(C.step1(num_epochs=2, savedir=str(tmp_path / "run"), **TINY), device="cpu")
    final = tr.fit()
    assert np.isfinite(final["train_loss"])
    for f in ("opts.txt", "model.txt", "automated_log.txt", "best.txt", "metrics.jsonl"):
        assert (tmp_path / "run" / f).exists(), f
    assert json.loads((tmp_path / "run" / "opts.txt").read_text())["protocol"] == "step1"
    sizes = json.loads((tmp_path / "run" / "model.txt").read_text())
    assert sizes["decoder.0.output_conv.bias"] == [20]
    rows = _rows(tmp_path / "run" / "metrics.jsonl")
    assert [r["epoch"] for r in rows] == [1, 2]
    log = (tmp_path / "run" / "automated_log.txt").read_text()
    assert log.startswith("Epoch\t\tTrain-loss\t\tTest-loss\t\tTrain-IoU\t\tTest-IoU\t\tlearningRate")
    assert len(log.strip().splitlines()) == 3
    assert torch_io.latest_epoch(str(tmp_path / "run" / "ckpt")) == 2


def test_checkpoint_round_trip_and_max_to_keep(tmp_path):
    torch.manual_seed(0)
    model = ERFNetRAP([6, 5], 2, device="cpu")
    ts = steps.init_train_state(model)
    ts = steps.TrainState(model, ts.opt._replace(m=torch.randn_like(ts.opt.m),
                                                 v=torch.rand_like(ts.opt.v), count=7))
    gen = torch.Generator().manual_seed(11)
    torch.rand(3, generator=gen)
    d = str(tmp_path / "ck")
    for epoch in (1, 2, 3):
        torch_io.save(d, epoch, ts, best_acc=0.42, aug_state=gen.get_state())
    assert sorted(os.listdir(d)) == ["2.pt", "3.pt"]  # the two newest, as Orbax keeps
    assert torch_io.latest_epoch(d) == 3 and torch_io.latest_epoch(str(tmp_path / "no")) is None
    assert torch_io.infer_num_classes(d) == [6, 5]

    torch.manual_seed(1)
    other = steps.init_train_state(ERFNetRAP([6, 5], 2, device="cpu"))
    back, epoch, best, aug = torch_io.restore(d, other)
    assert (epoch, best) == (3, 0.42) and back.model is other.model
    _assert_states_equal({k: v for k, v in model.state_dict().items()},
                         back.model.state_dict())
    assert torch.equal(back.opt.m, ts.opt.m) and torch.equal(back.opt.v, ts.opt.v)
    assert back.opt.count == 7 and torch.equal(aug, gen.get_state())
    _, epoch, _, _ = torch_io.restore(d, other, epoch=2)
    assert epoch == 2
    with pytest.raises(FileNotFoundError):
        torch_io.restore(str(tmp_path / "no"), other)


@pytest.mark.parametrize("protocol", ["step1", "step2"])
def test_resume_is_bit_equivalent(tmp_path, protocol):
    """2 epochs, a stop, a new Trainer that resumes, 2 more epochs: every
    parameter, buffer and Adam moment, the augment generator, metrics.jsonl
    (but its timing) and automated_log.txt bitwise equal to 4 straight
    epochs."""
    def teacher():
        if protocol == "step1":
            return None
        torch.manual_seed(5)
        return ERFNetRAP([20], 1, device="cpu")

    kw = dict(num_epochs=4, iou_train=True, **TINY)
    mk = getattr(C, protocol)
    a = Trainer(mk(savedir=str(tmp_path / "a"), **kw), teacher=teacher(), device="cpu")
    a.fit()
    Trainer(mk(savedir=str(tmp_path / "b"), **kw), teacher=teacher(), device="cpu").fit(
        stop_after=2)
    b = Trainer(mk(savedir=str(tmp_path / "b"), resume=True, **kw), teacher=teacher(),
                device="cpu")
    assert b.start_epoch == 3
    b.fit()
    _assert_states_equal(_state(a), _state(b))
    assert torch.equal(a.aug_gen.get_state(), b.aug_gen.get_state())
    ra, rb = _rows(tmp_path / "a/metrics.jsonl"), _rows(tmp_path / "b/metrics.jsonl")
    assert [r["epoch"] for r in rb] == [1, 2, 3, 4]
    for r in ra + rb:
        del r["epoch_seconds"]
    assert ra == rb
    for name in ("automated_log.txt", "best.txt"):
        assert (tmp_path / "a" / name).read_text() == (tmp_path / "b" / name).read_text()


def test_resume_without_a_checkpoint_starts_fresh(tmp_path, capsys):
    tr = Trainer(C.step1(num_epochs=1, resume=True, savedir=str(tmp_path / "r"), **TINY),
                 device="cpu")
    assert tr.start_epoch == 1 and "no checkpoint found" in capsys.readouterr().out


def test_cached_hybrid_and_streaming_trajectories_are_equal(tmp_path, capsys):
    """A budget of 3 rows' bytes caches 3 of the 6 training rows (HybridCache),
    "auto" caches everything, "off" streams: the same trajectory, bitwise."""
    kw = dict(synthetic=True, synthetic_size=6, batch_size=3, height=32, width=64,
              num_workers=2, num_epochs=2)
    row = 32 * 64 * 4
    states, finals = [], []
    for name, budget in (("full", "auto"), ("hybrid", str(3 * row)), ("stream", "off")):
        tr = Trainer(C.step1(savedir=str(tmp_path / name), device_cache=budget, **kw),
                     device="cpu")
        finals.append(tr.fit())
        states.append(_state(tr))
        out = capsys.readouterr().out
        assert ("partial — 3/6 rows cached" in out) == (name == "hybrid")
        caches = list(tr._train_caches.values()) + list(tr._val_caches.values())
        assert [type(c).__name__ for c in caches] == {
            "full": ["DeviceCache", "DeviceCache"], "hybrid": ["HybridCache", "NoneType"],
            "stream": ["NoneType", "NoneType"]}[name]
    for s, f in zip(states[1:], finals[1:]):
        _assert_states_equal(states[0], s)
        assert {k: v for k, v in f.items() if k != "epoch_seconds"} == {
            k: v for k, v in finals[0].items() if k != "epoch_seconds"}


def test_an_epoch_without_evaluation_never_becomes_best(tmp_path):
    """eval_every=2: epochs 2 and 4 evaluate (the last always does), and only
    they compete for best (train_RAPFT_step1.py:347-352)."""
    tr = Trainer(C.step1(num_epochs=4, eval_every=2, savedir=str(tmp_path / "run"), **TINY),
                 device="cpu")
    tr.fit()
    rows = _rows(tmp_path / "run/metrics.jsonl")
    assert ["val_acc_cityscapes" in r for r in rows] == [False, True, False, True]
    epoch = torch_io.latest_epoch(str(tmp_path / "run/best"))
    assert epoch in (2, 4)
    assert (tmp_path / "run/best.txt").read_text().startswith(f"Best epoch is {epoch},")


def test_iou_train_column(tmp_path):
    tr = Trainer(C.step1(num_epochs=1, iou_train=True, savedir=str(tmp_path / "run"), **TINY),
                 device="cpu")
    final = tr.fit()
    assert 0.0 < final["train_iou"] <= 1.0
    assert final["train_iou_cityscapes"] == final["train_iou"]
    row = (tmp_path / "run/automated_log.txt").read_text().strip().splitlines()[-1]
    assert float(row.split("\t\t")[3]) == pytest.approx(final["train_iou"], abs=1e-4)


def test_profiler_trace_written(tmp_path):
    tr = Trainer(C.step1(num_epochs=1, savedir=str(tmp_path / "run"),
                         profile_dir=str(tmp_path / "trace"), profile_steps=1, **TINY),
                 device="cpu")
    tr._tracer.start = 0  # a 2-batch run: trace from the first batch
    tr.fit()
    trace = json.loads((tmp_path / "trace/trace.json").read_text())
    assert any("aten::" in e.get("name", "") for e in trace["traceEvents"])
    # the program's spans over the ops, as user annotations
    spans = {e["name"] for e in trace["traceEvents"] if e.get("cat") == "user_annotation"}
    assert {"batch", "step", "step.forward", "step.backward", "step.optimizer"} <= spans


def test_device_cache_budget(tmp_path):
    def budget(value):
        return Trainer(C.step1(num_epochs=1, device_cache=value, savedir=str(tmp_path / value),
                               **TINY), device="cpu")._cache_budget

    assert budget("off") == 0 and budget("12345") == 12345 and budget("auto") == 1 << 30
    with pytest.raises(ValueError, match="integer byte budget"):
        budget("8GiB")


@pytest.mark.parametrize("make,kw,error,match", [
    # the ablation models train; what they still refuse
    ("step1", dict(model="erfnet_bn", fused_train=True), ValueError, "fused paths"),
    ("step1", dict(model="erfnet_onlyRAP", compute_dtype="float16"), ValueError,
     "float32 or bfloat16"),
    ("step2", dict(model="erfnet_RA_series"), ValueError, "distils from a teacher"),
    ("step1", dict(compute_dtype="float64"), ValueError, "float32 or bfloat16"),
])
def test_what_waits_raises(tmp_path, make, kw, error, match):
    cfg = getattr(C, make)(savedir=str(tmp_path / "run"), **TINY, **kw)
    with pytest.raises(error, match=match):
        Trainer(cfg, device="cpu")


@pytest.mark.parametrize("make,kw", [
    ("step3", dict(model="erfnet_RCM")),
    ("step1", {}),
    ("step2", dict(remat=True)),
])
def test_spatial_shards_must_divide_the_world(tmp_path, make, kw):
    """spatial_shards=2 on one process raises JAX's ValueError (the shards
    must divide the devices, mdilss_tpu/train/loop.py:249-254); on 4
    processes the same configs build on a 2x2 mesh
    (tests/test_torch_spatial_trainer.py)."""
    cfg = getattr(C, make)(savedir=str(tmp_path / "run"), spatial_shards=2, **TINY, **kw)
    with pytest.raises(ValueError, match="--spatial-shards 2 must divide the device count"):
        Trainer(cfg, teacher=_teacher(make), device="cpu")


def _teacher(protocol: str):
    """The step-2 / step-3 teacher of the TINY runs, from a fixed seed."""
    if protocol == "step1":
        return None
    torch.manual_seed(5)
    classes = [20] if protocol == "step2" else [20, 20]
    return ERFNetRAP(classes, len(classes), device="cpu")


def _run(tmp_path, name: str, protocol: str, **kw):
    """A TINY fit of `protocol` (2 epochs, train IoU); (Trainer, final metrics,
    its metrics.jsonl rows without their timing, its automated_log.txt)."""
    cfg = getattr(C, protocol)(num_epochs=2, iou_train=True, savedir=str(tmp_path / name),
                               **{**TINY, **kw})
    tr = Trainer(cfg, teacher=_teacher(protocol), device="cpu")
    final = tr.fit()
    rows = _rows(tmp_path / name / "metrics.jsonl")
    for r in rows:
        del r["epoch_seconds"]
    return tr, final, rows, (tmp_path / name / "automated_log.txt").read_text()


@pytest.mark.parametrize("protocol,kw", [
    ("step1", {}), ("step2", {}), ("step3", {}), ("step2", dict(compute_dtype="bfloat16")),
])
def test_remat_trainer_equals_no_remat(tmp_path, protocol, kw):
    """remat=True (every student forward's regions, and each previous-task
    forward one region) trains the same run as remat=False, bit for bit:
    every parameter, running statistic and Adam tensor, the saved checkpoint
    and best checkpoint, metrics.jsonl (but its timing) and
    automated_log.txt."""
    a, fa, rows_a, log_a = _run(tmp_path, "plain", protocol, **kw)
    b, fb, rows_b, log_b = _run(tmp_path, "remat", protocol, remat=True, **kw)
    _assert_states_equal(_state(a), _state(b))
    assert rows_a == rows_b and log_a == log_b
    for sub in ("ckpt", "best"):  # the files: the latest and the best checkpoint
        restored = []
        for name, tr in (("plain", a), ("remat", b)):
            tr.ts, epoch, best, aug = torch_io.restore(str(tmp_path / name / sub), tr.ts)
            restored.append((_state(tr), epoch, best, aug))
        (sa, *ma), (sb, *mb) = restored
        _assert_states_equal(sa, sb)
        assert ma[:2] == mb[:2] and torch.equal(ma[2], mb[2])


def test_remat_false_never_reaches_checkpoint(tmp_path, monkeypatch):
    """The default, remat=False, makes no remat region: a step-2 fit runs with
    torch.utils.checkpoint replaced by a function that raises."""
    def refuse(*args, **kw):
        raise AssertionError("torch.utils.checkpoint called without remat")

    monkeypatch.setattr(topology, "checkpoint", refuse)
    monkeypatch.setattr(torch.utils.checkpoint, "checkpoint", refuse)
    _, final, _, _ = _run(tmp_path, "run", "step2")
    assert np.isfinite(final["train_loss"])


@pytest.mark.parametrize("cache,budget", [("DeviceCache", "auto"),
                                          ("HybridCache", str(3 * 32 * 64 * 4))])
def test_a_cache_that_fails_to_build_streams(tmp_path, capsys, monkeypatch, cache, budget):
    """A DeviceCache / HybridCache whose construction raises (the card's memory
    full: torch.OutOfMemoryError) is skipped as JAX skips it
    (mdilss_tpu/train/loop.py:206-222): the "disabled" line, the dataset
    streamed, no budget charged, and the run's state, metrics and log bitwise
    those of a device_cache="off" run."""
    def fail(*args, **kw):
        raise torch.OutOfMemoryError("CUDA out of memory (a test's)")

    kw = dict(synthetic_size=6, batch_size=3)
    ref, f_ref, rows_ref, log_ref = _run(tmp_path, "off", "step1", device_cache="off", **kw)
    capsys.readouterr()
    monkeypatch.setattr(loop, cache, fail)
    tr, final, rows, log = _run(tmp_path, "failed", "step1", device_cache=budget, **kw)
    out = capsys.readouterr().out
    assert "device cache for cityscapes/train disabled: CUDA out of memory (a test's)" in out
    if cache == "DeviceCache":  # the validation set fails to build too
        assert "device cache for cityscapes/val disabled: CUDA out of memory" in out
    assert all(c is None for c in tr._train_caches.values())
    budget0 = Trainer(C.step1(savedir=str(tmp_path / "b0"), device_cache=budget,
                              **{**TINY, **kw}), device="cpu")._cache_budget
    assert tr._cache_budget == budget0
    _assert_states_equal(_state(ref), _state(tr))
    assert rows == rows_ref and log == log_ref


def test_distillation_needs_a_teacher_and_fused_train_is_accepted(tmp_path):
    with pytest.raises(ValueError, match="teacher"):
        Trainer(C.step2(savedir=str(tmp_path / "a"), **TINY), device="cpu")
    tr = Trainer(C.step1(num_epochs=1, fused_train=True, savedir=str(tmp_path / "b"), **TINY),
                 device="cpu")
    assert np.isfinite(tr.fit()["train_loss"])


def test_entry_points_need_a_card_unless_asked_for_the_cpu(tmp_path):
    """Without a card, the Trainer, the caches, device_prefetch and
    evaluate_checkpoint raise unless given device="cpu"; they never fall
    back to the CPU on their own."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    from mdilss_tpu_torch.data.device_cache import DeviceCache, HybridCache
    from mdilss_tpu_torch.data.loader import Loader, SyntheticSource, device_prefetch
    from mdilss_tpu_torch.evaluate import evaluate_checkpoint

    ld = Loader(SyntheticSource(5, n=4, height=8, width=8), batch_size=2, height=8, width=8)
    tr = Trainer(C.step1(num_epochs=1, savedir=str(tmp_path / "run"), **TINY), device="cpu")
    tr.fit()
    calls = [lambda: Trainer(C.step1(savedir=str(tmp_path / "r2"), **TINY)),
             lambda: DeviceCache(ld), lambda: HybridCache(ld, 2),
             lambda: next(device_prefetch(ld)),
             lambda: evaluate_checkpoint(str(tmp_path / "run/best"), kind="rap",
                                         datasets=["cityscapes"], height=32, width=64)]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
