"""The port's tracer (`mdilss_tpu_torch/utils/profiling.py`): spans, their
ids, self times and clock, the host-sync counter's capture, the spans a
step-2 and a two-phase step-3 step record, the steps bitwise the same with
tracing on and off, and the readers of `tools_torch/program_trace.py` on a
hand-built record. On the CPU, at 2x32x64."""
from __future__ import annotations

import copy
import importlib.util
import json
import time
import warnings
from collections import Counter
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from mdilss_tpu_torch.models import ERFNetRAP
from mdilss_tpu_torch.models.topology import make_dropout_masks
from mdilss_tpu_torch.train import steps
from mdilss_tpu_torch.train.masks import rap_lr_tree
from mdilss_tpu_torch.utils import profiling
from mdilss_tpu_torch.utils.profiling import self_times, span, spanned, start_tracing, stop_tracing

torch.set_num_threads(1)
TOOL = Path(__file__).resolve().parents[1] / "tools_torch" / "program_trace.py"
N, H, W = 2, 32, 64
WEIGHT = np.linspace(0.5, 2.0, 20).astype(np.float32)


@pytest.fixture(autouse=True)
def _tracing_off():
    yield
    stop_tracing()  # a failed test leaves it on for no other


def _tool():
    spec = importlib.util.spec_from_file_location("program_trace", TOOL)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_tracing_off_records_nothing():
    assert span("a") is span("b", task=1)  # the shared no-op

    @spanned("f")
    def f(x):
        with span("inner"):
            return x + 1

    assert f(1) == 2
    assert stop_tracing() == {"spans": [], "syncs": []}
    start_tracing(syncs=False)
    with pytest.raises(RuntimeError, match="already on"):
        start_tracing(syncs=False)
    assert f(1) == 2
    rec = stop_tracing()
    assert [s[3] for s in rec["spans"]] == ["f", "inner"] and not profiling._on
    assert f(1) == 2 and stop_tracing() == {"spans": [], "syncs": []}


def test_nesting_parents_batches_and_self_times():
    start_tracing(syncs=False)
    for _ in range(2):
        with span("data.augment"):
            pass
        with span("step", kind="distill"):
            with span("step.forward", task=1):
                time.sleep(0.002)
                with span("step.teacher"):
                    time.sleep(0.003)
            with span("wait.adam_lr"):
                pass
    with span("batch"):
        with span("step"):
            pass
    rec = stop_tracing()
    spans = rec["spans"]
    by = {s[0]: s for s in spans}
    assert [s[3] for s in spans] == ["data.augment", "step", "step.forward", "step.teacher",
                                     "wait.adam_lr"] * 2 + ["batch", "step"]
    # a data span before its step shares the step's batch; the Trainer's batch is one
    assert [s[2] for s in spans] == [1] * 5 + [2] * 5 + [3, 3]
    for s in spans:
        want = {"data.augment": None, "step": None, "step.forward": "step",
                "step.teacher": "step.forward", "wait.adam_lr": "step", "batch": None}[s[3]]
        if s[3] == "step" and s[2] == 3:
            want = "batch"
        assert (by[s[1]][3] if s[1] else None) == want
    assert spans[1][6] == {"kind": "distill"} and spans[0][6] is None
    own = self_times(spans)
    fwd, teacher = spans[2], spans[3]
    assert own[teacher[0]] == teacher[5] - teacher[4] >= 3_000_000
    assert own[fwd[0]] == (fwd[5] - fwd[4]) - (teacher[5] - teacher[4])
    assert 2_000_000 <= own[fwd[0]] < 3_000_000 + (fwd[5] - fwd[4]) // 2


def test_span_lands_on_the_profilers_clock(tmp_path):
    start_tracing(annotate=True, syncs=False)
    x = torch.randn(128, 128)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for i in range(3):
            with span(f"phase{i}"):
                x = x @ x.T / 128
    rec = stop_tracing()
    prof.export_chrome_trace(str(tmp_path / "t.json"))
    doc = json.loads((tmp_path / "t.json").read_text())
    base = doc["baseTimeNanoseconds"]
    events = {e["name"]: e for e in doc["traceEvents"]
              if e.get("cat") == "user_annotation" and e["name"].startswith("phase")}
    assert len(events) == 3
    for s in rec["spans"]:
        e = events[s[3]]
        start, end = base + e["ts"] * 1000, base + (e["ts"] + e["dur"]) * 1000
        assert abs(s[4] - start) < 1e6 and abs(s[5] - end) < 1e6, (s, start, end)


def test_sync_counter_records_every_sync_with_its_span(monkeypatch):
    modes, shown = [], []
    monkeypatch.setattr(warnings, "showwarning", lambda message, *a, **k: shown.append(message))
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode", lambda: 0)
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", modes.append)
    start_tracing(syncs=True)
    assert modes == ["warn"]

    def sync():  # the text c10 warns with under set_sync_debug_mode("warn")
        warnings.warn("called a synchronizing CUDA operation", UserWarning)

    with span("step"):
        with span("wait.class_weight"):
            for _ in range(3):
                sync()
        sync()
    sync()
    warnings.warn("another warning, passed on", UserWarning)
    rec = stop_tracing()
    assert modes == ["warn", 0]
    assert [str(w) for w in shown] == ["another warning, passed on"]
    names = {s[0]: s for s in rec["spans"]}
    got = [names[sid][3] if sid else None for _, sid, _ in rec["syncs"]]
    assert got == ["wait.class_weight"] * 3 + ["step", None]
    for t, sid, site in rec["syncs"]:
        assert Path(site.rsplit(":", 1)[0]).name == Path(__file__).name
        assert sid is None or names[sid][4] <= t <= names[sid][5]


def _step_setup(step3: bool):
    torch.manual_seed(3)
    prev = (1, 0) if step3 else (0,)
    classes = [20, 20, 27] if step3 else [20, 20]
    teacher = ERFNetRAP(classes[:-1], len(classes) - 1, device="cpu")
    student = ERFNetRAP(classes, len(classes), device="cpu")
    cur = len(classes) - 1
    lrs = rap_lr_tree(student, current_task=cur, shared_lr=5e-6, ds_lr=5e-4)
    weight = np.linspace(0.5, 2.0, classes[-1]).astype(np.float32)
    make = steps.make_two_phase_distill_step if step3 else steps.make_distill_step
    step = make(current_task=cur, prev_tasks=prev, class_weight=weight, lr_tree=lrs,
                num_epochs=10, iou_train=True)
    g = torch.Generator().manual_seed(5)
    x = torch.rand(N, H, W, 3, generator=g)
    y = torch.randint(0, classes[-1], (N, H, W), generator=g, dtype=torch.int32)
    rng = np.random.default_rng(7)
    masks = [make_dropout_masks(rng, N) for _ in range(1 + len(prev))]
    return student, teacher, step, x, y, masks


@pytest.mark.parametrize("step3", [False, True], ids=["step2", "step3"])
def test_step_spans_and_bitwise_off_and_on(step3):
    student, teacher, step, x, y, masks = _step_setup(step3)
    other = copy.deepcopy(student)
    teacher_before = {k: v.clone() for k, v in teacher.state_dict().items()}
    ts_off, m_off = step(steps.init_train_state(student), teacher, x, y, masks, 2)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        ts_off2, _ = step(steps.init_train_state(copy.deepcopy(other)), teacher, x, y, masks, 2)
    names = {e.name for e in prof.events()}
    assert not names & {"step", "step.forward", "step.backward", "wait.adam_lr"}
    start_tracing(syncs=False)
    ts_on, m_on = step(steps.init_train_state(other), teacher, x, y, masks, 2)
    rec = stop_tracing()

    counts = Counter(s[3] for s in rec["spans"])
    n_prev = 2 if step3 else 1
    n_phase = 2 if step3 else 1
    assert counts["step"] == 1
    assert counts["step.forward"] == 1 + n_prev and counts["step.teacher"] == n_prev
    assert counts["step.backward"] == n_phase and counts["step.optimizer"] == n_phase
    # the class weights, Adam's LRs and the dropout masks no longer wait: no span of theirs
    assert not counts.keys() & {"wait.class_weight", "wait.adam_lr", "wait.dropout_masks"}
    assert counts["wait.confusion"] == 1
    assert counts["step.loss"] == 1 + n_prev + 1  # CE, each KLD, the confusion matrix
    assert counts["step.modes"] >= 2 + n_phase
    assert {s[6]["kind"] for s in rec["spans"] if s[3] == "step"} == {
        "two_phase" if step3 else "distill"}
    assert len({s[2] for s in rec["spans"]}) == 1 and sum(s[1] is None for s in rec["spans"]) == 1
    assert sorted(s[6]["task"] for s in rec["spans"] if s[3] == "step.teacher") == list(
        range(n_prev))
    assert len(rec["spans"]) <= 50

    for k in m_off:
        assert torch.equal(m_off[k], m_on[k]), k
    for a, b in ((ts_off, ts_on), (ts_off, ts_off2)):
        sa, sb = a.model.state_dict(), b.model.state_dict()
        assert all(torch.equal(sa[k], sb[k]) for k in sa)
        assert torch.equal(a.opt.m, b.opt.m) and torch.equal(a.opt.v, b.opt.v)
    assert all(torch.equal(v, teacher.state_dict()[k]) for k, v in teacher_before.items())


def test_eval_step_spans():
    model = ERFNetRAP([20], 1, device="cpu")
    step = steps.make_eval_step(task=0, class_weight=WEIGHT, num_classes=20)
    g = torch.Generator().manual_seed(1)
    x = torch.rand(N, H, W, 3, generator=g)
    y = torch.randint(0, 20, (N, H, W), generator=g, dtype=torch.int32)
    off = step(model, x, y)
    start_tracing(syncs=False)
    on = step(model, x, y)
    rec = stop_tracing()
    assert torch.equal(off[0], on[0]) and torch.equal(off[1], on[1])
    counts = Counter(s[3] for s in rec["spans"])
    assert counts == Counter({"step": 1, "step.modes": 1, "step.forward": 1, "step.loss": 1,
                              "wait.confusion": 1})


def _record(kind="train"):
    """Two batches, times in ns. Batch 1: augment [0, 10], step [10, 100]
    holding step.optimizer [55, 85] and in it wait.adam_lr [60, 80]; batch
    2: step [100, 150] holding wait.class_weight [120, 130]. The device is
    busy [5, 50], [62, 90], [95, 125], [140, 160] of the window [0, 160]:
    gaps [0, 5] (opens in the augment), [50, 62] (in the step, no wait),
    [90, 95] (no wait), [125, 140] (opens in wait.class_weight)."""
    spans = [(1, None, 1, "data.augment", 0, 10, None),
             (2, None, 1, "step", 10, 100, {"kind": kind}),
             (3, 2, 1, "step.optimizer", 55, 85, None),
             (4, 3, 1, "wait.adam_lr", 60, 80, None),
             (6, None, 2, "step", 100, 150, {"kind": kind}),
             (7, 6, 2, "wait.class_weight", 120, 130, None)]
    syncs = [(70, 4, "optim.py:55"), (71, 4, "optim.py:55"), (72, 4, "optim.py:56"),
             (125, 7, "losses.py:40"), (155, None, "train_step.py:200")]
    program = {"spans": spans, "syncs": syncs, "base_ns": 0, "window": [0, 160],
               "busy": [[5, 50], [62, 90], [95, 125], [140, 160]]}
    return {"kind": kind, "trace": {"batches": 2, "program": program}}


@pytest.mark.parametrize("kind", ["train", "eval"])
def test_the_six_readers_on_a_hand_built_record(kind):
    tool = _tool()
    rec = _record(kind)
    other = "eval" if kind == "train" else "train"
    # roots 10 + 90 + 50 ns, less the waits 20 + 10, over 2 batches
    assert tool.host_ms(rec, kind) == pytest.approx((150 - 30) / 1e6 / 2)
    assert tool.host_syncs(rec, kind) == 2.0  # 4 inside spans over 2 batches
    idle = 5 + 12 + 5 + 15
    assert tool.idle_drain(rec, kind) == pytest.approx(100.0 * 15 / idle)
    for read in tool.READERS.values():
        assert read(rec, other) is None
        assert read({"kind": kind, "trace": {"batches": 2}}, kind) is None
    assert set(tool.readings(rec)) == {f"{r}.{kind}" for r in tool.READERS}
    table = tool.gap_table(rec)
    assert table["longest_gaps"][0] == ["wait.class_weight", 15 / 1e6]
    assert [g[0] for g in table["longest_gaps"]] == ["wait.class_weight", "step",
                                                     "data.augment", "step"]
    assert table["syncs_by_site"]["wait.adam_lr @ optim.py:55"] == 1.0
    assert table["syncs_by_site"]["outside the program @ train_step.py:200"] == 0.5
    spans = tool.span_table(rec)
    assert spans["step"]["count"] == 1.0 and spans["step.optimizer"]["self_ms"] == 10 / 1e6 / 2


@pytest.mark.parametrize("cell,per_batch", [
    ("step2_fp32", {"step": 1, "step.forward": 2, "step.teacher": 1, "step.backward": 1,
                    "step.optimizer": 1, "data.augment": 1, "data.masks": 2}),
    ("eval_fp32", {"step": 1, "step.forward": 1, "data.prepare": 1, "wait.confusion": 1}),
])
def test_the_tool_over_a_small_benchmark_cell(cell, per_batch, monkeypatch):
    """`program_trace.measure` through a benchmark cell's own loop at 2x64x128
    on the CPU, its device trace replaced by one that runs the batches and
    reports no device interval."""
    tool = _tool()
    monkeypatch.syspath_prepend(str(TOOL.parents[1]))
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode", lambda: 0)
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", lambda mode: None)

    def trace(run, device):
        t0 = time.time_ns()
        run()
        return {"base_ns": 0, "busy": [], "window": [t0, time.time_ns()]}

    monkeypatch.setattr(tool, "_trace", trace)
    small = {"batch": 2, "height": 64, "width": 128, "train_images": 12,
             "val_images": [5, 7, 3]}
    out = tool.measure(cell, 2**31 + 98765, 0.1, 2, 0.1, device=torch.device("cpu"),
                       overrides=small)
    kind = out["kind"]
    assert set(out["readings"]) == {f"{r}.{kind}" for r in tool.READERS}
    assert out["readings"][f"host_syncs.{kind}"] == 0.0  # the CPU never syncs
    # the one gap, the whole window, opens before the first span
    assert out["readings"][f"idle_drain.{kind}"] == 0.0
    assert [g[0] for g in out["longest_gaps"]] == [tool.OUTSIDE]
    assert 0 < out["readings"][f"host_ms.{kind}"] < 1e5
    for name, n in per_batch.items():
        assert out["spans"][name]["count"] == n, name
    assert len(out["cost"]["on"]) == len(out["cost"]["off"]) == 2
