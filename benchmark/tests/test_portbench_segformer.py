"""The SegFormer cell `step2_segformer_b5_fp32`: it loads with its files, a
run on the CPU at a small size (the configuration's widths and depths cut in
a copy of the benchmark, the traffic's sizes overridden) is `correct` under
the cell's limits and not with a fault planted or the control in the
program's place, its plain reference loads nothing of the program, and
`attn_roofline.train` reads a hand-built record."""
import json
import shutil
import subprocess
import sys
import time

import pytest
import torch

from benchmark import faults, harness, segformer_count
from benchmark.reference.segformer_rap import spec_of
from mdilss_tpu_torch.models.segformer_rap import SegFormerRAP

from ._small import ROOT, SEED, SMALL

CELL = "step2_segformer_b5_fp32"
CPU = torch.device("cpu")
OVERRIDES = {**SMALL, "train_images": 12, "profile_batches": 1}
TINY = {"embed_dims": [8, 16, 24, 32], "num_heads": [1, 2, 3, 4], "depths": [1, 1, 2, 1],
        "decoder_embed_dim": 32}


@pytest.fixture(scope="module")
def small_root(tmp_path_factory):
    """A copy of the benchmark whose SegFormer configuration has TINY's widths
    and depths."""
    root = tmp_path_factory.mktemp("bench")
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    shutil.copytree(ROOT / "benchmark", root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    path = root / "benchmark/configs/segformer_b5_rap_cs_bdd.json"
    path.write_text(json.dumps({**json.loads(path.read_text()), **TINY}))
    return root


def test_the_cell_loads_with_its_files():
    cell = harness.Cell.load(ROOT, CELL)
    assert (cell.chips, cell.traffic["loop"], cell.config["model"]) == (1, "train_step_segformer",
                                                                        "segformer_rap")
    assert [m["name"] for m in cell.end_to_end] == ["setup_s", "train_img_s", "train_step_p90_ms"]
    assert [m["name"] for m in cell.per_layer] == ["mfu.train", "device_idle.train",
                                                   "cudnn_ms.train", "attn_roofline.train"]
    assert set(cell.limits) == set(harness.Cell.load(ROOT, "step2_fp32").limits)
    assert cell.loop_class().kind == "train" and len(cell.readers()) == 4
    spec = spec_of(cell.config)
    assert spec["depths"] == (3, 6, 40, 3) and spec["embed_dims"] == (64, 128, 320, 512)


def test_a_small_run_on_the_cpu_is_correct(small_root):
    cell = harness.Cell.load(small_root, CELL, OVERRIDES)
    result = harness.run(cell, SEED, 0.5, False, CPU, time.perf_counter())
    assert result["correct"] is True, result["checks"]
    assert set(result["metrics"]) == {"setup_s", "train_img_s", "train_step_p90_ms"}


@pytest.mark.parametrize("fault", ["unchanged", "new_lr_on_shared", "shared_lr_on_new"])
def test_a_planted_fault_is_not_correct(small_root, fault):
    cell = harness.Cell.load(small_root, CELL, OVERRIDES)
    with faults.planted(fault):
        result = harness.run(cell, SEED, 0.5, False, CPU, time.perf_counter())
    assert result["correct"] is False, result["checks"]


def _swapped_order(self, rng, batch):
    head = rng.random((batch, self.spec.decoder_dim)) < 1.0 - self.spec.head_dropout
    keep = 1.0 - self.spec.drop_path_rates()
    return {"drop_path": rng.random((self.blocks, 2, batch)) < keep[:, None, None], "head": head}


def _wrong_head_rate(self, rng, batch):
    keep = 1.0 - self.spec.drop_path_rates()
    return {"drop_path": rng.random((self.blocks, 2, batch)) < keep[:, None, None],
            "head": rng.random((batch, self.spec.decoder_dim)) < 0.5}


@pytest.mark.parametrize("draw", [_swapped_order, _wrong_head_rate])
def test_keep_masks_drawn_wrong_by_the_program_are_not_correct(small_root, monkeypatch, draw):
    """The reference draws its own keep-masks from the program's generator, so
    a program that draws them in another order or at another rate fails."""
    monkeypatch.setattr(SegFormerRAP, "make_dropout_masks", draw)
    cell = harness.Cell.load(small_root, CELL, OVERRIDES)
    result = harness.run(cell, SEED, 0.5, False, CPU, time.perf_counter())
    assert result["correct"] is False, result["checks"]


def test_the_control_is_not_correct(small_root):
    cell = harness.Cell.load(small_root, CELL, OVERRIDES)
    loop = cell.loop_class()(cell, SEED, CPU)
    loop.setup()
    loop.program_readings()
    ref = loop.reference_readings(tf32=False)
    ok, checks = harness.judge(loop.compare(loop.reference_readings(tf32=True), ref), cell.limits)
    assert not ok, checks


def test_the_reference_loads_nothing_of_the_program():
    code = (f"import json, sys; sys.path.insert(0, {str(ROOT)!r}); "
            "import benchmark.reference.segformer_rap, benchmark.segformer_count; "
            "print(json.dumps(sorted(sys.modules)))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True)
    top = {m.split(".")[0] for m in json.loads(out.stdout.splitlines()[-1])}
    assert not top & {"jax", "jaxlib", "flax", "mdilss_tpu", "mdilss_tpu_torch"}, top


def _record(fwd: int, grad: int, kernel_ms: dict, kind="train") -> dict:
    config = json.loads((ROOT / "benchmark/configs/segformer_b5_rap_cs_bdd.json").read_text())
    return {"kind": kind, "config": config,
            "traffic": {"batch": 6, "height": 512, "width": 1024},
            "trace": {"batches": 2, "launches": {"K1": 0, "K2": 0, "K3": 0, "ATTN_FWD": fwd,
                                                 "ATTN_GRAD": grad},
                      "kernel_ms": kernel_ms}}


def test_attn_roofline_reads_a_hand_built_record():
    (m, read), = [(m, r) for m, r in harness.Cell.load(ROOT, CELL).readers()
                  if m["name"] == "attn_roofline.train"]
    assert (m["layer"], m["moves"], m["unit"]) == ("kernels", "train_img_s", "%")
    # two step-2 batches: 3 forwards of 52 attention calls each, 2 of them with grad
    kernels = {"fmha_cutlassF_f32_aligned_64x64_rf_sm80(AttentionKernel::Params)": 30.0,
               "fmha_cutlassB_f32_aligned_64x64_k64_sm80(AttentionBackwardKernel::Params)": 50.0,
               "void cutlass::Kernel2<sgemm>": 400.0}
    # the bound by hand: per forward, 4 B h Nq Nk d FLOPs at 165 TFLOP/s in each stage
    # (every stage has 512 keys at 512 x 1024: flop-bound throughout)
    flops = sum(depth * 4 * 6 * heads * nq * 512 * 64 for depth, heads, nq in
                ((3, 1, 128 * 256), (6, 2, 64 * 128), (40, 5, 32 * 64), (3, 8, 16 * 32)))
    fwd_ms = flops / 165e12 * 1e3
    want = 100 * (6 * fwd_ms + 4 * 2 * fwd_ms) / 80.0
    assert read(_record(6 * 52, 4 * 52, kernels)) == pytest.approx(want, rel=1e-6)
    b = segformer_count.attention_bound_ms(spec_of(_record(0, 0, {})["config"]), 6, 512, 1024,
                                           "float32")
    assert b["calls"] == 52 and b["fwd_ms"] == pytest.approx(fwd_ms, rel=1e-9)
    assert read(_record(0, 0, kernels)) is None  # no attention counted
    assert read(_record(6 * 52, 4 * 52, {"other": 1.0})) is None  # no attention kernel traced
    assert read(_record(6 * 52, 4 * 52, kernels, kind="eval")) is None
