"""`correct` comes out false when the timed path is broken underneath: the
harness's look for a card skipped, the rest of a run driven on the CPU at a
small size, with each fault a cell can have planted (faults.py), and with
the control (the reference with TF32 operands) in the program's place."""
import time

import pytest
import torch

from benchmark import faults, harness

from ._small import OVERRIDES, ROOT, SEED

CPU = torch.device("cpu")
CASES = [("step2_fp32", "unchanged"), ("step2_fp32", "half_batch"),
         ("step3_fp32", "unchanged"), ("step3_fp32", "half_batch"),
         ("step2_fp32", "new_lr_on_shared"), ("step2_fp32", "shared_lr_on_new"),
         ("step3_fp32", "new_lr_on_shared"), ("step3_fp32", "shared_lr_on_new"),
         ("eval_fp32", "half_batch"), ("eval_fp32", "altered")]


@pytest.mark.parametrize("name,fault", CASES)
def test_a_planted_fault_is_not_correct(name, fault):
    cell = harness.Cell.load(ROOT, name, OVERRIDES[name])
    with faults.planted(fault):
        result = harness.run(cell, SEED, 0.5, False, CPU, time.perf_counter())
    assert result["correct"] is False, result["checks"]


@pytest.mark.parametrize("name", ["step2_fp32", "step3_fp32", "eval_fp32"])
def test_the_control_is_not_correct(name):
    """The reference in TF32, in the program's place, against the cell's limits."""
    cell = harness.Cell.load(ROOT, name, OVERRIDES[name])
    loop = cell.loop_class()(cell, SEED, CPU)
    loop.setup()
    if loop.kind != "train":
        loop.window(0.5)
    loop.program_readings()
    ref = loop.reference_readings(tf32=False)
    ok, checks = harness.judge(loop.compare(loop.reference_readings(tf32=True), ref), cell.limits)
    assert not ok, checks
