"""On the card: one short run of each cell comes out correct, with every
metric of the cell. Skips without a CUDA card."""
import json
import subprocess
import sys

import pytest
import torch

from ._small import ROOT


@pytest.mark.cuda
@pytest.mark.parametrize("name,trace", [("step2_fp32", 0), ("eval_fp32", 1), ("step3_fp32", 0)])
def test_a_short_run_on_the_card(name, trace):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", name, "--seed",
                          str(2**31 + 77), "--seconds", "3", "--trace", str(trace)],
                         capture_output=True, text=True, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.splitlines()[-1])
    assert result["correct"] is True, result["checks"]
    assert result["device"]["platform"] == "gpu"
