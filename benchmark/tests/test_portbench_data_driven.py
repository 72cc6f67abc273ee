"""The harness is driven by data: a cell, a configuration, a traffic mix and
a per-layer metric added as files and entries are found by name, and a run
without a card exits non-zero and prints no result."""
import json
import shutil
import subprocess
import sys

import pytest

from ._small import ROOT


@pytest.fixture
def copy(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    return tmp_path


def _run(root, *args):
    return subprocess.run([sys.executable, str(root / "benchmark" / "run.py"), *args],
                          capture_output=True, text=True, cwd=root)


def test_added_files_are_found_by_name(copy):
    spec = json.loads((copy / "BENCHMARK.json").read_text())
    conf = json.loads((copy / "benchmark/configs/erfnet_rap_cs_bdd.json").read_text())
    conf["num_classes"] = [20, 19]
    (copy / "benchmark/configs/throwaway_config.json").write_text(json.dumps(conf))
    traffic = json.loads((copy / "benchmark/traffic/distill_step2.json").read_text())
    traffic["batch"] = 3
    (copy / "benchmark/traffic/throwaway_mix.json").write_text(json.dumps(traffic))
    (copy / "benchmark/metrics/throwaway_metric.train.py").write_text(
        "def read(rec):\n    return 42.0 if rec['kind'] == 'train' else None\n")
    spec["configs"].append({"name": "throwaway_config", "source": "https://example.org/paper",
                            "file": "benchmark/configs/throwaway_config.json", "reduced": [],
                            "why": "a test's"})
    spec["workloads"].append({"name": "throwaway_cell", "config": "throwaway_config",
                              "traffic": "throwaway_mix", "chips": 1, "why": "a test's"})
    spec["end_to_end"][1]["workloads"].append("throwaway_cell")
    spec["per_layer"].append({"name": "throwaway_metric.train", "unit": "%", "better": "higher",
                              "source": "device_trace", "layer": "step", "moves": "train_img_s",
                              "workloads": ["throwaway_cell"]})
    (copy / "BENCHMARK.json").write_text(json.dumps(spec))
    out = _run(copy, "--list")
    assert out.returncode == 0, out.stderr
    cells = {c["name"]: c for c in map(json.loads, out.stdout.splitlines())}
    assert set(cells) == {w["name"] for w in spec["workloads"]}
    new = cells["throwaway_cell"]
    assert (new["config"], new["traffic"], new["loop"]) == ("throwaway_config", "throwaway_mix",
                                                              "train_step")
    assert new["per_layer"] == ["throwaway_metric.train"]
    assert "train_img_s" in new["end_to_end"] and "setup_s" in new["end_to_end"]

    sys.path.insert(0, str(copy))
    try:
        from benchmark import harness

        cell = harness.Cell.load(copy, "throwaway_cell")
        (metric, read), = cell.readers()
        assert read({"kind": "train"}) == 42.0
        assert cell.config["num_classes"] == [20, 19] and cell.traffic["batch"] == 3
    finally:
        sys.path.remove(str(copy))


@pytest.mark.parametrize("name", ["step2_fp32", "eval_fp32", "step3_fp32"])
def test_without_a_card_a_run_fails_and_prints_nothing(copy, name):
    out = _run(copy, "--workload", name, "--seed", str(2**31 + 5), "--seconds", "1",
               "--trace", "0")
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_the_benchmarks_files_alone_do_not_run(tmp_path, copy):
    """A directory with BENCHMARK.json and the benchmark's folder only: no
    port to measure, so no result whatever the machine."""
    code = ("import sys; sys.path.insert(0, {r!r}); from benchmark import harness; "
            "c = harness.Cell.load({r!r}, 'step2_fp32'); c.model_module()").format(r=str(copy))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=copy, env={"PATH": "/usr/bin:/bin", "PYTHONPATH": ""})
    assert out.returncode != 0
    assert "mdilss_tpu_torch" in out.stderr
