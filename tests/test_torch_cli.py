"""The port's command line (`python -m mdilss_tpu_torch`, mdilss_tpu_torch/cli.py),
each case of tests/test_cli_surface.py that this slice holds, on the CPU at
its TINY size (--device cpu): the chain through the CLI, eval and its
--expect gate, the convert round trip, the baselines, the reversed ft chain,
weights against the JAX package's, the pipeline; plus what the port adds:
predict, tsne, export and parity-check on the chain's checkpoints; checked
--data-root values, what waits (bench: A2) or is refused (an ablation kind on a
file; the ablation models are in tests/test_torch_ablations.py), and
every option of the JAX package's subcommands present in the port's (from
both --help texts)."""
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from mdilss_tpu_torch.cli import main as cli_main
from mdilss_tpu_torch.ckpt import torch_io
from mdilss_tpu_torch.evaluate import infer_num_classes
from mdilss_tpu_torch.models import ERFNetRAP

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ["--height", "32", "--width", "64", "--batch-size", "2", "--num-epochs", "1",
        "--synthetic", "--synthetic-size", "4", "--num-workers", "0", "--no-device-cache",
        "--device", "cpu"]
EVAL = ["--synthetic", "--height", "32", "--width", "64", "--device", "cpu"]
# the JAX package's options with no counterpart here (ROADMAP C): XLA's compilation
# cache, and the JAX backend switch (the port's is --device)
JAX_ONLY = {"--platform", "--compilation-cache"}


def _run(capsys, argv):
    cli_main(argv)
    out = capsys.readouterr().out.strip().splitlines()
    return json.loads(out[-1])  # the command's JSON summary


@pytest.fixture(scope="module")
def chain_dir(tmp_path_factory):
    """step1 -> step2 -> step3 chained through the CLI, as trainer_OURS.sh."""
    root = tmp_path_factory.mktemp("cli_chain")
    cli_main(["step1", "--savedir", str(root / "step1")] + TINY)
    cli_main(["step2", "--order", "CS_BDD", "--state", str(root / "step1" / "best"),
              "--savedir", str(root / "step2")] + TINY)
    cli_main(["step3", "--order", "CS_BDD_IDD", "--state", str(root / "step2" / "best"),
              "--savedir", str(root / "step3")] + TINY)
    return root


def test_step_chain_artifacts(chain_dir):
    for stage in ("step1", "step2", "step3"):
        d = chain_dir / stage
        assert (d / "opts.txt").exists() and (d / "model.txt").exists()
        assert (d / "automated_log.txt").exists()
        assert torch_io.latest_epoch(str(d / "best")) == 1
    assert infer_num_classes(str(chain_dir / "step3" / "best")) == [20, 20, 27]


def test_cli_eval_rap_synthetic(chain_dir, capsys):
    res = _run(capsys, ["eval", str(chain_dir / "step3" / "best"), "--kind", "rap",
                        "--datasets", "cityscapes", "BDD", "IDD"] + EVAL)
    assert set(res) == {"cityscapes", "BDD", "IDD"}
    assert all(0.0 <= v <= 1.0 for v in res.values())


def test_cli_eval_expect_gate_fails_on_synthetic(chain_dir):
    with pytest.raises(SystemExit) as e:
        cli_main(["eval", str(chain_dir / "step3" / "best"), "--kind", "rap",
                  "--datasets", "cityscapes", "BDD", "IDD", "--expect",
                  "step3_CS_BDD_IDD"] + EVAL)
    assert e.value.code == 1


def test_cli_convert_round_trip(chain_dir, tmp_path, capsys):
    """A checkpoint directory -> --export .pth.tar (the reference's dict,
    `module.` keys, loads strict into ERFNetRAP) -> a checkpoint directory:
    the same weights, the same mIoU; --nb-tasks keeps the first tasks."""
    best = str(chain_dir / "step2" / "best")
    pth = str(tmp_path / "exported.pth.tar")
    cli_main(["convert", best, pth, "--export", "--kind", "rap"])
    blob = torch.load(pth, weights_only=False)
    assert set(blob) == {"epoch", "arch", "state_dict", "best_acc", "optimizer"}
    assert all(k.startswith("module.") for k in blob["state_dict"])
    ERFNetRAP([20, 20], 2, device="cpu").load_state_dict(torch_io.load_pth_tar(pth))
    cli_main(["convert", pth, str(tmp_path / "back"), "--kind", "rap", "--nb-tasks", "2"])
    a = torch_io.load_state(best, "rap")
    b = torch_io.load_state(str(tmp_path / "back"), "rap")
    assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
    capsys.readouterr()
    runs = [_run(capsys, ["eval", p, "--datasets", "cityscapes", "BDD"] + EVAL)
            for p in (best, pth, str(tmp_path / "back"))]
    assert runs[0] == runs[1] == runs[2]
    cli_main(["convert", pth, str(tmp_path / "one"), "--kind", "rap"])  # --nb-tasks 1
    assert infer_num_classes(str(tmp_path / "one")) == [20]


def test_cli_single_multitask_ft(tmp_path, capsys):
    res = _run(capsys, ["single", "--dataset", "IDD", "--savedir", str(tmp_path / "single")]
               + TINY)
    assert res["epoch"] == 1 and "val_acc_IDD" in res
    res = _run(capsys, ["multitask", "--savedir", str(tmp_path / "mt")] + TINY)
    assert res["lr_shared"] == pytest.approx(5e-4 / 3) and "val_acc_cityscapes" in res
    res = _run(capsys, ["ft", "--heads", "2", "--feature-extraction",
                        "--savedir", str(tmp_path / "fe")] + TINY)
    assert "val_acc_BDD" in res and "val_acc_cityscapes" in res
    opts = json.loads((tmp_path / "fe" / "opts.txt").read_text())
    assert opts["protocol"] == "fe" and opts["model"] == "erfnet_ftp1"


def test_cli_ft_order_reversed_chain(tmp_path, capsys):
    """The reversed fine-tune chain (notebook cell 22): `ft --order CS_IDD`,
    then the 3-head stage from it, evaluable as kind ftp2 against the
    recorded setting (a fresh tiny model fails the gate)."""
    _run(capsys, ["ft", "--order", "CS_IDD", "--savedir", str(tmp_path / "ft2")] + TINY)
    opts = json.loads((tmp_path / "ft2" / "opts.txt").read_text())
    assert opts["datasets"] == ["cityscapes", "IDD"] and opts["current_task"] == 1
    assert infer_num_classes(str(tmp_path / "ft2" / "best")) == [20, 27]
    _run(capsys, ["ft", "--order", "CS_IDD_BDD", "--state", str(tmp_path / "ft2" / "best"),
                  "--savedir", str(tmp_path / "ft3")] + TINY)
    assert infer_num_classes(str(tmp_path / "ft3" / "best")) == [20, 27, 20]
    with pytest.raises(SystemExit):
        cli_main(["eval", str(tmp_path / "ft3" / "best"), "--kind", "ftp2", "--datasets",
                  "cityscapes", "IDD", "BDD", "--expect", "ft_step3_CS_IDD_BDD"] + EVAL)


def test_cli_weights_equals_jax(tmp_path, capsys):
    """`weights` on a tiny Cityscapes tree: the JAX package's command's output."""
    from mdilss_tpu.cli import main as jax_cli_main

    rng = np.random.default_rng(0)
    (tmp_path / "leftImg8bit" / "train" / "c").mkdir(parents=True)
    (tmp_path / "gtFine" / "train" / "c").mkdir(parents=True)
    for i in range(2):
        Image.fromarray(rng.integers(0, 255, (32, 64, 3), np.uint8)).save(
            tmp_path / "leftImg8bit" / "train" / "c" / f"c_{i:06d}_leftImg8bit.png")
        lbl = rng.integers(0, 20, (32, 64), np.uint8)
        lbl[:4] = 255
        Image.fromarray(lbl, mode="L").save(
            tmp_path / "gtFine" / "train" / "c" / f"c_{i:06d}_gtFine_labelTrainIds.png")
    argv = ["weights", "--dataset", "cityscapes", "--subset", "train", "--data-root",
            f"cityscapes={tmp_path}", "--height", "32", "--width", "64", "--q", "1.2"]
    got = _run(capsys, argv)
    jax_cli_main(argv)
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert got == want and len(got["weights"]) == 20 and got["weights"][-1] == 0.0
    with pytest.raises(SystemExit) as e:
        cli_main(["weights", "--dataset", "BDD"])
    assert e.value.code == 2 and "--data-root BDD=PATH" in capsys.readouterr().err


def test_cli_pipeline_two_stages(tmp_path, capsys):
    res = _run(capsys, ["pipeline", "--order", "CS_BDD_IDD", "--stages", "step1", "step2",
                        "--savedir", str(tmp_path / "pipe")] + TINY)
    assert set(res) == {"step1", "step2"}
    assert torch_io.latest_epoch(str(tmp_path / "pipe" / "step2" / "best")) == 1


def test_cli_predict_and_tsne(chain_dir, tmp_path, capsys):
    """`predict` and `tsne` of step3/best's head 2 (IDD) on synthetic images."""
    best = str(chain_dir / "step3" / "best")
    res = _run(capsys, ["predict", best, "--task", "2", "--dataset", "IDD", "--out-dir",
                        str(tmp_path / "pred"), "--max-images", "3", "--save-gt"] + EVAL)
    assert res == {"written": 6, "out_dir": str(tmp_path / "pred")}
    names = sorted(os.listdir(tmp_path / "pred"))
    assert names[:2] == ["synthetic27_00000_gt.png", "synthetic27_00000_pred.png"]
    assert np.asarray(Image.open(tmp_path / "pred" / names[1])).shape == (32, 64, 3)
    pytest.importorskip("sklearn")
    pytest.importorskip("matplotlib")
    res = _run(capsys, ["tsne", best, "--task", "2", "--which", "penultimate", "--first-image",
                        "--n-samples", "50", "--out", str(tmp_path / "t" / "tsne.png")] + EVAL)
    assert res == {"image": "index0", "plot": str(tmp_path / "t" / "tsne.png"), "n_points": 50}
    assert os.path.getsize(tmp_path / "t" / "tsne.png") > 0


def test_cli_export_and_serve(chain_dir, tmp_path, capsys):
    """`export` of step3/best's head 2 for the CPU with labels baked in: the
    artifact serves the in-process forward's labels."""
    from mdilss_tpu_torch import serving
    from mdilss_tpu_torch.evaluate import load_checkpoint

    best, out = str(chain_dir / "step3" / "best"), str(tmp_path / "serving")
    meta = _run(capsys, ["export", best, out, "--tasks", "2", "--output", "labels", "--dtype",
                         "float32", "--height", "32", "--width", "64", "--platforms", "cpu"])
    assert meta["tasks"] == [2] and meta["num_classes"] == [20, 20, 27]
    assert meta["platforms"] == ["cpu"] and meta["batch_size"] == 1
    assert sorted(os.listdir(out)) == ["head2.cpu.pt2", "meta.json"]
    x = [np.random.default_rng(0).integers(0, 256, (1, 32, 64, 3), np.uint8)]
    got, = serving.serve_batches(out, 2, x, device="cpu")
    fn = serving.build_infer_fn(load_checkpoint(best, kind="rap", device="cpu"), 2,
                                output="labels", compute_dtype=torch.float32)
    want, = serving.serve_fn_batches(fn, x, 32, 64)
    np.testing.assert_array_equal(got, want)
    with pytest.raises(SystemExit) as e:
        cli_main(["export", best, out, "--platforms", "tpu"])
    assert e.value.code == 2


def test_cli_parity_check(chain_dir, tmp_path, capsys):
    """`parity-check --synthetic` over the chain's checkpoint directories, named
    by a manifest: the three mapped settings fail their gates (random data),
    the other six miss their checkpoints, the report is written and the exit
    code is 1; --f64 needs --device cpu."""
    manifest = {"step1": "step1/best", "step2_CS_BDD": "step2/best",
                "step3_CS_BDD_IDD": "step3/best"}
    with open(chain_dir / "parity_manifest.json", "w") as f:
        json.dump(manifest, f)
    try:
        with pytest.raises(SystemExit) as e:
            cli_main(["parity-check", str(chain_dir), "--out", str(tmp_path / "report.json")]
                     + EVAL)
    finally:
        os.unlink(chain_dir / "parity_manifest.json")
    assert e.value.code == 1
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    report = json.loads((tmp_path / "report.json").read_text())
    assert printed == report and report["ok"] is False
    assert report["summary"] == {"pass": 0, "fail": 3, "missing_checkpoint": 6, "error": 0,
                                 "total": 9}
    for setting, rel in manifest.items():
        entry = report["settings"][setting]
        assert entry["status"] == "fail" and entry["checkpoints"] == [str(chain_dir / rel)]
        assert set(entry["results"]) == set(entry["expected"])
    with pytest.raises(SystemExit) as e:
        cli_main(["parity-check", str(chain_dir), "--f64"])
    assert e.value.code == 2


def test_cli_rejects_unknown_command():
    with pytest.raises(SystemExit):
        cli_main(["frobnicate"])


@pytest.mark.parametrize("value", ["cityscapes", "=/data/cs", "cityscapes=", ""])
def test_cli_rejects_bad_data_root(value, capsys):
    """A --data-root without NAME=PATH exits 2 with a usage message naming it
    (the JAX package's bare split raises an opaque ValueError)."""
    for argv in (["step1", "--data-root", value], ["eval", "x", "--data-root", value],
                 ["weights", "--data-root", value]):
        with pytest.raises(SystemExit) as e:
            cli_main(argv)
        err = capsys.readouterr().err
        assert e.value.code == 2 and "usage:" in err and f"{value!r}" in err, err


# the ablation kinds load from the port's checkpoint directories only: on anything else
# (here a .pth.tar) they exit naming the missing torch grammar
NO_GRAMMAR = "the ablation models have no torch checkpoint grammar"


@pytest.mark.parametrize("argv,item", [
    (["tsne", "ck.pth.tar", "--kind", "erfnet_bn"], NO_GRAMMAR),
    (["predict", "ck.pth.tar", "--kind", "erfnet_onlyRAP"], NO_GRAMMAR),
    (["export", "ck.pth.tar", "out", "--kind", "erfnet_RA_series"], NO_GRAMMAR),
    (["eval", "ck.pth.tar", "--kind", "erfnet_RCM"], NO_GRAMMAR),
    # the port's benchmark is benchmark/run.py; `bench` names it (the id kept)
    pytest.param(["bench"], "python3 benchmark/run.py", id="argv4-ROADMAP A2"),
])
def test_cli_waiting_subcommands_exit(argv, item):
    with pytest.raises(SystemExit) as e:
        cli_main(argv)
    assert isinstance(e.value.code, str) and item in e.value.code


def test_cli_ablation_models_and_device(tmp_path):
    with pytest.raises(ValueError, match="fused paths cover the rap/plain encoders only"):
        cli_main(["step1", "--model", "erfnet_bn", "--fused-train", "--savedir",
                  str(tmp_path / "a")] + TINY)
    with pytest.raises(SystemExit) as e:
        cli_main(["eval", "ck", "--f64"])
    assert e.value.code == 2
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cli_main(["step1", "--savedir", str(tmp_path / "b")] + TINY[:-2])


def _options(main, cmd: str, capsys) -> set[str]:
    with pytest.raises(SystemExit) as e:
        main([cmd, "--help"])
    assert e.value.code == 0
    # the options' own lines (indented two spaces), not mentions in help texts
    return set(re.findall(r"^  (?:-\w, )?(--[a-z0-9][a-z0-9-]*)", capsys.readouterr().out,
                          re.M))


@pytest.mark.parametrize("cmd", ["step1", "step2", "step3", "multitask", "single", "ft",
                                 "pipeline", "eval", "convert", "weights", "tsne", "predict",
                                 "export", "parity-check"])
def test_cli_has_every_jax_option(cmd, capsys):
    from mdilss_tpu.cli import main as jax_cli_main

    want = _options(jax_cli_main, cmd, capsys) - JAX_ONLY
    got = _options(cli_main, cmd, capsys)
    assert want and not want - got, want - got


def test_help_loads_no_jax():
    code = ("import runpy, sys\n"
            "sys.argv = ['mdilss_tpu_torch', '--help']\n"
            "try:\n"
            "    runpy.run_module('mdilss_tpu_torch', run_name='__main__')\n"
            "except SystemExit as e:\n"
            "    assert e.code == 0, e.code\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'mdilss_tpu')]\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0 and "step1" in r.stdout, r.stdout + r.stderr
