"""The port's parity runbook (mdilss_tpu_torch/parity.py) against the JAX
package's (mdilss_tpu/parity.py), as tests/test_parity_check.py holds the
JAX package: random-weight checkpoints written here under the reference's
own file names, as `.pth.tar` files, and as checkpoint directories that both
packages read (a port `<epoch>.pt` file and a JAX Orbax step directory side
by side in one directory). On synthetic sources every gate fails, which is
the correct outcome; what is pinned is the command path: discovery per
setting, the kind and datasets of each, manifest overrides, the statuses and
the one-JSON report. In float64 on the CPU the per-domain mIoU equals JAX's
(as tests/test_torch_evaluate.py pins `evaluate_checkpoint`)."""
import json
import os
import shutil

import numpy as np
import pytest
import torch

import jax

from _torch_port import randomize_bn
from mdilss_tpu import parity as jparity
from mdilss_tpu.ckpt import export_state_dict, orbax_io
from mdilss_tpu.models import erfnet_multihead as jmh
from mdilss_tpu.models import erfnet_rap
from mdilss_tpu.train import steps as jsteps
from mdilss_tpu_torch import parity
from mdilss_tpu_torch.ckpt import from_jax, torch_io
from mdilss_tpu_torch.models import ERFNetRAP
from mdilss_tpu_torch.train import steps

torch.set_num_threads(1)
H, W = 32, 64


def _pth(path, params, bn, kind):
    sd = export_state_dict(params, bn, kind=kind, prefix="module.")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.save({"epoch": 0, "arch": kind, "best_acc": 0.0, "optimizer": {},
                "state_dict": {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}}, path)


def _both_dirs(path, params, bn, ncls):
    """One directory that is a checkpoint of both packages: the port's
    `1.pt` and JAX's Orbax step `1/`, of the same weights."""
    model = ERFNetRAP(ncls, len(ncls), device="cpu")
    model.load_state_dict(from_jax(params, bn), strict=True)
    torch_io.save(path, 1, steps.init_train_state(model), best_acc=0.0,
                  aug_state=torch.Generator().get_state())
    orbax_io.save(path, 1, jsteps.init_train_state(params, bn), best_acc=0.0,
                  rng=jax.random.key(0))


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = tmp_path_factory.mktemp("parity_ckpts")
    rng = np.random.default_rng(0)
    p, b = randomize_bn(*erfnet_rap.init(jax.random.key(0), [6], 1), rng)
    _pth(str(root / "model_best_cityscapes_RAP_FT_step1.pth.tar"), p, b, "rap")
    p, b = randomize_bn(*erfnet_rap.init(jax.random.key(1), [6, 7], 2), rng)
    _both_dirs(str(root / "runs" / "CS_BDD" / "step2" / "best"), p, b, [6, 7])
    p, b = randomize_bn(*jmh.init(jax.random.key(2), [6, 7]), rng)
    _pth(str(root / "FineTune" / "checkpoint_erfnet_ftp1_CStoBDD-final.pth.tar"), p, b, "ftp1")
    return root


def test_candidates_and_patterns_equal_jax(root, tmp_path):
    """The same candidates (the directory once, not descended into) and the
    same pick per setting; an Orbax-only directory is no candidate of the
    port's, a port-only one none of JAX's."""
    got, want = parity._candidate_checkpoints(str(root)), jparity._candidate_checkpoints(str(root))
    assert got == want == sorted([
        "model_best_cityscapes_RAP_FT_step1.pth.tar", os.path.join("runs", "CS_BDD", "step2", "best"),
        os.path.join("FineTune", "checkpoint_erfnet_ftp1_CStoBDD-final.pth.tar")])
    for setting, jobs in parity.SETTINGS.items():
        for job in jobs:
            assert parity._resolve(job["patterns"], got) == jparity._resolve(job["patterns"], want)
    port_only, orbax_only = tmp_path / "a" / "step1" / "best", tmp_path / "b" / "step1" / "best"
    shutil.copytree(root / "runs" / "CS_BDD" / "step2" / "best", port_only,
                    ignore=shutil.ignore_patterns("[0-9]"))
    shutil.copytree(root / "runs" / "CS_BDD" / "step2" / "best", orbax_only,
                    ignore=shutil.ignore_patterns("*.pt"))
    (tmp_path / "a" / "step1" / "best" / "notes.pth").write_bytes(b"")  # inside: not walked
    assert parity._candidate_checkpoints(str(tmp_path)) == [os.path.join("a", "step1", "best")]
    assert jparity._candidate_checkpoints(str(tmp_path)) == [  # walks into the port's directory
        os.path.join("a", "step1", "best", "notes.pth"), os.path.join("b", "step1", "best")]


def test_f64_report_equals_jax(root):
    """Patterns: three settings found (a `.pth.tar` of kind rap, a directory,
    an ftp1 file), one missing; the same statuses, checkpoint paths, results
    (float64 per-domain mIoU, rounded as the report rounds it), reports and
    summary as JAX's."""
    kw = dict(settings=["step1", "step2_CS_BDD", "ft_step2_CS_BDD", "step3_CS_BDD_IDD"],
              synthetic=True, height=H, width=W, compute_dtype="float64")
    try:
        want = jparity.run_parity_check(str(root), **kw)
    finally:
        jax.config.update("jax_enable_x64", False)
    got = parity.run_parity_check(str(root), device="cpu", **kw)
    assert got == want
    assert {s: e["status"] for s, e in got["settings"].items()} == {
        "step1": "fail", "step2_CS_BDD": "fail", "ft_step2_CS_BDD": "fail",
        "step3_CS_BDD_IDD": "missing_checkpoint"}
    assert got["ok"] is False


def test_manifest_error_and_missing_equal_jax(root):
    """parity_manifest.json overrides discovery (a renamed file, a directory,
    the singletask list with one entry short; a setting it does not name
    falls back to the patterns); a checkpoint of the wrong kind is an `error`
    of its setting and the run goes on; the same statuses and checkpoint
    paths as JAX's (float32)."""
    (root / "renamed").mkdir(exist_ok=True)
    shutil.copy(root / "model_best_cityscapes_RAP_FT_step1.pth.tar",
                root / "renamed" / "oddly_named.pth.tar")
    manifest = {"step1": "renamed/oddly_named.pth.tar",
                "step2_CS_IDD": "runs/CS_BDD/step2/best",
                "ft_step3_CS_BDD_IDD": "renamed/oddly_named.pth.tar",
                "singletask": ["renamed/oddly_named.pth.tar"]}
    with open(root / "parity_manifest.json", "w") as f:
        json.dump(manifest, f)
    kw = dict(settings=["step1", "step2_CS_IDD", "ft_step3_CS_BDD_IDD", "singletask",
                        "ft_step2_CS_BDD"], synthetic=True, height=H, width=W)
    try:
        want = jparity.run_parity_check(str(root), **kw)
        got = parity.run_parity_check(str(root), device="cpu", **kw)
    finally:
        os.unlink(root / "parity_manifest.json")
    assert set(got) == set(want) and got["summary"] == want["summary"]
    for s, w in want["settings"].items():
        g = got["settings"][s]
        assert set(g) == set(w), s
        assert (g["status"], g["checkpoints"], g["expected"]) == (
            w["status"], w["checkpoints"], w["expected"]), s
        if w["status"] == "fail":
            assert set(g["results"]) == set(w["results"]), s
    assert {s: e["status"] for s, e in got["settings"].items()} == {
        "step1": "fail", "step2_CS_IDD": "fail", "ft_step3_CS_BDD_IDD": "error",
        "singletask": "missing_checkpoint", "ft_step2_CS_BDD": "fail"}
    assert got["settings"]["step1"]["checkpoints"][0].endswith(
        os.path.join("renamed", "oddly_named.pth.tar"))


def test_unknown_setting_and_f64_off_the_cpu_raise(tmp_path):
    with pytest.raises(ValueError, match="unknown setting"):
        parity.run_parity_check(str(tmp_path), settings=["step99"], device="cpu")
    with pytest.raises(ValueError, match="float64"):
        parity.run_parity_check(str(tmp_path), compute_dtype="float64", device="cuda")
    report = parity.run_parity_check(str(tmp_path), settings=["step1"], device="cpu")
    assert report["settings"]["step1"]["status"] == "missing_checkpoint"
    assert report["summary"]["total"] == 1 and report["ok"] is False
