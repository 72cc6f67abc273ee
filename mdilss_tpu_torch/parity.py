"""One-command parity runbook: `python -m mdilss_tpu_torch parity-check`
(port of mdilss_tpu/parity.py).

The reference's reproducibility record is the nine executed settings of
Evaluation_Notebook.ipynb (cells 8-22, transcribed into expected_miou.json).
Given a checkpoint directory and data roots, this locates each setting's
checkpoint, runs the notebook-protocol evaluation
(`evaluate.evaluate_checkpoint`: batch 1, the last class ignored), gates
every domain against the recorded mIoU, and emits ONE pass/fail JSON report.
The day CS/BDD/IDD and the released checkpoints mount, parity is:

    python -m mdilss_tpu_torch parity-check /ckpts \
        --data-root cityscapes=/data/cs --data-root BDD=/data/bdd \
        --data-root IDD=/data/idd

Checkpoint discovery per setting: an explicit `parity_manifest.json` in the
checkpoint root wins ({setting: relpath}; a LIST of relpaths for the
singletask setting's three per-domain checkpoints); otherwise filename
patterns derived from the notebook's own load cells (expected_miou.json
`_source` lines) are matched recursively, over reference `.pth` / `.pth.tar`
files and the port's checkpoint directories (`<dir>/<epoch>.pt`, as the
Trainer writes `<savedir>/best`). A directory of the JAX package (Orbax) is
not a checkpoint here: convert it with `python -m mdilss_tpu convert ...
--export`.
"""
from __future__ import annotations

import fnmatch
import json
import os
import re
from typing import Sequence

import torch

from .evaluate import check_expected, evaluate_checkpoint, load_expected

# Per setting: the evaluation jobs that produce its per-domain mIoU row.
# Most settings are one checkpoint evaluated over all its heads; `singletask`
# is three independent single-task checkpoints (Evaluation_Notebook cells
# 14-16), one per domain. Patterns are tried in order against paths relative
# to the checkpoint root (case-insensitive, '*'-wildcards); the named
# reference files appear in expected_miou.json's _source lines. The same
# table as the JAX package's.
SETTINGS: dict[str, list[dict]] = {
    "step1": [dict(kind="rap", datasets=("cityscapes",),
                   patterns=("*model_best_cityscapes*step1*", "*RAP*step1*",
                             "*step1/best"))],
    "step2_CS_BDD": [dict(kind="rap", datasets=("cityscapes", "BDD"),
                          patterns=("*model_best_BDD*step2*",
                                    "*BDD*step2*", "*CS*BDD*step2/best"))],
    "step2_CS_IDD": [dict(kind="rap", datasets=("cityscapes", "IDD"),
                          patterns=("*model_best_IDD*step2*",
                                    "*IDD*step2*", "*CS*IDD*step2/best"))],
    "step3_CS_BDD_IDD": [dict(kind="rap", datasets=("cityscapes", "BDD", "IDD"),
                              patterns=("*CS1_BDD2_IDD3*step3*",
                                        "*model_best_IDD*step3*",
                                        "*CS*BDD*IDD*step3/best"))],
    "step3_CS_IDD_BDD": [dict(kind="rap", datasets=("cityscapes", "IDD", "BDD"),
                              patterns=("*CS1_IDD2_BDD3*step3*",
                                        "*checkpoint_BDD*step3*",
                                        "*CS*IDD*BDD*step3/best"))],
    "singletask": [
        dict(kind="erfnet", datasets=("cityscapes",),
             patterns=("*model_best_cityscapes_prenc*", "*single*cityscapes*",
                       "*single_cs/best")),
        dict(kind="erfnet", datasets=("BDD",),
             patterns=("*checkpoint_BDD_prenc*", "*single*BDD*")),
        dict(kind="erfnet", datasets=("IDD",),
             patterns=("*checkpoint_IDD_prenc*", "*single*IDD*")),
    ],
    "ft_step2_CS_BDD": [dict(kind="ftp1", datasets=("cityscapes", "BDD"),
                             patterns=("*ftp1*CStoBDD*", "*ftp1*",
                                       "*ft_step2/best"))],
    "ft_step3_CS_BDD_IDD": [dict(kind="ftp2", datasets=("cityscapes", "BDD", "IDD"),
                                 patterns=("*ftp2*CSBDDtoIDD*",
                                           "*ftp2*CS1_BDD2_IDD3*"))],
    "ft_step3_CS_IDD_BDD": [dict(kind="ftp2", datasets=("cityscapes", "IDD", "BDD"),
                                 patterns=("*ftp2*FT_CS1_IDD2_BDD3*",
                                           "*ftp2*CS1_IDD2_BDD3*"))],
}


_EPOCH_FILE = re.compile(r"^\d+\.pt$")  # a checkpoint file of the port (ckpt/torch_io.py)


def _is_port_checkpoint(path: str) -> bool:
    return os.path.isdir(path) and any(
        _EPOCH_FILE.match(c) and os.path.isfile(os.path.join(path, c)) for c in os.listdir(path))


def _candidate_checkpoints(root: str) -> list[str]:
    """All checkpoint-looking paths under root, relative to it: .pth/.pth.tar
    files plus the port's checkpoint directories (a directory with a
    `<digits>.pt` file, `ckpt/torch_io.save`'s layout), which are not
    descended into."""
    out = []
    root = os.path.abspath(os.path.expanduser(root))
    for dirpath, dirnames, filenames in os.walk(root):
        ckpt_dirs = [d for d in dirnames if _is_port_checkpoint(os.path.join(dirpath, d))]
        for d in ckpt_dirs:
            out.append(os.path.relpath(os.path.join(dirpath, d), root))
            dirnames.remove(d)  # don't walk inside checkpoint internals
        for f in filenames:
            if f.endswith((".pth", ".pth.tar")):
                out.append(os.path.relpath(os.path.join(dirpath, f), root))
    return sorted(out)


def _resolve(job_patterns: Sequence[str], candidates: list[str]) -> str | None:
    """First pattern with a match wins; ties within a pattern break sorted."""
    for pat in job_patterns:
        hits = [c for c in candidates if fnmatch.fnmatch(c.lower(), pat.lower())]
        if hits:
            return hits[0]
    return None


def run_parity_check(
    ckpt_root: str,
    *,
    data_roots: dict[str, str] | None = None,
    settings: Sequence[str] | None = None,
    tolerance_points: float = 0.5,
    synthetic: bool = False,
    height: int = 512,
    width: int = 1024,
    batch_size: int = 1,
    compute_dtype: str = "float32",
    device=None,
) -> dict:
    """Evaluate every recorded setting on `device` (None -> the CUDA card)
    and gate it against expected_miou.json.

    Returns the report dict: per-setting {status, checkpoints, results,
    expected, report} plus a summary. `status` is pass | fail |
    missing_checkpoint | error; overall `ok` means all requested settings
    pass. `synthetic=True` dry-runs the full command path on synthetic
    sources (every setting then FAILS its gate; the tests pin the runbook
    end to end with it before real data exists). `compute_dtype="float64"`
    needs `device="cpu"`, as `evaluate_checkpoint`."""
    if compute_dtype == "float64" and (device is None or torch.device(device).type != "cpu"):
        raise ValueError("compute_dtype='float64' runs on the CPU's plain path only: "
                         "pass device='cpu'")
    data_roots = data_roots or {}
    ckpt_root = os.path.abspath(os.path.expanduser(ckpt_root))
    wanted = list(settings) if settings else list(SETTINGS)
    unknown = [s for s in wanted if s not in SETTINGS]
    if unknown:
        raise ValueError(f"unknown setting(s) {unknown}; known: {sorted(SETTINGS)}")

    manifest: dict = {}
    mpath = os.path.join(ckpt_root, "parity_manifest.json")
    if os.path.exists(mpath):
        with open(mpath) as f:
            manifest = json.load(f)
    candidates = _candidate_checkpoints(ckpt_root)

    report: dict = {"ckpt_root": ckpt_root, "tolerance_points": tolerance_points,
                    "synthetic": synthetic, "settings": {}}
    n_pass = n_fail = n_missing = n_error = 0
    for setting in wanted:
        jobs = SETTINGS[setting]
        entry: dict = {"checkpoints": [], "expected": load_expected(setting)}
        # manifest override: one relpath, or a list matching the job count
        override = manifest.get(setting)
        if override is not None and not isinstance(override, list):
            override = [override]
        ckpts: list[str | None] = []
        for i, job in enumerate(jobs):
            if override is not None:
                rel = override[i] if i < len(override) else None
            else:
                rel = _resolve(job["patterns"], candidates)
            ckpts.append(os.path.join(ckpt_root, rel) if rel else None)
        entry["checkpoints"] = ckpts
        if any(c is None for c in ckpts):
            entry["status"] = "missing_checkpoint"
            entry["detail"] = [
                f"no checkpoint matching {job['patterns']} under {ckpt_root}"
                for job, c in zip(jobs, ckpts) if c is None
            ]
            n_missing += 1
            report["settings"][setting] = entry
            continue
        results: dict[str, float] = {}
        try:
            for job, ckpt in zip(jobs, ckpts):
                results.update(evaluate_checkpoint(
                    ckpt, kind=job["kind"], datasets=job["datasets"],
                    data_roots=data_roots, synthetic=synthetic,
                    batch_size=batch_size, height=height, width=width,
                    compute_dtype=compute_dtype, device=device,
                ))
        except Exception as e:  # wrong kind/shape/corrupt file: report, move on
            entry["status"] = "error"
            entry["detail"] = f"{type(e).__name__}: {e}"
            n_error += 1
            report["settings"][setting] = entry
            continue
        ok, text = check_expected(results, setting,
                                  tolerance_points=tolerance_points)
        entry["results"] = {k: round(float(v), 4) for k, v in results.items()}
        entry["status"] = "pass" if ok else "fail"
        entry["report"] = text.splitlines()
        n_pass += ok
        n_fail += not ok
        report["settings"][setting] = entry

    report["summary"] = {"pass": n_pass, "fail": n_fail,
                         "missing_checkpoint": n_missing, "error": n_error,
                         "total": len(wanted)}
    report["ok"] = n_pass == len(wanted)
    return report
