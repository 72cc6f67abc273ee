"""One-shot incremental pipeline: step1 -> step2 -> step3 (+ optional
baselines); port of mdilss_tpu/train/pipeline.py.

The reference chained the three training steps through sbatch scripts that
pass each step's best checkpoint to the next
(trainer_files/trainer_OURS.sh:49-63: step1 best .pth.tar -> step2 --state,
step2 best -> step3 --state). This module is that chain as one command:

    python -m mdilss_tpu_torch pipeline --order CS_BDD_IDD --savedir runs/ours ...

Each stage trains under `<savedir>/<stage>/` and the next stage loads
`<savedir>/<prev>/best` (a checkpoint directory of the port; a `.pth.tar` is
accepted for the first stage via --state / --pretrained-encoder).
`--with-baselines` also runs the single-task -> ft chain and the joint
multitask baseline on the same data.
"""
from __future__ import annotations

import os
from typing import Any

from .. import config as C
from ..ckpt import torch_io
from .protocols import build_trainer


def _order_steps(order: str) -> tuple[str, str]:
    """A 3-domain order -> (the step-2 preset's order, the step-3 order)."""
    return {"CS_BDD_IDD": "CS_BDD", "CS_IDD_BDD": "CS_IDD"}[order], order


def run_pipeline(
    *,
    order: str = "CS_BDD_IDD",
    savedir: str = "runs/pipeline",
    common: dict[str, Any] | None = None,
    pretrained_encoder: str | None = None,
    state: str | None = None,
    with_baselines: bool = False,
    stages: tuple[str, ...] = ("step1", "step2", "step3"),
    device=None,
) -> dict[str, dict]:
    """Run the incremental protocol end to end on `device` (None -> the CUDA
    card); returns each trained stage's final row.

    `common` holds TrainConfig kwargs shared by every stage (epochs, batch,
    data roots, ...); each stage's savedir and state are derived here. A
    stage whose `<savedir>/<stage>/best` holds a checkpoint is skipped (a
    crashed pipeline's rerun skips finished stages; resume=True in `common`
    also resumes the interrupted one mid-stage).
    """
    common = dict(common or {})
    common.pop("savedir", None)
    common.pop("state", None)
    order2, order3 = _order_steps(order)
    results: dict[str, dict] = {}
    prev_best = state

    def best(stage: str) -> str:
        return os.path.join(savedir, stage, "best")

    def done(stage: str) -> bool:
        return torch_io.latest_epoch(best(stage)) is not None

    def run(stage: str, cfg) -> None:
        if done(stage):
            print(f"[pipeline] {stage}: found existing {best(stage)}, skipping")
        else:
            print(f"[pipeline] {stage}: training -> {cfg.savedir}")
            results[stage] = build_trainer(cfg, device=device).fit()

    def chain(stage: str, cfg) -> None:
        nonlocal prev_best
        run(stage, cfg)
        prev_best = best(stage)

    def require_prev(stage: str, prev_stage: str) -> str:
        """The checkpoint of an incremental stage whose predecessor did not run
        in this call (--stages step3 to redo the last stage). Without it,
        state=None would take build_trainer's random-teacher smoke path."""
        if prev_best is not None:
            return prev_best
        if done(prev_stage):
            return best(prev_stage)
        raise ValueError(
            f"pipeline stage '{stage}' needs the previous step's checkpoint: "
            f"no {best(prev_stage)} found — include '{prev_stage}' in --stages or pass "
            f"--state")

    def stage_dir(stage: str) -> str:
        return os.path.join(savedir, stage)

    if "step1" in stages:
        chain("step1", C.step1(savedir=stage_dir("step1"), state=prev_best,
                               pretrained_encoder=pretrained_encoder, **common))
    if "step2" in stages:
        chain("step2", C.step2(order=order2, savedir=stage_dir("step2"),
                               state=require_prev("step2", "step1"), **common))
    if "step3" in stages:
        chain("step3", C.step3(order=order3, savedir=stage_dir("step3"),
                               state=require_prev("step3", "step2"), **common))

    if with_baselines:
        # the reference's baseline chains: the fine-tuning chain starts from
        # the single-task Cityscapes baseline's best checkpoint
        # (trainer_fine_tune.sh:54 --state model_best_cityscapes_prenc), which,
        # as the multitask baseline, starts from the ImageNet-pretrained
        # encoder (trainer_single_task.sh:46, trainer_multi_task.sh:50); the ft
        # chain follows --order as the proposed chain does (the notebook
        # records both 3-head ft chains, cells 21-22)
        run("single_cs", C.singletask("cityscapes", savedir=stage_dir("single_cs"),
                                      pretrained_encoder=pretrained_encoder, **common))
        run("ft_step2", C.ft_step(order=order2, savedir=stage_dir("ft_step2"),
                                  state=best("single_cs"), **common))
        run("ft_step3", C.ft_step(order=order3, savedir=stage_dir("ft_step3"),
                                  state=best("ft_step2"), **common))
        run("multitask", C.multitask(savedir=stage_dir("multitask"),
                                     pretrained_encoder=pretrained_encoder, **common))
    return results
