"""Run configuration: one dataclass + per-protocol presets (the port's own copy
of mdilss_tpu/config.py: the same fields, defaults, checks and presets).

The port's Trainer (train/loop.py) runs every protocol and model. One check
is stricter than the JAX package's: `teacher_dropout` outside step 3 raises
(JAX checks only `two_phase`, mdilss_tpu/config.py:84).

Replaces the reference's six duplicated argparse blocks
(train_RAPFT_step1.py:511-550, train_new_task_step2.py:541-587,
train_new_task_step3.py:605-653, train_multi_task.py:431-470,
main_ftp1_enc_newbn.py:463-499, main_FT2_flexible_new.py:452-490) with one
config type; dataset roots are configurable (the reference hardcoded cluster
paths, train_new_task_step2.py:140-142 — flagged in SURVEY.md §5).
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field


# the reference step-1 factory's ablation entries (train_RAPFT_step1.py:451-460), which the
# JAX package reconstructs (mdilss_tpu/models/erfnet_ablations.py); the port's are
# models/erfnet_ablations.py
ABLATION_MODELS = ("erfnet_bn", "erfnet_onlyRAP", "erfnet_RA_series", "erfnet_RCM")
# SegFormer-B5 with ERFNet-RAP's incremental rule (models/segformer_rap.py, its default
# preset)
SEGFORMER_MODELS = ("segformer_b5_rap",)


@dataclass
class TrainConfig:
    # protocol
    protocol: str = "step1"  # step1 | step2 | step3 | multitask | ft | fe
    # | erfnet | erfnet_multi_task | erfnet_ftp1 | erfnet_ftp2, plus the
    # reconstructed step-1 ablation factory entries erfnet_bn / erfnet_onlyRAP
    # / erfnet_RA_series / erfnet_RCM (train_RAPFT_step1.py:451-460), and
    # segformer_b5_rap (step1 / step2 / step3)
    model: str = "erfnet_RA_parallel"
    datasets: tuple[str, ...] = ("cityscapes",)  # task order; last = current
    num_classes: tuple[int, ...] = (20,)
    current_task: int = 0

    # schedule (reference defaults: README.md:36-42)
    num_epochs: int = 150
    batch_size: int = 6
    height: int = 512
    width: int = 1024
    lr: float = 5e-4  # DS / default group
    shared_lr: float | None = None  # None => protocol default
    weight_decay: float = 1e-4
    lambda_c: float = 0.1  # KLD weight (train_new_task_step2.py:562)
    kld: str = "faithful"  # | corrected
    two_phase: bool = True  # step 3 only: reproduce the 2-optimizer-step batch
    # step 3 only: live Dropout2d on the teacher's KD-target forwards (the
    # reference's model_old never leaves train mode, train_new_task_step3.py:
    # 534-549). Off by default — measured immaterial (docs/DESIGN.md "Step-3
    # teacher dropout"); flip on for a bit-faithful noise model.
    teacher_dropout: bool = False
    eval_every: int = 1  # epochs between current-task validations
    eval_old_every: int = 1  # step2: every epoch; step3 used 10
    iou_train: bool = False  # compute train IoU in the train step (--iouTrain)

    # data
    data_roots: dict = field(default_factory=dict)  # name -> root dir
    synthetic: bool = False  # synthetic data (tests / smoke runs)
    synthetic_size: int = 24
    synthetic_kind: str = "noise"  # | "learnable" (labels derivable from pixels)
    num_workers: int = 8

    # infra
    savedir: str = "runs/dev"
    state: str | None = None  # init checkpoint (.pth.tar or orbax dir)
    pretrained_encoder: str | None = None  # ImageNet encoder (.pth.tar)
    resume: bool = False
    seed: int = 0
    remat: bool = False
    compute_dtype: str = "float32"  # | bfloat16
    # the JAX package's Pallas training blocks; accepted either way here: the
    # port's training blocks always run K2/K3 on the card (plain pairs on the CPU)
    fused_train: bool = False
    # "auto" | "off" | explicit byte budget (e.g. "8589934592"): device-
    # resident uint8 dataset cache; datasets over budget cache partially
    # (data/device_cache.py HybridCache)
    device_cache: str = "auto"
    spatial_shards: int = 1
    log_images: bool = False

    # observability (SURVEY.md §5: the reference had only wall-clock prints)
    profile_dir: str | None = None  # write a torch.profiler chrome trace here
    profile_steps: int = 8  # batches to trace (first epoch, after warmup)

    def __post_init__(self):
        if len(self.datasets) != len(self.num_classes):
            raise ValueError(
                f"datasets {self.datasets} and num_classes {self.num_classes} "
                f"must have the same length (one head per task)"
            )
        if self.teacher_dropout and self.protocol != "step3":
            raise ValueError(
                f"teacher_dropout is a step-3 option (the reference's train-mode "
                f"model_old, train_new_task_step3.py:534-549); protocol {self.protocol!r} "
                f"has no train-mode teacher")
        if self.teacher_dropout and not self.two_phase:
            raise ValueError(
                "teacher_dropout is a step-3 two-phase fidelity option "
                "(train_new_task_step3.py's train-mode model_old); the fused "
                "single-phase step does not implement it"
            )

    def shared_lr_value(self) -> float:
        if self.shared_lr is not None:
            return self.shared_lr
        if self.protocol in ("step2", "step3"):
            return 5e-6  # train_new_task_step2.py:233
        if self.protocol == "multitask":
            return self.lr / len(self.datasets)  # train_multi_task.py:212
        return self.lr

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, default=str)


# ---------------------------------------------------------------------------
# Presets mirroring the reference trainers' invocations (trainer_OURS.sh)
# ---------------------------------------------------------------------------

def _derive_num_classes(kw: dict) -> None:
    """num_classes defaults must follow the caller's `datasets` override,
    not the preset's own default order — a datasets=("IDD",) override with
    the preset's (20,) would silently mis-size the head."""
    if "num_classes" not in kw:
        from .data.sources import DATASET_NUM_CLASSES

        unknown = [d for d in kw["datasets"] if d not in DATASET_NUM_CLASSES]
        if unknown:
            raise ValueError(
                f"cannot derive num_classes for unknown dataset(s) {unknown} "
                f"(known: {sorted(DATASET_NUM_CLASSES)}); pass num_classes "
                "explicitly for custom/synthetic dataset names"
            )
        kw["num_classes"] = tuple(DATASET_NUM_CLASSES[d] for d in kw["datasets"])


def step1(**kw) -> TrainConfig:
    """RAP-FT on Cityscapes from the ImageNet-pretrained encoder.

    Preset fields use setdefault so tests/smoke runs may override e.g.
    num_classes with tiny values."""
    kw.setdefault("datasets", ("cityscapes",))
    _derive_num_classes(kw)
    return TrainConfig(protocol="step1", current_task=0, **kw)


def step2(order: str = "CS_BDD", **kw) -> TrainConfig:
    """CS->BDD (default) or CS->IDD incremental step with distillation."""
    second = {"CS_BDD": ("BDD", 20), "CS_IDD": ("IDD", 27)}[order]
    kw.setdefault("datasets", ("cityscapes", second[0]))
    _derive_num_classes(kw)
    return TrainConfig(protocol="step2", current_task=1, **kw)


def step3(order: str = "CS_BDD_IDD", **kw) -> TrainConfig:
    """Third incremental step (CS|BDD -> IDD by default)."""
    third = {"CS_BDD_IDD": (("cityscapes", "BDD", "IDD"), (20, 20, 27)),
             "CS_IDD_BDD": (("cityscapes", "IDD", "BDD"), (20, 27, 20))}[order]
    kw.setdefault("eval_old_every", 10)  # ref validates all 3 every 10 epochs
    kw.setdefault("datasets", third[0])
    _derive_num_classes(kw)
    return TrainConfig(protocol="step3", current_task=2, **kw)


def multitask(**kw) -> TrainConfig:
    """Joint multi-task baseline over all three domains."""
    kw.setdefault("eval_every", 5)  # ref validates every 5 epochs
    kw.setdefault("eval_old_every", 5)  # ... all domains at the same cadence
    kw.setdefault("datasets", ("cityscapes", "BDD", "IDD"))
    _derive_num_classes(kw)
    return TrainConfig(
        protocol="multitask", model="erfnet_multi_task", current_task=0, **kw,
    )


# Domain orders for the fine-tune baselines — the reference trainers take the
# chain as --dataset-old/--dataset-new (main_ftp1_enc_newbn.py:463-499,
# main_FT2_flexible_new.py:452-490); the Evaluation notebook records both
# 3-head chains (cell 21 CS|BDD->IDD, cell 22 CS|IDD->BDD).
FT_ORDERS = {
    "CS_BDD": ("cityscapes", "BDD"),
    "CS_IDD": ("cityscapes", "IDD"),
    "CS_BDD_IDD": ("cityscapes", "BDD", "IDD"),
    "CS_IDD_BDD": ("cityscapes", "IDD", "BDD"),
}


def ft_step(n_heads: int | None = None, finetune: bool = True,
            order: str | None = None, **kw) -> TrainConfig:
    """Fine-tuning baselines: 2 heads (ftp1) or 3 heads (ftp2);
    finetune=False => feature extraction (new head only).

    `order` names the domain chain (FT_ORDERS; the reference's
    --dataset-old/--dataset-new pairs) — the last domain is the one being
    fine-tuned. Defaults: CS_BDD (2 heads) / CS_BDD_IDD (3 heads)."""
    if order is not None:
        if order not in FT_ORDERS:
            raise ValueError(f"unknown ft order {order!r} (known: {sorted(FT_ORDERS)})")
        if n_heads is not None and n_heads != len(FT_ORDERS[order]):
            raise ValueError(
                f"ft order {order!r} has {len(FT_ORDERS[order])} domains but "
                f"n_heads={n_heads} was passed; drop one of the two"
            )
        kw.setdefault("datasets", FT_ORDERS[order])
        n_heads = len(FT_ORDERS[order])
    elif n_heads is None:
        n_heads = 2
    model = "erfnet_ftp1" if n_heads == 2 else "erfnet_ftp2"
    kw.setdefault("datasets", ("cityscapes", "BDD", "IDD")[:n_heads])
    _derive_num_classes(kw)
    return TrainConfig(
        protocol="ft" if finetune else "fe", model=model,
        current_task=n_heads - 1, **kw,
    )


def singletask(dataset: str = "cityscapes", **kw) -> TrainConfig:
    """Independent single-task ERFNet baseline (the notebooks' `ERFNet_ind`;
    trained upstream by the absent `main.py`, trainer_single_task.sh:46-52).
    Everything trainable at the base LR."""
    kw.setdefault("datasets", (dataset,))
    _derive_num_classes(kw)
    return TrainConfig(
        protocol="singletask", model="erfnet_multi_task", current_task=0, **kw,
    )
