"""Protocol builders: each incremental step's initial weights from the
previous step's checkpoint (port of mdilss_tpu/train/protocols.py).

  step1       the model's initialisation and the ImageNet-pretrained encoder
              (the ERFNet models; SegFormerRAP starts from its own
              initialisation or a full run's checkpoint directory),
              `module.features` -> `module`, strict=False
              (train_RAPFT_step1.py:482-502); an ablation model takes the
              file's shared encoder convs only, through an ERFNet-RAP
              template (`graft_shared_encoder`; no BN, even onlyrap's shared
              BN, mdilss_tpu/train/protocols.py:135-140)
  step2/3     the previous step's checkpoint (its first t tasks; of the
              configuration's model, RAP or ablation): the teacher loads
              them verbatim;
              the student is `extend_for_new_task` of it (the new task's slots
              seeded from task t-1, the new decoder a copy without
              output_conv; train_new_task_step2.py:480-532)
  ft / fe     a single-task checkpoint's decoder -> head 0, the new head
              fresh (main_ftp1_enc_newbn.py:212-221); with 3 heads an ftp1
              checkpoint's decoder_old -> head 0, decoder_new -> head 1
              (main_FT2_flexible_new.py:200-213)
  multitask / singletask  the ImageNet-pretrained encoder (or a full
              same-shape checkpoint directory)

A checkpoint is a reference `.pth.tar` or one of the port's checkpoint
directories (`<savedir>/best`), read by `ckpt.torch_io.load_state`.
"""
from __future__ import annotations

import os

import torch

from ..ckpt import torch_io
from ..ckpt.surgery import (extend_for_new_task, graft_shared_encoder, keep_tasks,
                            load_imagenet_encoder)
from ..config import ABLATION_MODELS, SEGFORMER_MODELS, TrainConfig
from .loop import MULTIHEAD_MODELS, Trainer, init_model, task_stacked_model


def build_trainer(cfg: TrainConfig, device=None) -> Trainer:
    """The Trainer of `cfg` with its protocol's initial weights (and
    teacher), on `device` (None -> the CUDA card)."""
    if cfg.protocol == "step1":
        return _build_step1(cfg, device)
    if cfg.protocol in ("step2", "step3"):
        return _build_incremental(cfg, device)
    if cfg.protocol in ("ft", "fe"):
        return _build_ft(cfg, device)
    if cfg.protocol in ("multitask", "singletask"):
        return _build_plain(cfg, device)
    raise ValueError(cfg.protocol)


def _init_state(cfg: TrainConfig) -> dict:
    return init_model(cfg).state_dict()


def _with_pretrained_encoder(cfg: TrainConfig, path: str) -> dict:
    return load_imagenet_encoder(_init_state(cfg),
                                 torch_io.load_pth_tar(path, strip_module=False))


def _kind(cfg: TrainConfig) -> str:
    """The checkpoint kind of a step protocol's model."""
    return cfg.model if cfg.model in ABLATION_MODELS else "rap"


def _build_step1(cfg: TrainConfig, device) -> Trainer:
    src = cfg.pretrained_encoder or cfg.state
    if not src:
        return Trainer(cfg, device=device)
    if os.path.isdir(src):  # a full 1-task run (a pipeline rerun)
        return Trainer(cfg, init_state=torch_io.load_state(src, _kind(cfg)), device=device)
    if cfg.model in SEGFORMER_MODELS:
        raise ValueError(f"{src}: an ImageNet encoder file is read for the ERFNet models only; "
                         f"model {cfg.model!r} starts from its own initialisation or a "
                         f"checkpoint directory of a full run")
    if cfg.model in ABLATION_MODELS:
        # the file into an ERFNet-RAP template seeded as the JAX package's
        # (erfnet_rap.init(key(seed))), then its shared convs alone
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(cfg.seed)
            template = task_stacked_model("erfnet_RA_parallel", cfg.num_classes).state_dict()
        template = load_imagenet_encoder(template, torch_io.load_pth_tar(src, strip_module=False))
        return Trainer(cfg, init_state=graft_shared_encoder(_init_state(cfg), template),
                       device=device)
    return Trainer(cfg, init_state=_with_pretrained_encoder(cfg, src), device=device)


def _build_incremental(cfg: TrainConfig, device) -> Trainer:
    nb_prev = len(cfg.num_classes) - 1
    prev_nc = list(cfg.num_classes[:nb_prev])
    if cfg.state:  # its first nb_prev tasks, as the JAX package converts nb_tasks of a file
        prev_sd = keep_tasks(torch_io.load_state(cfg.state, _kind(cfg)), nb_prev)
    else:  # smoke runs without a previous checkpoint: torch's init, seed + 1
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(cfg.seed + 1)
            prev_sd = task_stacked_model(cfg.model, prev_nc).state_dict()
    # the teacher copies the weights (load_state_dict), so it shares no tensor
    # with the student
    teacher = task_stacked_model(cfg.model, prev_nc)
    teacher.load_state_dict(prev_sd, strict=True)
    student = extend_for_new_task(prev_sd, cfg.num_classes[-1],
                                  generator=torch.Generator().manual_seed(cfg.seed))
    return Trainer(cfg, teacher=teacher, init_state=student, device=device)


def _build_ft(cfg: TrainConfig, device) -> Trainer:
    if not cfg.state:
        return Trainer(cfg, device=device)
    model = init_model(cfg)
    n = len(cfg.num_classes)
    # the previous run, a single-task model (2 heads) or a 2-head ft model (3 heads):
    # its encoder, and its heads as the old heads; the new head keeps its init (the
    # Trainer's strict load refuses a run that does not fit)
    loaded = torch_io.load_state(cfg.state, "erfnet" if n == 2 else "ftp1")
    sd = model.state_dict()
    sd.update(torch_io.rename_heads(loaded, model.head_prefixes[:n - 1]))
    return Trainer(cfg, init_state=sd, device=device)


def _build_plain(cfg: TrainConfig, device) -> Trainer:
    """multitask / singletask: the reference starts both from the
    ImageNet-pretrained encoder (train_multi_task.py:414-423 loads --state
    with the module.features -> module rename; the single-task baseline's
    --pretrainedEncoder, trainer_single_task.sh:46-52); a checkpoint
    directory restores a full same-shape run instead."""
    src = cfg.pretrained_encoder or cfg.state
    if not src:
        return Trainer(cfg, device=device)
    if os.path.isdir(src):
        kind = MULTIHEAD_MODELS[cfg.model]
        return Trainer(cfg, init_state=torch_io.load_state(src, kind), device=device)
    return Trainer(cfg, init_state=_with_pretrained_encoder(cfg, src), device=device)
