"""Loop `train_step_segformer`: the port's incremental training step of a
SegFormer configuration (`models/segformer_rap.py`), fed as the Trainer
feeds it.

It is `train_step`'s loop (its batches, window, checked stretches, readings
and comparison), with what is the model's own in place of ERFNet's: the
weights drawn for SegFormer's parameters (`state_dict`), the keep-masks the
model draws (`SegFormerRAP.make_dropout_masks`, one dict per student
forward from `numpy.random.default_rng((seed + 1, epoch))`; the reference
draws its own from the generator's state before the program's draws, so a
wrong rate or order in the program's shows in the readings), the FLOPs of
`benchmark/segformer_count.py`, the attention counters beside the K1 / K2 /
K3 ones, and the plain reference of `reference/segformer_rap.py`.

Configuration keys: `train_step`'s, and the published widths and depths
that `reference.segformer_rap.spec_of` reads. Traffic keys: `train_step`'s.
"""
from __future__ import annotations

import copy
import math
import sys
from pathlib import Path

import numpy as np
import torch

from benchmark import compare, inputs, segformer_count
from benchmark.clock import Phases
from benchmark.harness import load_file_module
from benchmark.reference import segformer_rap as ref
from mdilss_tpu_torch.data import transforms
from mdilss_tpu_torch.ops import attention, nb1d_infer, nb1d_train

_base = load_file_module(Path(__file__).with_name("train_step.py"), "benchmark_loop_train_step")
RUNNING = _base.RUNNING


def state_dict(num_classes, spec: dict, gen: torch.Generator, device) -> dict:
    """Random weights of the model with one domain per entry of `num_classes`,
    at the published initialisation's scales: Linear weights normal with
    std 0.02, conv weights normal with std sqrt(2 / fan_out), the classifier
    normal with std 0.01 (NVlabs' `_init_weights`, mmseg's decode head);
    biases normal with std 0.02 and LayerNorm and BN scales U(0.8, 1.2),
    shifts N(0, 0.02), so that no two domains' slices are alike; BN running
    mean N(0, 0.1), running variance U(0.5, 1.5). Two draws in all: one
    normal, one uniform, in `ref.param_spec`'s order."""
    spec_rows = ref.param_spec(num_classes, spec)
    sizes = [math.prod(shape) for _, shape, _ in spec_rows]
    uniform_kinds = ("ln_weight", "bn_weight", "bn_var")
    normal = torch.randn(sum(s for s, (_, _, i) in zip(sizes, spec_rows)
                             if i[0] not in uniform_kinds + ("count",)), generator=gen,
                         device=device)
    uniform = torch.rand(sum(s for s, (_, _, i) in zip(sizes, spec_rows) if i[0] in uniform_kinds),
                         generator=gen, device=device)
    std = {"linear": 0.02, "classifier": 0.01, "bias": 0.02, "ln_bias": 0.02, "bn_bias": 0.02,
           "bn_mean": 0.1}
    sd, u, g = {}, 0, 0
    for (name, shape, init), n in zip(spec_rows, sizes):
        kind = init[0]
        if kind == "count":
            sd[name] = torch.zeros((), dtype=torch.int64, device=device)
        elif kind in uniform_kinds:
            x = uniform[u:u + n].view(shape)
            u += n
            sd[name] = x + 0.5 if kind == "bn_var" else 0.4 * x + 0.8
        else:
            s = math.sqrt(2.0 / init[1]) if kind == "conv" else std[kind]
            sd[name] = (s * normal[g:g + n]).view(shape)
            g += n
    return sd


class Loop(_base.Loop):
    def __init__(self, cell, seed: int, device: torch.device):
        super().__init__(cell, seed, device)
        cfg = self.cfg
        self.spec = ref.spec_of(cfg)
        count = lambda nc, bwd: segformer_count.pass_flops(  # noqa: E731
            self.spec, self.n, self.h, self.w, nc, bwd)
        self.flops = sum(count(cfg["num_classes"][t], True) for t in (self.current, *self.prev))
        self.flops += sum(count(cfg["teacher_num_classes"][t], False) for t in self.prev)

    @staticmethod
    def launch_counters() -> dict:
        return {"K1": nb1d_infer.LAUNCHES, "K2": nb1d_train.LAUNCHES_FWD,
                "K3": nb1d_train.LAUNCHES_BWD, "ATTN_FWD": attention.LAUNCHES_FWD,
                "ATTN_GRAD": attention.LAUNCHES_GRAD}

    def setup(self) -> None:
        cfg, dev = self.cfg, self.device
        phases = Phases(dev)
        b = self.cell.model_module()
        b.build_kernels(dev)
        phases("kernels")
        gen = torch.Generator(device=dev).manual_seed(self.seed)
        teacher_sd = state_dict(cfg["teacher_num_classes"], self.spec, gen, dev)
        student_sd = inputs.student_from_teacher(
            state_dict(cfg["num_classes"], self.spec, gen, dev), teacher_sd)
        self.images, self.labels = inputs.labelled_images(
            self.tr["train_images"], self.h, self.w, self.nc, gen, dev)
        phases("weights and data")
        self.init_student = {k: v.clone() for k, v in student_sd.items()}
        self.init_teacher = {k: v.clone() for k, v in teacher_sd.items()}
        self.teacher = b.model(cfg["teacher_num_classes"], teacher_sd, dev, cfg)
        student = b.model(cfg["num_classes"], student_sd, dev, cfg)
        self.draw_masks = student.make_dropout_masks
        self.lrs = b.lr_tree(student, cfg)
        self.ts = _base.steps.init_train_state(student)
        self.step = self._make_step()
        self.dt = _base.steps.compute_dtype_of(cfg["dtype"])
        self.aug_gen = torch.Generator(device="cpu").manual_seed(self.seed)
        self.np_rng = np.random.default_rng((self.seed + 1, self.epoch))
        self.plan = self._plan()
        self.count, self.sync_loss = 0, None
        self.losses = {k: [] for k in ("loss", "ce", "kld")}
        phases("models and step")
        self.stages = {"setup": self._checked(lambda: phases("first batch"))}
        phases("checked batches")
        print(f"[bench] set-up: {phases}", file=sys.stderr, flush=True)

    def _one_batch(self, keep: bool = False):
        idx = next(self.plan)
        imgs, lbls = inputs.take_rows(self.images, self.labels, idx)
        flip, tx, ty = transforms.draw_augment(self.aug_gen, self.n)
        x, y = transforms.augment_batch(imgs, lbls, flip, tx, ty, num_classes=self.nc,
                                        out_dtype=self.dt)
        rng_state = copy.deepcopy(self.np_rng.bit_generator.state) if keep else None
        masks = [self.draw_masks(self.np_rng, self.n) for _ in range(1 + len(self.prev))]
        self.ts, m = self.step(self.ts, self.teacher, x, y, masks, self.epoch)
        for k in self.losses:
            self.losses[k].append(m[k])
        self.count += 1
        if self.count % self.tr["sync_every"] == 0:
            if self.sync_loss is not None:
                self.sync_loss.item()
            self.sync_loss = m["loss"]
        if keep:
            return {"images": imgs.clone(), "labels": lbls.clone(), "draws": (flip, tx, ty),
                    "rng_state": rng_state, "metrics": m}
        return None

    def _follow(self, c: dict, tf32: bool) -> dict:
        cfg, dev, start = self.cfg, self.device, c["start"]
        names = [k for k in start["sd"] if not k.endswith((*RUNNING, "num_batches_tracked"))]
        lrs = ref.base_lrs(names, current_task=self.current, shared_lr=cfg["shared_lr"],
                           ds_lr=cfg["lr"])
        state = ref.State(start["sd"], lrs, weight_decay=cfg["weight_decay"])
        for k in names:
            state.m[k].copy_(start["m"][k])
            state.v[k].copy_(start["v"][k])
        state.count = start["count"]
        weight = torch.as_tensor(self.weight, device=dev)
        step = ref.STEPS[cfg["step"]]
        losses, moment, raw = [], None, None
        for i, b in enumerate(c["batches"]):
            x, y = ref.augment(b["images"], b["labels"], *b["draws"], self.nc)
            rng = np.random.default_rng()
            rng.bit_generator.state = b["rng_state"]
            keep = [{k: torch.as_tensor(v, device=dev)
                     for k, v in ref.keep_masks(rng, self.spec, self.n).items()}
                    for _ in range(1 + len(self.prev))]
            metrics, grads = step(state, self.init_teacher, x, y, keep, spec=self.spec,
                                  current_task=self.current, prev_tasks=self.prev,
                                  class_weight=weight, lambda_c=cfg["lambda_c"],
                                  lr_scale=ref.poly_lr(self.epoch, cfg["num_epochs"]), tf32=tf32)
            losses.append(metrics)
            if i == 0:
                k_steps = state.count - start["count"]
                moment = {k: float((v.double() - ref.B1 ** k_steps * start["m"][k].double())
                                   .norm()) / (1.0 - ref.B1) for k, v in state.m.items()}
                raw = {k: 0.0 if g is None else float(g.double().norm()) for k, g in grads.items()}
            del grads
        running = [k for k in state.buffers if k.endswith(RUNNING)]
        return {"losses": losses, "moment": moment, "raw_grad": raw,
                "lrs": {k: lr for k, lr in lrs.items() if lr > 0.0},
                "change": compare.change_norms(state.params, start["sd"]),
                "running": compare.change_norms({k: state.buffers[k] for k in running},
                                                start["sd"])}
