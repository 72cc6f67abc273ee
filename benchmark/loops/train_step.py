"""Loop `train_step`: the port's incremental training step at its published
batch, fed as the Trainer feeds it.

Each batch is a frozen copy of the single-device sequence of
`mdilss_tpu_torch.train.loop.Trainer._one_batch`: rows taken by index from a
device-resident uint8 set in the order of `data.loader.batch_indices` (the
Trainer's device cache), `data.transforms.draw_augment` from a CPU generator
seeded with the run's seed and `augment_batch` on the card,
`models.topology.make_dropout_masks` per forward from
`numpy.random.default_rng((seed + 1, epoch))`, then the step of
`train.steps`: `make_distill_step` (step 2, the eval-mode teacher) or
`make_two_phase_distill_step` (step 3, the teacher in training mode), with
the configuration's presets and the LR dict as the Trainer builds it. Every
16 batches the host reads the loss saved 16 batches before (the Trainer's
bounded pipeline). The schedule's epoch stays the traffic mix's `epoch`.

`correct` compares two stretches of `checked_batches` batches, each driven
through that same call on the same objects, with the plain reference
started from the state the program started them from: set-up's first
batches, from the seed's weights and a fresh Adam, which the window then
trains on; and as many right after the window has closed, from the
program's own weights, running statistics and Adam state as the window
left them, so that the warmed, timed path is held too. Of each stretch:
its inputs and losses, the gradients Adam took in on its first batch, and
the state after its last.

Configuration keys: `dtype`, `num_classes`, `teacher_num_classes`,
`current_task`, `datasets`, `class_weights`, `step` ("distill" or
"two_phase"), `lambda_c`, `lr`, `shared_lr`, `weight_decay`, `num_epochs`.
Traffic keys: `batch`, `height`, `width`, `train_images`, `epoch`,
`sync_every`, `checked_batches`, `profile_batches`.
"""
from __future__ import annotations

import statistics
import sys
import time

import numpy as np
import torch

from benchmark import compare, inputs, roofline
from benchmark.clock import Clock, Phases, p90
from benchmark.reference import train as ref
from mdilss_tpu_torch.data import transforms
from mdilss_tpu_torch.data.loader import batch_indices
from mdilss_tpu_torch.models.topology import make_dropout_masks
from mdilss_tpu_torch.ops import nb1d_infer, nb1d_train
from mdilss_tpu_torch.train import steps

RUNNING = ("running_mean", "running_var")


class Loop:
    kind = "train"

    def __init__(self, cell, seed: int, device: torch.device):
        self.cell, self.seed, self.device = cell, seed, device
        cfg, tr = cell.config, cell.traffic
        self.cfg, self.tr = cfg, tr
        self.n, self.h, self.w = tr["batch"], tr["height"], tr["width"]
        self.current = cfg["current_task"]
        self.prev = tuple(range(self.current - 1, -1, -1))  # newest to oldest, as the Trainer
        self.nc = cfg["num_classes"][self.current]
        self.weight = np.asarray(cfg["class_weights"][cfg["datasets"][self.current]], np.float32)
        self.epoch = tr["epoch"]
        self.flops = sum(roofline.pass_flops(self.n, self.h, self.w, cfg["num_classes"][t], True)
                         for t in (self.current, *self.prev))
        self.flops += sum(roofline.pass_flops(self.n, self.h, self.w, cfg["teacher_num_classes"][t],
                                              False) for t in self.prev)

    @staticmethod
    def launch_counters() -> dict:
        return {"K1": nb1d_infer.LAUNCHES, "K2": nb1d_train.LAUNCHES_FWD,
                "K3": nb1d_train.LAUNCHES_BWD}

    def _make_step(self):
        cfg = self.cfg
        kw = dict(current_task=self.current, prev_tasks=self.prev, class_weight=self.weight,
                  lr_tree=self.lrs, num_epochs=cfg["num_epochs"], lambda_c=cfg["lambda_c"],
                  weight_decay=cfg["weight_decay"], compute_dtype=cfg["dtype"])
        if cfg["step"] == "distill":
            return steps.make_distill_step(**kw)
        return steps.make_two_phase_distill_step(**kw)

    def _plan(self):
        """Row indices of each batch, epoch after epoch from the traffic's."""
        epoch = self.epoch
        while True:
            for idx, _ in batch_indices(len(self.images), self.n, seed=self.seed, epoch=epoch,
                                        shuffle=True, drop_last=True):
                yield idx
            epoch += 1

    def setup(self) -> None:
        cfg, dev = self.cfg, self.device
        phases = Phases(dev)
        b = self.cell.model_module()
        b.build_kernels(dev)
        phases("kernels")
        gen = torch.Generator(device=dev).manual_seed(self.seed)
        teacher_sd = inputs.state_dict(cfg["teacher_num_classes"], gen, dev)
        student_sd = inputs.student_from_teacher(inputs.state_dict(cfg["num_classes"], gen, dev),
                                                 teacher_sd)
        self.images, self.labels = inputs.labelled_images(
            self.tr["train_images"], self.h, self.w, self.nc, gen, dev)
        phases("weights and data")
        self.init_student = {k: v.clone() for k, v in student_sd.items()}
        self.init_teacher = {k: v.clone() for k, v in teacher_sd.items()}
        self.teacher = b.model(cfg["teacher_num_classes"], teacher_sd, dev)
        student = b.model(cfg["num_classes"], student_sd, dev)
        self.lrs = b.lr_tree(student, cfg)
        self.ts = steps.init_train_state(student)
        self.step = self._make_step()
        self.dt = steps.compute_dtype_of(cfg["dtype"])
        self.aug_gen = torch.Generator(device="cpu").manual_seed(self.seed)
        self.np_rng = np.random.default_rng((self.seed + 1, self.epoch))
        self.plan = self._plan()
        self.count, self.sync_loss = 0, None
        self.losses = {k: [] for k in ("loss", "ce", "kld")}
        phases("models and step")
        self.stages = {"setup": self._checked(lambda: phases("first batch"))}
        phases("checked batches")
        print(f"[bench] set-up: {phases}", file=sys.stderr, flush=True)

    def _leaves(self, flat: torch.Tensor) -> dict:
        """{parameter: its slice of one of Adam's flat vectors}."""
        params = list(self.ts.model.named_parameters())
        chunks = flat.split([p.numel() for _, p in params])
        return {k: c.view_as(p) for (k, p), c in zip(params, chunks)}

    def _state(self) -> dict:
        """The program's student and Adam state, copied."""
        opt = self.ts.opt
        return {"sd": {k: v.detach().clone() for k, v in self.ts.model.state_dict().items()},
                "m": self._leaves(opt.m.clone()), "v": self._leaves(opt.v.clone()),
                "count": opt.count}

    def _checked(self, after_first=None) -> dict:
        """`checked_batches` batches through the window's call from the
        program's state as it stands: that state, the batches' inputs and
        losses, the gradients Adam took in on the first and the state after
        the last."""
        start, batches = self._state(), []
        for i in range(self.tr["checked_batches"]):
            batches.append(self._one_batch(keep=True))
            if i == 0:
                moment = self._moment_norms(start)
                if after_first is not None:
                    after_first()
        after = {k: v.detach().clone() for k, v in self.ts.model.state_dict().items()}
        return {"start": start, "batches": batches, "moment": moment, "after": after}

    def _moment_norms(self, start: dict) -> dict:
        """Per leaf, the norm of the gradients (weight decay and freeze masks
        applied) that Adam took in since `start`: (m - b1^k m_start) / (1 - b1)
        over its k steps since."""
        opt = self.ts.opt
        b1k = ref.B1 ** (opt.count - start["count"])
        return {k: float((m.double() - b1k * start["m"][k].double()).norm()) / (1.0 - ref.B1)
                for k, m in self._leaves(opt.m).items()}

    def _one_batch(self, keep: bool = False):
        idx = next(self.plan)
        imgs, lbls = inputs.take_rows(self.images, self.labels, idx)
        flip, tx, ty = transforms.draw_augment(self.aug_gen, self.n)
        x, y = transforms.augment_batch(imgs, lbls, flip, tx, ty, num_classes=self.nc,
                                        out_dtype=self.dt)
        masks = [make_dropout_masks(self.np_rng, self.n) for _ in range(1 + len(self.prev))]
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
                    "masks": masks, "metrics": m}
        return None

    def run_batches(self, n: int) -> None:
        for _ in range(n):
            self._one_batch()

    def window(self, seconds: float) -> dict:
        clock = Clock(self.device)
        first = len(self.losses["loss"])
        start, marks = clock.mark(), []
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            self._one_batch()
            marks.append(clock.mark())
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        elapsed = time.perf_counter() - t0
        n = len(marks)
        failed = int((~torch.stack(self.losses["loss"][first:]).isfinite()).sum()) if n else 0
        intervals = clock.intervals_ms(start, marks)
        print(f"[bench] batch intervals ms: first {[round(x, 1) for x in intervals[:6]]}, "
              f"median {statistics.median(intervals):.1f}, last {[round(x, 1) for x in intervals[-3:]]}",
              file=sys.stderr, flush=True)
        return {"batches": n, "seconds": elapsed, "flops": n * self.flops, "attempted": n,
                "failed": failed,
                "end_to_end": {"train_img_s": n * self.n / elapsed,
                               "train_step_p90_ms": p90(intervals)}}

    def program_readings(self) -> dict:
        """What the timed path produced: per stage (set-up's checked batches,
        and as many driven right after the window has closed) the losses,
        the gradients Adam took in on the first batch, the change of the
        parameters and running statistics after the last; and the frozen
        leaves and the teacher at the end. Frees the program's state."""
        self.stages["window"] = self._checked()
        final = self.ts.model.state_dict()
        frozen = [k for k, lr in self.lrs.items() if lr == 0.0]
        moved = sum(int((final[k] != self.init_student[k]).sum()) for k in frozen)
        t_final = self.teacher.state_dict()
        moved += sum(int((t_final[k] != v).sum()) for k, v in self.init_teacher.items())
        params = list(self.lrs)
        prog = {"frozen_moved": moved}
        for stage, c in self.stages.items():
            before, after = c["start"]["sd"], c["after"]
            running = [k for k in after if k.endswith(RUNNING)]
            prog[stage] = {
                "losses": [{k: float(b["metrics"][k]) for k in ("loss", "ce", "kld")}
                           for b in c["batches"]],
                "moment": c["moment"],
                "change": compare.change_norms({k: after[k] for k in params}, before),
                "running": compare.change_norms({k: after[k] for k in running}, before)}
            for b in c["batches"]:
                del b["metrics"]
            del c["after"]
        del self.ts, self.step, self.teacher, self.images, self.labels, self.losses
        self.sync_loss = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        return prog

    def reference_readings(self, tf32: bool) -> dict:
        """The plain reference through each stage's batches (uint8 rows,
        augment draws, dropout masks) from the state the program started
        them from: its weights, running statistics and Adam state."""
        return {stage: self._follow(c, tf32) for stage, c in self.stages.items()}

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
            keep = [{k: torch.as_tensor(v, device=dev) for k, v in mk.items()} for mk in b["masks"]]
            metrics, grads = step(state, self.init_teacher, x, y, keep, current_task=self.current,
                                  prev_tasks=self.prev, class_weight=weight,
                                  lambda_c=cfg["lambda_c"],
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

    def compare(self, prog: dict, ref_readings: dict) -> dict:
        """Set-up's numbers by their names, the window's with `window.`
        before them, and frozen_moved."""
        out = compare.train_readings(prog["setup"], ref_readings["setup"])
        out.update({f"window.{k}": v for k, v in
                    compare.train_readings(prog["window"], ref_readings["window"]).items()})
        out["frozen_moved"] = float(prog.get("frozen_moved", 0))  # the control moves none
        return out
