"""Loop `eval_heads`: the evaluation users run after an incremental step,
every domain's validation set through its own head, as
`mdilss_tpu_torch.train.loop.Trainer.evaluate` does it.

Per domain in order, batches of the device-resident uint8 set in the
order of `data.loader.batch_indices` (no shuffle, the final batch padded
with a valid mask), `data.transforms.prepare_batch`, the padded images'
labels set to the void class, then `train.steps.make_eval_step` of the
domain's head (eval-mode forward on K1, weighted CE, argmax, confusion
matrix); the host reads the loss of 16 batches before once every 16 from
the 32nd batch of a domain on (the Trainer's lagged sync). The pass over
the domains repeats until the window ends.

`correct` compares a sample of the window's batches, drawn from the seed,
with the plain reference on the same rows: each batch's CE and confusion
matrix.

Configuration keys: `dtype`, `num_classes`, `datasets`, `class_weights`.
Traffic keys: `batch`, `height`, `width`, `val_images` (per domain),
`sync_every`, `sampled_batches`, `profile_batches`.
"""
from __future__ import annotations

import sys
import time

import numpy as np
import torch

from benchmark import compare, inputs, roofline
from benchmark.clock import Phases
from benchmark.reference import train as ref
from mdilss_tpu_torch.data import transforms
from mdilss_tpu_torch.data.loader import batch_indices
from mdilss_tpu_torch.ops import nb1d_infer, nb1d_train
from mdilss_tpu_torch.train import steps


class Loop:
    kind = "eval"

    def __init__(self, cell, seed: int, device: torch.device):
        self.cell, self.seed, self.device = cell, seed, device
        cfg, tr = cell.config, cell.traffic
        self.cfg, self.tr = cfg, tr
        self.n, self.h, self.w = tr["batch"], tr["height"], tr["width"]
        self.classes = list(cfg["num_classes"])
        self.weights = [np.asarray(cfg["class_weights"][d], np.float32) for d in cfg["datasets"]]
        self.flops = [roofline.pass_flops(self.n, self.h, self.w, nc, False) for nc in self.classes]

    @staticmethod
    def launch_counters() -> dict:
        return {"K1": nb1d_infer.LAUNCHES, "K2": nb1d_train.LAUNCHES_FWD,
                "K3": nb1d_train.LAUNCHES_BWD}

    def setup(self) -> None:
        cfg, dev = self.cfg, self.device
        phases = Phases(dev)
        b = self.cell.model_module()
        b.build_kernels(dev)
        phases("kernels")
        gen = torch.Generator(device=dev).manual_seed(self.seed)
        sd = inputs.state_dict(self.classes, gen, dev)
        self.sets = [inputs.labelled_images(n, self.h, self.w, nc, gen, dev)
                     for n, nc in zip(self.tr["val_images"], self.classes)]
        phases("weights and data")
        self.init = {k: v.clone() for k, v in sd.items()}
        self.model = b.model(self.classes, sd, dev)
        self.steps = [steps.make_eval_step(task=t, class_weight=w, num_classes=nc,
                                           compute_dtype=cfg["dtype"])
                      for t, (w, nc) in enumerate(zip(self.weights, self.classes))]
        self.records = []
        self.domain_losses = []
        phases("model and steps")
        for t in range(len(self.classes)):  # every head's shapes, before the window
            idx, valid = next(batch_indices(len(self.sets[t][0]), self.n, seed=self.seed,
                                            epoch=0, shuffle=False, drop_last=False))
            self._one_batch(t, idx, valid)
            phases(f"head {t}'s first batch")
        self.records, self.domain_losses = [], []
        self.plan = self._plan()
        print(f"[bench] set-up: {phases}", file=sys.stderr, flush=True)

    def _plan(self):
        """(task, row indices, valid mask, first batch of its domain), pass
        after pass over the domains."""
        while True:
            for t, (images, _) in enumerate(self.sets):
                for i, (idx, valid) in enumerate(batch_indices(
                        len(images), self.n, seed=self.seed, epoch=0, shuffle=False,
                        drop_last=False)):
                    yield t, idx, valid, i == 0

    def _one_batch(self, t: int, idx, valid) -> None:
        nc = self.classes[t]
        imgs, lbls = inputs.take_rows(*self.sets[t], idx)
        x, y = transforms.prepare_batch(imgs, lbls, num_classes=nc)
        v = torch.as_tensor(valid).to(self.device, non_blocking=True)
        y = torch.where(v[:, None, None], y, nc - 1)
        loss, cm = self.steps[t](self.model, x, y)
        self.records.append((t, idx, valid, loss, cm))
        self.domain_losses.append(loss)
        k = len(self.domain_losses)
        if k % self.tr["sync_every"] == 0 and k >= 2 * self.tr["sync_every"]:
            self.domain_losses[-self.tr["sync_every"] - 1].item()  # the lagged sync

    def _next(self) -> int:
        t, idx, valid, first = next(self.plan)
        if first:
            self.domain_losses = []
        self._one_batch(t, idx, valid)
        return t

    def run_batches(self, n: int) -> None:
        for _ in range(n):
            self._next()

    def window(self, seconds: float) -> dict:
        first = len(self.records)
        flops = 0
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            flops += self.flops[self._next()]
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        elapsed = time.perf_counter() - t0
        done = self.records[first:]
        images = sum(int(np.sum(r[2])) for r in done)
        failed = int((~torch.stack([r[3] for r in done]).isfinite()).sum()) if done else 0
        self.window_records = done
        return {"batches": len(done), "seconds": elapsed, "flops": flops,
                "attempted": len(done), "failed": failed,
                "end_to_end": {"eval_img_s": images / elapsed}}

    def program_readings(self) -> list:
        """The CE and confusion matrix of a sample of the window's batches,
        drawn from the seed. Frees the model."""
        rng = np.random.default_rng(self.seed)
        recs = self.window_records
        pick = sorted(rng.choice(len(recs), size=min(self.tr["sampled_batches"], len(recs)),
                                 replace=False))
        self.sample = [recs[i][:3] for i in pick]
        prog = [(float(recs[i][3]), recs[i][4].cpu()) for i in pick]
        del self.model, self.steps, self.records, self.window_records, self.domain_losses
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        return prog

    def reference_readings(self, tf32: bool) -> list:
        out = []
        for t, idx, valid in self.sample:
            nc = self.classes[t]
            imgs, lbls = inputs.take_rows(*self.sets[t], idx)
            x, y = ref.prepare(imgs, lbls, nc)
            v = torch.as_tensor(valid, device=self.device)
            y = torch.where(v[:, None, None], y, nc - 1)
            loss, cm = ref.eval_batch(self.init, x, y, task=t,
                                      class_weight=torch.as_tensor(self.weights[t],
                                                                   device=self.device),
                                      num_classes=nc, tf32=tf32)
            out.append((loss, cm.cpu()))
        return out

    def compare(self, prog: list, ref_readings: list) -> dict:
        return compare.eval_readings(prog, ref_readings)
