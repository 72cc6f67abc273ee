#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (mdilss_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py [--seed 0] [--out build/chip_smoke.json]

Phases, each fatal on failure (non-zero exit):
  1. build every CUDA source of the port with nvcc (sm_90a), one nvcc per
     source started together, and print what ptxas reports (registers,
     shared memory, spills);
  2. hold the inference kernel (K1) against its plain PyTorch version on the
     card at the serving path's real widths (batch 1 and 6, float32 with TF32
     off and bfloat16, random weights and BN statistics, plus one ragged shape);
  3. drive the serving path of the 3-task ERFNet-RAP [20, 20, 27] at 512x1024
     from random weights made with --seed: every head, batch 1 and 6, bf16
     and fp32, logits and labels, and 8 uint8 images per head through
     serve_batches; the K1 launch count is zeroed before this phase and must
     grow by 17 blocks x 2 launches per forward; the fp32 logits are compared
     with the same weights run on the CPU (plain versions) and the bf16
     labels with the fp32 labels;
  4. time each nb1d block shape (kernel with CUDA events and its device time
     from torch.profiler, by kernel name: nb1d_pair_tf32_kernel in fp32,
     nb1d_pair_mma_kernel in bf16; plain version, bound; fp32 also its 3xTF32
     bound) and the whole forward with CUDA events, then profile a few
     forwards (torch.profiler) for the device's busy share and its time by
     kernel;
  5. hold the training conv-pair kernels K2 (fwd_pair) and K3 (bwd_pair),
     float32, against their plain versions run in float64 on the same inputs
     (the float32 plain versions are recorded beside them) at the 7 block
     shapes at batch 6 and one ragged shape, pre-stage and RAP each on and
     off; run each twice and require bitwise-equal outputs; hold K2's batch
     mean and variance against a float64 two-pass over the same y;
  6. hold the training block (Nb1dTrain, K4) against the same block built from
     the plain pairs in float64 at the 7 shapes: output, gradients of x and of
     every weight under a random cotangent, updated running statistics;
  7. drive the step-2 distillation train step at full width and depth: student
     ERFNet-RAP [20, 20] (current task 1, previous task 0), eval-mode teacher
     [20], 6x512x1024 float32, BDD class weights, lambda 0.1, LR 5e-6 shared /
     5e-4 domain-specific, epoch 1 of 150, 5 steps on one batch; the K1/K2/K3
     counts are zeroed before this phase and every step must launch exactly
     34 / 68 / 68; losses finite; frozen parameters bitwise unchanged;
  8. one step at 2x128x256 on the card and on the CPU (plain versions) from
     the same weights, masks and batch: loss, running statistics, gradients;
  9. time the train step (ms/step, img/s, peak memory), profile one step, and
     time K2/K3 per block shape against their plain versions and bounds (the
     fp32 CUDA-core bound and the 3xTF32 tensor-core bound; the device time
     per launch kind from torch.profiler: K2 pair / sum, K3 dc / du / wgrad /
     sum; for K3 also the same weight-gradient products as torch.matmul
     calls, TF32 off, with TF32 on as information), and split the step's
     device time outside K1/K2/K3 into families (cuDNN conv and its backward,
     BN and dropout glue, losses over the logits, Adam, ...) by the torch
     ops and Python frames around each kernel's launch in a second profiled
     step's chrome trace (`ms_by_family`);
 10. drive step 3's two-phase train step at full width and depth (reference
     trainer_OURS.sh step 3, Cityscapes|BDD -> IDD): student ERFNet-RAP
     [20, 20, 27] (current task 2, previous tasks 1 and 0), train-mode
     teacher [20, 20], 6x512x1024 float32, IDD class weights, lambda 0.1, the
     same LRs and epoch, iou_train, 3 batches on one batch of data; the
     counts are zeroed before this phase and every batch must launch exactly
     0 K1 / 170 K2 / 102 K3, take two Adam steps, count every pixel in its
     confusion matrix, and leave the frozen student parameters and every
     teacher parameter and buffer bitwise unchanged; then time the batch
     (ms, img/s, peak memory) and profile one (device busy, idle share,
     K2/K3 device ms);
 11. the other steps: the eval step on head 2 of that student (exactly 34 K1
     and no K2/K3) and one CE step on ERFNet-RAP [20] at 6x512x1024
     (Cityscapes weights; exactly 34 K2 and 34 K3, no K1), each with its
     counts zeroed before it, timed and profiled; then one step-3 batch at
     2x128x256 on the card and on the CPU from the same weights, masks and
     batch (loss, ce, kld and running statistics within 1e-5, the teacher
     unchanged on both), and the eval step on both (loss within 1e-5, the
     confusion matrices equal on the pixels whose CPU top-2 gap exceeds 4x
     the RMS card - CPU logit difference).
It prints the card's name and power limit, one `kernels` JSON line (K1's
entry also carries its 17-block sums at batch 6 in bf16 and fp32; each
entry its launches on every path driven) and, as the last line,
{"ok": true, "device": {...}}. The full record goes to --out.
Without a CUDA card it exits 2 and prints no result.
"""
from __future__ import annotations

import argparse
import copy
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

from mdilss_tpu_torch import serving
from mdilss_tpu_torch.data.class_weights import CLASS_WEIGHTS
from mdilss_tpu_torch.models import ERFNetRAP
from mdilss_tpu_torch.models.blocks import NonBottleneck1d, NonBottleneck1dRAP
from mdilss_tpu_torch.models.topology import make_dropout_masks
from mdilss_tpu_torch.ops import _build
from mdilss_tpu_torch.ops import nb1d_infer as K
from mdilss_tpu_torch.ops import nb1d_train as T
from mdilss_tpu_torch.train import steps
from mdilss_tpu_torch.train.masks import rap_lr_tree

NUM_CLASSES = [20, 20, 27]
HEIGHT, WIDTH = 512, 1024
BATCHES = (1, 6)
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
# kernel vs plain, relative L2: fp32 sums in another order; in bf16 both round
# c to bf16, but the plain version also rounds the 1x3 conv's output, the RAP
# term and their sum to bf16, while the kernel keeps y in fp32 to its epilogue
TOL_REL_L2 = {"f32": 1e-5, "bf16": 2e-2}
TOL_CPU_REL_L2 = 1e-4  # fp32 forward on the card vs on the CPU, ~40 layers deep
MIN_LABEL_AGREEMENT = 0.995
# H100 SXM dense peaks (NVIDIA data sheet): fp32 on the CUDA cores (the plain
# versions' rate), bf16 and TF32 on the tensor cores; HBM3. The fp32 kernels
# (K1 fp32, K2, K3) do each fp32 product as 3 TF32 products (3xTF32), so their
# tensor-core bound is 3x their FLOPs at the TF32 rate, the least time of
# fp32-accurate work, beside the CUDA-core one.
PEAK_FLOPS = {"f32": 67e12, "bf16": 989e12, "tf32": 495e12}
PEAK_BYTES = 3.35e12
LAUNCHES_PER_FORWARD = 17 * K.LAUNCHES_PER_BLOCK
# K1's kernels by name in a profiler trace, both on the tensor cores: fp32 as 3xTF32 on the
# training pair's mainloop (csrc/tf32_pair.cuh), bf16 with bf16 mma.sync
K1_KERNEL = {"f32": "nb1d_pair_tf32_kernel", "bf16": "nb1d_pair_mma_kernel"}
# the nb1d blocks of one 512x1024 forward: (name, C, dilation, rap, H, W, count)
BLOCKS = (
    ("enc64_d1_rap", 64, 1, True, 128, 256, 5),
    ("enc128_d2_rap", 128, 2, True, 64, 128, 2),
    ("enc128_d4_rap", 128, 4, True, 64, 128, 2),
    ("enc128_d8_rap", 128, 8, True, 64, 128, 2),
    ("enc128_d16_rap", 128, 16, True, 64, 128, 2),
    ("dec64_d1", 64, 1, False, 128, 256, 2),
    ("dec16_d1", 16, 1, False, 256, 512, 2),
)
RAGGED = ("ragged128_d16_rap", 128, 16, True, 37, 83, 0)  # H, W multiples of no tile

# the step-2 train step (reference trainer_OURS.sh step 2: Cityscapes -> BDD)
STUDENT_CLASSES, TEACHER_CLASSES = [20, 20], [20]
CURRENT_TASK, PREV_TASKS = 1, (0,)
TRAIN_BATCH, TRAIN_STEPS, NUM_EPOCHS = 6, 5, 150
SHARED_LR, DS_LR, LAMBDA_C = 5e-6, 5e-4, 0.1
SMALL = (2, 128, 256)  # the card-vs-CPU step
# launches per train step: 2 student forwards x 17 blocks x 2 pairs; the teacher's 17 blocks x 2
STEP_LAUNCHES = {"K1": 17 * K.LAUNCHES_PER_BLOCK, "K2": 68, "K3": 68}
# the step-3 train step (reference trainer_OURS.sh step 3: Cityscapes|BDD -> IDD, config.step3):
# the two-phase step with the train-mode teacher
STEP3_STUDENT, STEP3_TEACHER = [20, 20, 27], [20, 20]
STEP3_CURRENT, STEP3_PREV = 2, (1, 0)
STEP3_STEPS = 3
# launches per step-3 batch: 3 student and 2 train-mode teacher forwards x 17 blocks x 2 pairs
# (K2); 3 student backwards x 34 (K3); no K1 (a teacher in eval mode would launch 68)
STEP3_LAUNCHES = {"K1": 0, "K2": 170, "K3": 102}
CE_CLASSES = [20]  # the CE step: step 1 on Cityscapes
CE_LAUNCHES = {"K1": 0, "K2": 34, "K3": 34}  # one student forward and backward
EVAL_LAUNCHES = {"K1": 34, "K2": 0, "K3": 0}  # one eval-mode forward
# the step-3 step at 2x128x256 on the card vs the CPU: loss, ce, kld and the student's running
# statistics (both phases' forwards; phase 2 after an Adam step whose sign noise moves an
# element by at most 2 lr), relative; the eval step's loss likewise
TOL_STEP3 = 1e-5
# K2/K3 (float32) vs their plain versions in float64, relative L2: float32
# sums over up to 786k pixels
TOL_TRAIN_REL_L2 = 1e-5
TOL_STATS_F64 = 1e-4  # K2's E[y^2]-E[y]^2 mean/var against a float64 two-pass
# the training block (float32) vs the same block from the plain pairs in
# float64: the BN backward divides by the batch std, which amplifies the
# pairs' rounding, and a relu whose input lies within float32 rounding of its kink
# flips between float32 and float64 (phase 5 measures the band: one flip in
# ~6M elements moves a weight gradient by ~4e-4), so the gradients are held
# at 2e-3, the JAX package's single-block gradient tolerance
# (tests/test_pallas_train.py:122)
TOL_BLOCK = {"out": 1e-5, "grads": 2e-3, "running": 1e-5}
# one train step on the card vs the CPU: the loss and running statistics are
# smooth functions of the weights and agree to float32 rounding; the gradient
# of this BN+relu stack at random weights is not (a 1e-7 relative change of
# the input moves the CPU's own gradient by 1-2% relative L2), so the whole
# gradient is held to a multiple of that spread measured in the same run, and
# the head's gradient, which is still smooth, to 1e-4
TOL_STEP = {"loss": 1e-5, "running": 1e-5, "head_grads": 1e-4, "grads_vs_spread": 10.0}


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke FAILED: {msg}")


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def randomize_bn(module: torch.nn.Module, gen: torch.Generator) -> None:
    """Random BN affine and running stats (drawn on the CPU from `gen`)."""
    with torch.no_grad():
        for bn in (m for m in module.modules() if isinstance(m, torch.nn.BatchNorm2d)):
            c = bn.num_features
            bn.weight.copy_(torch.empty(c).uniform_(0.5, 1.5, generator=gen))
            bn.bias.copy_(torch.empty(c).normal_(0.0, 0.1, generator=gen))
            bn.running_mean.copy_(torch.empty(c).normal_(0.0, 0.1, generator=gen))
            bn.running_var.copy_(torch.empty(c).uniform_(0.5, 1.5, generator=gen))


def make_block(spec, seed: int, dev: torch.device):
    _, c, d, rap, _, _, _ = spec
    torch.manual_seed(seed)
    blk = NonBottleneck1dRAP(c, d, len(NUM_CLASSES)) if rap else NonBottleneck1d(c, d)
    randomize_bn(blk, torch.Generator().manual_seed(seed + 1))
    return blk.to(dev)


def rel_l2(got: torch.Tensor, want: torch.Tensor) -> float:
    got, want = got.detach().double(), want.detach().double()
    return float((got - want).norm() / want.norm())


def block_bound(n: int, spec, dt: str) -> dict:
    """Least time for one block: each input byte read once and each output
    byte written once (x, weights, per-channel vectors; out), against the
    FLOPs of the two conv pairs, at the card's peak rates for the type. In
    fp32 also `bound_3xtf32_ms`: the same FLOPs as 3xTF32 on the tensor
    cores against the same bytes."""
    _, c, _, rap, h, w, _ = spec
    px, item = n * h * w, torch.finfo(DTYPES[dt]).bits // 8
    flops = px * (28 if rap else 24) * c * c  # 2 x (3C^2 + 3C^2 [+ C^2]) MACs per pixel
    nbytes = item * (2 * px * c + 12 * c * c + (2 * c * c if rap else 0)) + 4 * 6 * c
    t_ops, t_bytes = flops / PEAK_FLOPS[dt], nbytes / PEAK_BYTES
    out = {"flops": flops, "bytes": nbytes, "bound_ms": max(t_ops, t_bytes) * 1e3,
           "bound_by": "operations" if t_ops >= t_bytes else "bytes"}
    if dt == "f32":
        out["bound_3xtf32_ms"] = max(3 * flops / PEAK_FLOPS["tf32"], t_bytes) * 1e3
    return out


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean ms per call over `iters` back-to-back calls, CUDA events, warm L2."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_build() -> dict:
    names = _build.all_sources()
    t0 = time.perf_counter()
    _build.build(names)
    secs = time.perf_counter() - t0
    print(f"[build] {names} in {secs:.1f} s (nvcc {' '.join(_build.NVCC_FLAGS)})")
    for name in names:
        for line in _build.BUILD_LOG[name]["ptxas"].splitlines():
            if any(k in line for k in ("Compiling entry", "registers", "spill")):
                print(f"[build] {name}: {line.strip()}")
    return {"seconds": secs, "log": _build.BUILD_LOG}


def phase_kernels(seed: int, dev: torch.device, blocks, batches) -> list[dict]:
    cases = []
    for i, spec in enumerate(blocks):
        name, c, d, rap, h, w, _ = spec
        blk = make_block(spec, seed + 10 * i, dev)
        gen = torch.Generator().manual_seed(seed + 10 * i + 2)
        for n in batches:
            x32 = torch.randn(n, c, h, w, generator=gen).to(dev)
            for dt, dtype in DTYPES.items():
                x = x32.to(dtype).contiguous(memory_format=torch.channels_last)
                ops = K.prepare_operands(blk, 2 if rap else None, dtype)
                got = K.nb1d_infer(x, ops, d)
                want = K.nb1d_infer_plain(x, ops, d)
                sync(dev)
                case = {"block": name, "shape": [n, h, w, c], "dilation": d, "dtype": dt,
                        "rel_l2": rel_l2(got, want),
                        "max_abs_err": float((got.float() - want.float()).abs().max()),
                        "finite": bool(torch.isfinite(got).all())}
                cases.append(case)
                print(f"[kernel] {name} [{n},{h},{w},{c}] d={d} {dt}: rel_l2 {case['rel_l2']:.3e} "
                      f"max_abs_err {case['max_abs_err']:.3e}")
                check(case["finite"] and case["rel_l2"] <= TOL_REL_L2[dt],
                      f"kernel vs plain {case} above tolerance {TOL_REL_L2[dt]}")
    return cases


def label_agreement(l32: torch.Tensor, l16: torch.Tensor) -> tuple[float, float, float]:
    """(all-pixel agreement, agreement over decided pixels, decided share).
    A pixel is decided when its fp32 top-2 logit gap exceeds 4x the RMS of the
    bf16 - fp32 logit difference; random weights leave many near-ties."""
    agree = l32.argmax(-1) == l16.argmax(-1)
    top2 = l32.topk(2, dim=-1).values
    noise = float((l16 - l32).pow(2).mean().sqrt())
    decided = (top2[..., 0] - top2[..., 1]) > 4 * noise
    return (float(agree.float().mean()), float(agree[decided].float().mean()),
            float(decided.float().mean()))


def phase_main_path(seed: int, dev: torch.device, height: int, width: int, batches):
    torch.manual_seed(seed)
    model = ERFNetRAP(NUM_CLASSES, len(NUM_CLASSES), device=dev)
    randomize_bn(model, torch.Generator().manual_seed(seed + 1))
    rng = np.random.default_rng(seed)
    imgs = {n: torch.from_numpy(rng.random((n, height, width, 3), dtype=np.float32))
            for n in batches}
    served = [[rng.integers(0, 256, (4, height, width, 3), np.uint8) for _ in range(2)]
              for _ in NUM_CLASSES]
    record = {"agreement": [], "cpu_rel_l2": []}
    f32_logits_b1 = {}
    forwards = 0
    K.LAUNCHES = 0
    for task, nc in enumerate(NUM_CLASSES):
        for n in batches:
            out = {}
            for dt, dtype in DTYPES.items():
                for output in ("logits", "labels"):
                    fn = serving.build_infer_fn(model, task, output=output, compute_dtype=dtype)
                    before = K.LAUNCHES
                    y = fn(imgs[n])
                    sync(dev)
                    forwards += 1
                    check(K.LAUNCHES - before == LAUNCHES_PER_FORWARD,
                          f"forward launched {K.LAUNCHES - before} kernels, "
                          f"expected {LAUNCHES_PER_FORWARD}")
                    if output == "logits":
                        check(tuple(y.shape) == (n, height, width, nc) and y.dtype == torch.float32
                              and bool(torch.isfinite(y).all()), f"bad logits {tuple(y.shape)}")
                    else:
                        check(tuple(y.shape) == (n, height, width) and y.dtype == torch.int32
                              and int(y.min()) >= 0 and int(y.max()) < nc, "bad labels")
                    out[dt, output] = y
            # two forwards agree up to cuDNN's run-to-run order (transposed
            # convs may sum with atomics): equal labels off top-2 near-ties
            top2 = out["f32", "logits"].topk(2, dim=-1).values
            clear = (top2[..., 0] - top2[..., 1]) > 1e-4
            same = out["f32", "labels"] == out["f32", "logits"].argmax(-1).int()
            check(bool(same[clear].all()),
                  "fp32 labels differ from the argmax of the fp32 logits off near-ties")
            record.setdefault("rerun_label_flips", []).append(int((~same).sum()))
            agree, agree_decided, share = label_agreement(out["f32", "logits"], out["bf16", "logits"])
            bf16_vs_f32 = float((out["bf16", "labels"] == out["f32", "labels"]).float().mean())
            record["agreement"].append({"task": task, "batch": n, "all_pixels": agree,
                                        "bf16_labels_vs_f32_labels": bf16_vs_f32,
                                        "decided_pixels": agree_decided, "decided_share": share})
            print(f"[main] head {task} batch {n}: bf16 vs fp32 labels agree on {bf16_vs_f32:.5f} "
                  f"of pixels, {agree_decided:.5f} of the {share:.4f} decided ones")
            check(agree_decided >= MIN_LABEL_AGREEMENT,
                  f"bf16 labels agree with fp32 on {agree_decided:.5f} of decided pixels")
            if n == 1:
                f32_logits_b1[task] = out["f32", "logits"].cpu()
        fn = serving.build_infer_fn(model, task, output="labels")
        before = K.LAUNCHES
        got = list(serving.serve_batches(fn, served[task], height, width))
        forwards += len(served[task])
        check(K.LAUNCHES - before == len(served[task]) * LAUNCHES_PER_FORWARD,
              "serve_batches did not launch the kernels of every block")
        check(len(got) == 2 and all(g.shape == (4, height, width) and g.dtype == np.int32
                                    and g.min() >= 0 and g.max() < nc for g in got),
              "serve_batches gave bad labels")
        print(f"[main] head {task}: served 8 uint8 images")
    launches = K.LAUNCHES
    check(launches == forwards * LAUNCHES_PER_FORWARD and launches > 0,
          f"{launches} launches over {forwards} forwards")
    print(f"[main] {forwards} forwards, nb1d kernel launches {launches} "
          f"(= {forwards} x 17 blocks x {K.LAUNCHES_PER_BLOCK})")

    cpu = ERFNetRAP(NUM_CLASSES, len(NUM_CLASSES), device="cpu")
    cpu.load_state_dict(model.state_dict())
    if 1 in imgs:
        for task in range(len(NUM_CLASSES)):
            want = serving.build_infer_fn(cpu, task, compute_dtype=torch.float32)(imgs[1])
            err = rel_l2(f32_logits_b1[task], want)
            record["cpu_rel_l2"].append({"task": task, "rel_l2": err})
            print(f"[main] head {task}: fp32 logits on the card vs the CPU: rel_l2 {err:.3e}")
            check(err <= TOL_CPU_REL_L2, f"card vs CPU logits rel_l2 {err:.3e}")
    record.update(forwards=forwards, launches=launches)
    return model, imgs, record


def phase_times(seed: int, dev: torch.device, model, imgs) -> dict:
    blocks = []
    for i, spec in enumerate(BLOCKS):
        name, c, d, rap, h, w, count = spec
        blk = make_block(spec, seed + 10 * i, dev)
        for n in BATCHES:
            x32 = torch.randn(n, c, h, w, device=dev)
            for dt, dtype in DTYPES.items():
                x = x32.to(dtype).contiguous(memory_format=torch.channels_last)
                ops = K.prepare_operands(blk, 2 if rap else None, dtype)
                kern = lambda: K.nb1d_infer(x, ops, d)  # noqa: E731
                row = {"block": name, "count": count, "shape": [n, h, w, c], "dtype": dt,
                       "kernel_ms": time_ms(kern),
                       "kernel_device_ms": device_ms_by_kind(kern, {"k1": K1_KERNEL[dt]})["k1"],
                       "plain_ms": time_ms(lambda: K.nb1d_infer_plain(x, ops, d)),
                       **block_bound(n, spec, dt)}
                blocks.append(row)
                tf32 = (f", 3xTF32 bound {row['bound_3xtf32_ms']:.4f} ms"
                        if "bound_3xtf32_ms" in row else "")
                print(f"[time] {name} [{n},{h},{w},{c}] {dt} ({K1_KERNEL[dt]}): kernel "
                      f"{row['kernel_ms']:.4f} ms "
                      f"(device {fmt_ms(row['kernel_device_ms'])}), plain "
                      f"{row['plain_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
                      f"({row['bound_by']}){tf32}")
    forward = []
    for dt, dtype in DTYPES.items():
        fn = serving.build_infer_fn(model, len(NUM_CLASSES) - 1, output="labels",
                                    compute_dtype=dtype)
        for n in BATCHES:
            x = imgs[n].to(dev)
            ms = time_ms(lambda: fn(x), iters=10, warmup=2)
            sums = k1_sums(blocks, dt, n)
            forward.append({"dtype": dt, "batch": n, "forward_ms": ms, "img_per_s": n * 1e3 / ms,
                            "nb1d_kernel_ms": sums["ms"], "nb1d_plain_ms": sums["plain_ms"],
                            "nb1d_bound_ms": sums["bound_ms"]})
            tf32 = (f" ({sums['bound_3xtf32_ms']:.4f} ms 3xTF32)"
                    if "bound_3xtf32_ms" in sums else "")
            print(f"[time] forward {n}x{HEIGHT}x{WIDTH} {dt} (labels, head "
                  f"{len(NUM_CLASSES) - 1}): {ms:.3f} ms, {n * 1e3 / ms:.2f} img/s; 17 nb1d "
                  f"blocks: kernel {sums['ms']:.3f} ms (device {fmt_ms(sums['device_ms'])}), "
                  f"plain {sums['plain_ms']:.3f} ms, bound {sums['bound_ms']:.4f} ms{tf32}")
    return {"blocks": blocks, "forward": forward}


def k1_sums(blocks: list[dict], dt: str, n: int) -> dict:
    """K1 summed over the 17 nb1d blocks of one n x 512 x 1024 forward in
    type dt (phase 4's rows): kernel ms (CUDA events over back-to-back calls,
    which include the host's time between launches where it is the longer),
    device ms (torch.profiler; None if a trace missed it), plain and bound ms
    (fp32 also its 3xTF32 bound), and what bounds the sum."""
    rows = [r for r in blocks if r["dtype"] == dt and r["shape"][0] == n]
    keys = {"ms": "kernel_ms", "plain_ms": "plain_ms", "bound_ms": "bound_ms"}
    if dt == "f32":
        keys["bound_3xtf32_ms"] = "bound_3xtf32_ms"
    out = {k: sum(r["count"] * r[src] for r in rows) for k, src in keys.items()}
    out["device_ms"] = (None if any(r["kernel_device_ms"] is None for r in rows)
                        else sum(r["count"] * r["kernel_device_ms"] for r in rows))
    t_ops = sum(r["count"] * r["flops"] / PEAK_FLOPS[dt] for r in rows)
    t_bytes = sum(r["count"] * r["bytes"] / PEAK_BYTES for r in rows)
    out["bound_by"] = "operations" if t_ops >= t_bytes else "bytes"
    return out


def phase_profile(model, imgs, dev: torch.device, iters: int = 3) -> list[dict]:
    """Device busy share and device time by kernel over `iters` forwards
    (torch.profiler, CUDA activity), against the host clock of the same run."""
    from torch.profiler import ProfilerActivity, profile

    rows = []
    task = len(NUM_CLASSES) - 1
    for dt, dtype in DTYPES.items():
        fn = serving.build_infer_fn(model, task, output="labels", compute_dtype=dtype)
        for n in BATCHES:
            x = imgs[n].to(dev)
            fn(x)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                for _ in range(iters):
                    fn(x)
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1e3 / iters
            kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
            by_name: dict[str, float] = {}
            for e in kernels:
                by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3 / iters
            device_ms = sum(by_name.values())
            nb1d_ms = sum(v for k, v in by_name.items() if any(p in k for p in K1_KERNEL.values()))
            top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
            rows.append({"dtype": dt, "batch": n, "wall_ms": wall_ms, "device_ms": device_ms,
                         "nb1d_ms": nb1d_ms, "idle_share": 1.0 - device_ms / wall_ms,
                         "kernel_launches": len(kernels) // iters,
                         "top": [[k[:80], v] for k, v in top]})
            print(f"[profile] {n}x{HEIGHT}x{WIDTH} {dt}: host {wall_ms:.3f} ms/forward, device "
                  f"busy {device_ms:.3f} ms (nb1d {nb1d_ms:.3f}), idle share "
                  f"{1.0 - device_ms / wall_ms:.3f}, {len(kernels) // iters} kernels/forward")
            for k, v in top:
                print(f"[profile]    {v:8.4f} ms  {k[:100]}")
    return rows


def cl(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous(memory_format=torch.channels_last)


def pair_args(gen: torch.Generator, c: int, rap: bool, pre: bool, dev):
    """Random conv-pair operands drawn on the CPU: w31, b31, w13, rap, pre."""
    def mk(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).to(dev)

    s = 1.0 / np.sqrt(3 * c)  # torch's default conv init scale
    pre_ab = ((1.0 + mk(c, scale=0.2)).abs(), mk(c, scale=0.2)) if pre else None
    return (mk(c, c, 3, 1, scale=s), mk(c, scale=s), mk(c, c, 1, 3, scale=s),
            mk(c, c, scale=1.0 / np.sqrt(c)) if rap else None, pre_ab)


def as_f64(t):
    if t is None:
        return None
    if isinstance(t, tuple):
        return tuple(x.double() for x in t)
    return t.double()


def pair_bwd_f64(x, gy, w31, b31, w13, rap, pre, d: int) -> dict:
    """float64 gradients of the pair (as bwd_pair returns them) for three masks
    of the relu on c: z > 0 ("mid", the exact gradient), z > tau ("lo") and
    z > -tau ("hi"), where z = rowconv(u) + b31 and tau bounds the rounding of
    z in any float32 summation order: gamma_{3C+2} * (|w31| conv |u| + |b31|).
    An element with |z| <= tau may take either side of the kink in float32, so
    dw31 and db31 of a correct float32 kernel lie within the band between "lo"
    and "hi", and du equals "mid" at every pixel no such element reaches
    ("du_clear"); dw13 and drap do not depend on the mask."""
    import torch.nn.functional as F

    x, gy, w31, b31, w13 = (t.double() for t in (x, gy, w31, b31, w13))
    rap, pre = as_f64(rap), as_f64(pre)
    c = x.shape[1]
    u = x if pre is None else F.relu(x * pre[0].view(1, -1, 1, 1) + pre[1].view(1, -1, 1, 1))
    u = u.detach().requires_grad_()
    w31v, b31v = w31.detach().requires_grad_(), b31.detach().requires_grad_()
    conv = dict(padding=(d, 0), dilation=(d, 1))
    z = F.conv2d(u, w31v, b31v, **conv)
    n_terms, eps = 3 * c + 2, 2.0 ** -24
    tau = n_terms * eps / (1 - n_terms * eps) * (
        F.conv2d(u.detach().abs(), w31.abs(), b31.abs(), **conv))
    cv = F.relu(z.detach()).requires_grad_()
    w13v = w13.detach().requires_grad_()
    y = F.conv2d(cv, w13v, padding=(0, d), dilation=(1, d))
    gc, dw13 = torch.autograd.grad(y, [cv, w13v], gy)
    amb = z.detach().abs() <= tau
    # du at row r reads dc at rows r-d, r, r+d: the pixels an ambiguous element can reach
    reach = amb.any(1, keepdim=True)
    near = reach.clone()
    if d < reach.shape[2]:
        near[:, :, :-d] |= reach[:, :, d:]
        near[:, :, d:] |= reach[:, :, :-d]
    out = {"ambiguous": int(amb.sum()), "du_clear": ~near, "dw13": dw13}
    if rap is not None:
        out["drap"] = torch.einsum("nchw,nkhw->ck", u.detach(), gy)
    for name, mask in (("mid", z > 0), ("lo", z > tau), ("hi", z > -tau)):
        du, dw31, db31 = torch.autograd.grad(z, [u, w31v, b31v], gc * mask, retain_graph=True)
        if rap is not None:
            du = du + torch.einsum("nkhw,ck->nchw", gy, rap)
        out[name] = {"du": du, "dw31": dw31, "db31": db31}
    return out


def phase_train_kernels(seed: int, dev: torch.device) -> list[dict]:
    """K2/K3 against float64. y, stats, dw13 and drap against the plain
    version run in float64 on the same inputs; du, dw31 and db31, which go
    through the relu mask on c, against the float64 gradient: du at every pixel
    that no element within float32 rounding of the kink reaches, dw31 and db31
    within the band those elements span (`pair_bwd_f64`); a relu that flips
    between float32 and float64 moves a weight gradient by ~4e-4 relative L2
    at these sizes. The float32 plain versions (cuDNN, TF32 off) are recorded
    beside them."""
    cases = []
    for i, spec in enumerate(BLOCKS + (RAGGED,)):
        name, c, d, _, h, w, _ = spec
        for rap in (False, True):
            for pre in (False, True):
                gen = torch.Generator().manual_seed(seed + 100 * i + 2 * rap + pre)
                w31, b31, w13, rapw, pre_ab = pair_args(gen, c, rap, pre, dev)
                x = cl(torch.randn(TRAIN_BATCH, c, h, w, generator=gen).to(dev))
                gy = cl(torch.randn(TRAIN_BATCH, c, h, w, generator=gen).to(dev))
                got = [*T.fwd_pair(x, w31, b31, w13, rapw, pre_ab, d),
                       *T.bwd_pair(x, gy, w31, b31, w13, rapw, pre_ab, d)]
                again = [*T.fwd_pair(x, w31, b31, w13, rapw, pre_ab, d),
                         *T.bwd_pair(x, gy, w31, b31, w13, rapw, pre_ab, d)]
                sync(dev)
                bitwise = all(torch.equal(a, b) for a, b in zip(got, again) if a is not None)
                del again
                names = ("y", "stats", "du", "dw31", "db31", "dw13", "drap")
                got = dict(zip(names, got))
                ref = pair_bwd_f64(x, gy, w31, b31, w13, rapw, pre_ab, d)
                want = dict(zip(("y", "stats"), T.fwd_pair_plain(
                    x.double(), *(as_f64(t) for t in (w31, b31, w13, rapw, pre_ab)), d)))
                want.update(ref["mid"], dw13=ref["dw13"], drap=ref.get("drap"))
                plain32 = dict(zip(names, [*T.fwd_pair_plain(x, w31, b31, w13, rapw, pre_ab, d),
                                           *T.bwd_pair_plain(x, gy, w31, b31, w13, rapw,
                                                             pre_ab, d)]))
                keys = [k for k in names if want[k] is not None]
                errs = {k: rel_l2(got[k], want[k]) for k in keys}
                du_all = errs["du"]  # du held only where no ambiguous relu reaches
                errs["du"] = rel_l2(got["du"] * ref["du_clear"], want["du"] * ref["du_clear"])
                abs_err = {k: float((got[k].double() - want[k]).abs().max()) for k in keys}
                plain_errs = {k: rel_l2(plain32[k], want[k]) for k in keys}
                band = {k: rel_l2(ref["hi"][k], ref["lo"][k]) for k in ("dw31", "db31")}
                tol = {k: TOL_TRAIN_REL_L2 + band.get(k, 0.0) for k in keys}
                ambiguous = ref["ambiguous"]
                del ref, want, plain32
                # K2's batch statistics against a float64 two-pass over its own y
                y64, count = got["y"].double(), TRAIN_BATCH * h * w
                m64 = y64.mean((0, 2, 3))
                v64 = (y64 - m64.view(1, -1, 1, 1)).square().mean((0, 2, 3))
                mu = got["stats"][0].double() / count
                var = torch.clamp(got["stats"][1].double() / count - mu * mu, min=0.0)
                mean_err = float((mu - m64).norm() / v64.sqrt().norm())  # in units of the std
                var_err = float((var - v64).norm() / v64.norm())
                case = {"block": name, "shape": [TRAIN_BATCH, h, w, c], "dilation": d, "rap": rap,
                        "pre": pre, "rel_l2": errs, "max_abs_err": abs_err, "tolerance": tol,
                        "relu_band": band, "ambiguous": ambiguous, "du_all_pixels": du_all,
                        "plain_f32_rel_l2": plain_errs, "bitwise": bitwise,
                        "mean_err_f64": mean_err, "var_err_f64": var_err,
                        "finite": all(bool(torch.isfinite(t).all()) for t in got.values()
                                      if t is not None)}
                case["ok"] = (case["finite"] and bitwise and all(errs[k] <= tol[k] for k in keys)
                              and mean_err <= TOL_STATS_F64 and var_err <= TOL_STATS_F64)
                cases.append(case)
                worst = max(errs, key=errs.get)
                print(f"[train-kernel] {name} [{TRAIN_BATCH},{h},{w},{c}] d={d} rap={int(rap)} "
                      f"pre={int(pre)}: worst rel_l2 vs f64 {errs[worst]:.2e} ({worst}, tolerance "
                      f"{tol[worst]:.2e}; plain f32 {max(plain_errs.values()):.2e}), relu band "
                      f"{max(band.values()):.1e} over {ambiguous} elements, stats "
                      f"mean {mean_err:.1e} var {var_err:.1e}, bitwise repeat {bitwise}")
                del got
    bad = [c for c in cases if not c["ok"]]
    check(not bad, f"K2/K3 above rel_l2 {TOL_TRAIN_REL_L2} (+ the relu band) vs float64, stats "
                   f"above {TOL_STATS_F64} vs a float64 two-pass, or not bitwise repeatable: {bad}")
    return cases


def phase_train_block(seed: int, dev: torch.device) -> list[dict]:
    """The training block (float32, kernels) against the same block built from
    the plain pairs and run in float64."""
    rows = []
    for i, spec in enumerate(BLOCKS):
        name, c, d, rap, h, w, _ = spec
        torch.manual_seed(seed + 10 * i)
        drop = (0.3 if c == 128 else 0.03) if rap else 0.0
        blk = NonBottleneck1dRAP(c, d, 2, drop) if rap else NonBottleneck1d(c, d)
        randomize_bn(blk, torch.Generator().manual_seed(seed + 10 * i + 1))
        twin = copy.deepcopy(blk).double()
        gen = torch.Generator().manual_seed(seed + 10 * i + 2)
        x = cl(torch.randn(TRAIN_BATCH, c, h, w, generator=gen).to(dev))
        cot = torch.randn(TRAIN_BATCH, c, h, w, generator=gen).to(dev)
        mask = (torch.rand(TRAIN_BATCH, c, generator=gen) < 1 - drop).to(dev) if rap else None
        res = []
        for b, pairs, dt in ((blk, T.KERNEL_PAIRS, torch.float32),
                             (twin, T.PLAIN_PAIRS, torch.float64)):
            b.to(dev).train()
            xi = x.to(dt).requires_grad_()
            out = T.nb1d_train_apply(b, xi, 1 if rap else None, drop, mask, pairs)
            grads = torch.autograd.grad((out * cot.to(dt)).sum(), [xi] + list(b.parameters()),
                                        allow_unused=True)
            res.append((out, grads, [t.clone() for n, t in b.named_buffers() if "running" in n]))
        sync(dev)
        (out_k, g_k, r_k), (out_p, g_p, r_p) = res
        g_err = max(rel_l2(a, b) for a, b in zip(g_k, g_p) if b is not None and b.norm() > 0)
        r_err = max(rel_l2(a, b) for a, b in zip(r_k, r_p) if b.norm() > 0)
        row = {"block": name, "shape": [TRAIN_BATCH, h, w, c], "out": rel_l2(out_k, out_p),
               "grads": g_err, "running": r_err,
               "none_match": all((a is None) == (b is None) for a, b in zip(g_k, g_p))}
        rows.append(row)
        print(f"[train-block] {name} [{TRAIN_BATCH},{h},{w},{c}] vs float64 plain pairs: out "
              f"{row['out']:.2e}, worst grad {g_err:.2e}, running stats {r_err:.2e}")
        del res, out_k, out_p, g_k, g_p
    bad = [r for r in rows if not (r["none_match"] and all(r[k] <= TOL_BLOCK[k] for k in TOL_BLOCK))]
    check(not bad, f"training block vs the float64 plain pairs above {TOL_BLOCK}: {bad}")
    return rows


def train_setup(seed: int, dev, n: int, h: int, w: int):
    """Student [20, 20] and eval-mode teacher [20] with random weights and BN
    from `seed`, a batch of random images and labels, and the host dropout
    masks of the two student forwards."""
    torch.manual_seed(seed)
    student = ERFNetRAP(STUDENT_CLASSES, len(STUDENT_CLASSES), device=dev)
    teacher = ERFNetRAP(TEACHER_CLASSES, len(TEACHER_CLASSES), device=dev)
    randomize_bn(student, torch.Generator().manual_seed(seed + 1))
    randomize_bn(teacher, torch.Generator().manual_seed(seed + 2))
    rng = np.random.default_rng(seed)
    images = torch.from_numpy(rng.random((n, h, w, 3), dtype=np.float32))
    labels = torch.from_numpy(rng.integers(0, STUDENT_CLASSES[CURRENT_TASK], (n, h, w)))
    masks = [make_dropout_masks(rng, n) for _ in range(1 + len(PREV_TASKS))]
    return student, teacher, images, labels, masks


def make_step(student):
    lr = rap_lr_tree(student, current_task=CURRENT_TASK, shared_lr=SHARED_LR, ds_lr=DS_LR)
    step = steps.make_distill_step(current_task=CURRENT_TASK, prev_tasks=PREV_TASKS,
                                   class_weight=CLASS_WEIGHTS["BDD"], lr_tree=lr,
                                   num_epochs=NUM_EPOCHS, lambda_c=LAMBDA_C)
    return lr, step


def launch_counts() -> dict:
    return {"K1": K.LAUNCHES, "K2": T.LAUNCHES_FWD, "K3": T.LAUNCHES_BWD}


def zero_launch_counts() -> None:
    K.LAUNCHES = T.LAUNCHES_FWD = T.LAUNCHES_BWD = 0


def phase_train_step(seed: int, dev: torch.device):
    student, teacher, images, labels, masks = train_setup(seed, dev, TRAIN_BATCH, HEIGHT, WIDTH)
    images, labels = images.to(dev), labels.to(dev)
    lr, step = make_step(student)
    frozen = {k: p.detach().clone() for k, p in student.named_parameters() if lr[k] == 0.0}
    check(frozen and all((".0." in k and ("parallel_conv" in k or "bns_" in k or "bn_ini" in k))
                         or k.startswith("decoder.0.") for k in frozen),
          "the LR dict freezes other parameters than the old task's slices and head")
    ts = steps.init_train_state(student)
    sync(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    record = {"steps": []}
    zero_launch_counts()
    for i in range(TRAIN_STEPS):
        before = launch_counts()
        t0 = time.perf_counter()
        ts, metrics = step(ts, teacher, images, labels, masks, 1)
        vals = {k: float(v) for k, v in metrics.items()}  # waits for the step
        secs = time.perf_counter() - t0
        launched = {k: v - before[k] for k, v in launch_counts().items()}
        record["steps"].append({**vals, "launches": launched, "seconds": secs})
        print(f"[train] step {i + 1}: loss {vals['loss']:.6f} ce {vals['ce']:.6f} "
              f"kld {vals['kld']:.6f}; launches {launched}; {secs:.3f} s")
        check(all(np.isfinite(v) for v in vals.values()), f"non-finite losses {vals}")
        check(launched == STEP_LAUNCHES, f"step launched {launched}, expected {STEP_LAUNCHES}")
    record["launches"] = launch_counts()
    check(all(v > 0 for v in record["launches"].values()), "a kernel of the train path never ran")
    record["peak_memory_bytes"] = torch.cuda.max_memory_allocated(dev)
    params = dict(student.named_parameters())
    moved = [k for k, p in frozen.items() if not torch.equal(params[k], p)]
    check(not moved, f"frozen parameters moved: {moved[:5]}")
    moving = [k for k in params if k not in frozen]
    record["frozen_params"], record["trained_params"] = len(frozen), len(moving)
    print(f"[train] CE over {TRAIN_STEPS} steps: "
          f"{[round(r['ce'], 6) for r in record['steps']]}; {len(frozen)} frozen parameters "
          f"bitwise unchanged; peak memory {record['peak_memory_bytes'] / 2**30:.2f} GiB; "
          f"launches {record['launches']}")
    return (student, teacher, images, labels, masks, step, ts), record


def flat_grads(model, grads: dict) -> torch.Tensor:
    return torch.cat([(torch.zeros_like(p) if grads[k] is None else grads[k]).reshape(-1).cpu()
                      for k, p in model.named_parameters()])


def phase_train_vs_cpu(seed: int, dev: torch.device) -> dict:
    n, h, w = SMALL
    student, teacher, images, labels, masks = train_setup(seed + 3, dev, n, h, w)
    cpu_state = {k: v.detach().cpu().clone() for k, v in student.state_dict().items()}
    teacher_state = {k: v.detach().cpu().clone() for k, v in teacher.state_dict().items()}
    weight = torch.from_numpy(CLASS_WEIGHTS["BDD"])
    kw = dict(current_task=CURRENT_TASK, prev_tasks=PREV_TASKS, class_weight=weight,
              lambda_c=LAMBDA_C)

    def cpu_run(x):
        s = ERFNetRAP(STUDENT_CLASSES, len(STUDENT_CLASSES), device="cpu")
        s.load_state_dict(cpu_state)
        t = ERFNetRAP(TEACHER_CLASSES, len(TEACHER_CLASSES), device="cpu")
        t.load_state_dict(teacher_state)
        out = steps.distill_loss_and_grads(s, t, x, labels, masks, **kw)
        return s, out

    out_g = steps.distill_loss_and_grads(student, teacher, images.to(dev), labels.to(dev), masks,
                                         **kw)
    sync(dev)
    s_cpu, out_c = cpu_run(images)
    gen = torch.Generator().manual_seed(seed + 4)
    s_spread, out_s = cpu_run(images * (1 + 1e-7 * torch.randn(images.shape, generator=gen)))
    g_g, g_c, g_s = flat_grads(student, out_g[3]), flat_grads(s_cpu, out_c[3]), flat_grads(
        s_spread, out_s[3])
    head = [k for k, _ in student.named_parameters()
            if k.startswith(f"decoder.{CURRENT_TASK}.output_conv")]
    run_g = torch.cat([b.reshape(-1).cpu() for k, b in student.named_buffers() if "running" in k])
    run_c = torch.cat([b.reshape(-1) for k, b in s_cpu.named_buffers() if "running" in k])
    rec = {"shape": list(SMALL),
           "loss": abs(float(out_g[0]) - float(out_c[0])) / abs(float(out_c[0])),
           "running": rel_l2(run_g, run_c),
           "head_grads": rel_l2(torch.cat([out_g[3][k].reshape(-1).cpu() for k in head]),
                                torch.cat([out_c[3][k].reshape(-1) for k in head])),
           "grads": rel_l2(g_g, g_c), "cpu_spread_1e-7": rel_l2(g_s, g_c),
           "loss_card": float(out_g[0]), "loss_cpu": float(out_c[0])}
    print(f"[train-cpu] {n}x{h}x{w} step, card vs CPU: loss {rec['loss']:.2e}, running stats "
          f"{rec['running']:.2e}, head grads {rec['head_grads']:.2e}, all grads {rec['grads']:.2e} "
          f"(the CPU against itself under 1e-7 input noise: {rec['cpu_spread_1e-7']:.2e})")
    check(rec["loss"] <= TOL_STEP["loss"] and rec["running"] <= TOL_STEP["running"]
          and rec["head_grads"] <= TOL_STEP["head_grads"]
          and rec["grads"] <= TOL_STEP["grads_vs_spread"] * max(rec["cpu_spread_1e-7"], 1e-5),
          f"train step card vs CPU above {TOL_STEP}: {rec}")
    return rec


def pair_bound(n: int, c: int, h: int, w: int, rap: bool, kind: str) -> dict:
    """Least time of one K2 ("fwd") or K3 ("bwd") call in float32: FLOPs at the
    CUDA cores' fp32 rate against bytes read and written once. K2: 6C^2 MACs
    per pixel (+C^2 RAP), reads x, writes y. K3: recompute c, dc, du, dw31,
    dw13 (5 x 3C^2 MACs, +2C^2 RAP), reads u and gy, writes du and the weight
    gradients. `bound_3xtf32_ms`: the same FLOPs done as 3xTF32 on the tensor
    cores (3 TF32 products each at 495 TFLOP/s) against the same bytes."""
    px = n * h * w
    macs = (6 + rap if kind == "fwd" else 15 + 2 * rap) * c * c
    acts = 2 if kind == "fwd" else 3
    weights = (6 + rap) * c * c * (1 if kind == "fwd" else 2)
    flops = 2 * px * macs
    nbytes = 4 * (acts * px * c + weights + 4 * c)
    t_ops, t_bytes = flops / PEAK_FLOPS["f32"], nbytes / PEAK_BYTES
    t_tc = 3 * flops / PEAK_FLOPS["tf32"]
    return {"flops": flops, "bytes": nbytes, "bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "bound_3xtf32_ms": max(t_tc, t_bytes) * 1e3}


# K2's and K3's launches by kernel name: K2's pair and the fixed-order sum of its partial stats;
# K3's c and dc, du, the weight-gradient partials, their fixed-order sum
K2_KINDS = {"pair": "fwd_pair_mma_kernel", "sum": "namespace)::reduce_kernel("}
K3_KINDS = {"dc": "bwd_dc_kernel", "du": "bwd_du_kernel", "wgrad": "bwd_wgrad_kernel",
            "sum": "namespace)::reduce_kernel("}
PAIR_KINDS = {"fwd": K2_KINDS, "bwd": K3_KINDS}


def device_ms_by_kind(fn, kinds: dict, iters: int = 3, tries: int = 3) -> dict:
    """Device ms per call of `fn` for each kind of kernel (name pattern),
    from torch.profiler over `iters` calls after one warm-up call. A trace
    that misses a kind (the profiler's CUDA activity buffer can come back
    empty) is taken again, up to `tries` times; a kind never seen is None
    (not measured)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    out = {}
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        out = dict.fromkeys(kinds, 0.0)
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                for k, pat in kinds.items():
                    if pat in e.name:
                        out[k] += e.time_range.elapsed_us() / 1e3 / iters
        if all(v > 0 for v in out.values()):
            return out
    return {k: (v if v > 0 else None) for k, v in out.items()}


def fmt_ms(v) -> str:
    return "not measured" if v is None else f"{v:.4f}"


def add_ms(a, b):
    """a + b for times that may be None (not measured)."""
    return None if a is None or b is None else a + b


def wgrad_library_ms(x: torch.Tensor, gy: torch.Tensor, rap: bool, tf32: bool) -> float:
    """ms of the weight-gradient products of one K3 call as torch.matmul
    calls: [pixels x C]^T [pixels x C], 7 with RAP (dw31 x3, dw13 x3, drap),
    else 6, at float32 with TF32 off (or on, as information). A yardstick
    only: the port never calls it."""
    c = x.shape[1]
    a, b = x.permute(0, 2, 3, 1).reshape(-1, c), gy.permute(0, 2, 3, 1).reshape(-1, c)
    n_mat = 7 if rap else 6
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        return time_ms(lambda: [torch.matmul(a.t(), b) for _ in range(n_mat)], iters=10, warmup=2)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def profile_once(fn, tag: str, what: str) -> dict:
    """One call of `fn` under torch.profiler (CUDA activity), printed under
    `tag`: host ms, device busy ms, idle share, kernels launched, device ms of
    K1 / K2 / K3 / their partial sums, K3 by launch kind, the top 10 kernels."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name: dict[str, float] = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    busy = sum(by_name.values())
    groups = {"K1": tuple(K1_KERNEL.values()), "K2": (K2_KINDS["pair"],),
              "K3": ("bwd_dc_kernel", "bwd_du_kernel", "bwd_wgrad_kernel"),
              "K2/K3 partial sums": ("namespace)::reduce_kernel(",)}
    shares = {g: sum(v for k, v in by_name.items() if any(p in k for p in pats))
              for g, pats in groups.items()}
    k3_kinds = {kind: sum(v for k, v in by_name.items() if pat in k)
                for kind, pat in K3_KINDS.items() if kind != "sum"}
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    print(f"[{tag}] {what}: host {wall_ms:.3f} ms, device busy {busy:.3f} ms, idle "
          f"share {1.0 - busy / wall_ms:.3f}, {len(kernels)} kernels; "
          + ", ".join(f"{g} {v:.3f} ms" for g, v in shares.items())
          + "; K3 " + ", ".join(f"{k} {v:.3f} ms" for k, v in k3_kinds.items()))
    for k, v in top:
        print(f"[{tag}]    {v:8.4f} ms  {k[:100]}")
    return {"wall_ms": wall_ms, "device_ms": busy, "idle_share": 1.0 - busy / wall_ms,
            "kernels_per_step": len(kernels), "ms_by_group": shares,
            "k3_ms_by_kind": k3_kinds, "top": [[k[:90], v] for k, v in top]}


def family_split(fn, tag: str, what: str) -> dict:
    """The device time of one call of `fn` outside K1/K2/K3 by family
    (`ms_by_family`), from the chrome trace of a profiled call with Python
    stacks; printed under `tag`."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], with_stack=True) as prof:
        fn()
        torch.cuda.synchronize()
    trace = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "step_trace.json")
    os.makedirs(os.path.dirname(trace), exist_ok=True)
    prof.export_chrome_trace(trace)
    with open(trace) as f:
        fam, fam_top, counts = ms_by_family(json.load(f)["traceEvents"])
    os.remove(trace)
    print(f"[{tag}] outside K1/K2/K3, device ms per {what} by family (a second profiled "
          f"{what}, with Python stacks; {counts['device_events']} device events, launch found for "
          f"{counts['launch_found']}, {counts['placed_by_name']} placed by the names around it): "
          + ", ".join(f"{k} {v:.3f}" for k, v in fam.items()))
    for k, rows in fam_top.items():
        for name, v in rows:
            print(f"[{tag}]    {k}: {v:8.4f} ms  {name[:90]}")
    return {"ms_by_family": fam, "family_top": fam_top, "family_counts": counts}


def phase_train_times(seed: int, dev: torch.device, run) -> dict:
    student, teacher, images, labels, masks, step, ts = run
    n = images.shape[0]
    state = {"ts": ts}

    def one_step():
        state["ts"], _ = step(state["ts"], teacher, images, labels, masks, 1)

    ms = time_ms(one_step, iters=3, warmup=1)
    out = {"step_ms": ms, "img_per_s": n * 1e3 / ms}
    print(f"[train-time] step {n}x{HEIGHT}x{WIDTH} f32: {ms:.3f} ms/step, "
          f"{n * 1e3 / ms:.2f} img/s")

    out["profile"] = profile_once(one_step, "train-profile", "one step")
    out["profile"].update(family_split(one_step, "train-profile", "step"))

    blocks = []
    for i, spec in enumerate(BLOCKS):
        name, c, d, rap, h, w, count = spec
        gen = torch.Generator().manual_seed(seed + 100 * i)
        x = cl(torch.randn(n, c, h, w, generator=gen).to(dev))
        gy = cl(torch.randn(n, c, h, w, generator=gen).to(dev))
        row = {"block": name, "count": count, "shape": [n, h, w, c]}
        # the block's two pairs: (dilation 1, no pre-stage) and (d, pre-stage)
        for pair, (dd, pre) in enumerate(((1, False), (d, True))):
            w31, b31, w13, rapw, pre_ab = pair_args(gen, c, rap, pre, dev)
            args = (w31, b31, w13, rapw, pre_ab, dd)
            for kind, kern, plain in (("fwd", T.fwd_pair, T.fwd_pair_plain),
                                      ("bwd", T.bwd_pair, T.bwd_pair_plain)):
                call = (lambda f: (lambda: f(x, *args))) if kind == "fwd" else (
                    lambda f: (lambda: f(x, gy, *args)))
                b = pair_bound(n, c, h, w, rap, kind)
                vals = [("ms", time_ms(call(kern), iters=10, warmup=2)),
                        ("plain_ms", time_ms(call(plain), iters=5, warmup=1)),
                        ("bound_ms", b["bound_ms"]), ("bound_3xtf32_ms", b["bound_3xtf32_ms"])]
                if kind == "bwd":
                    vals += [("wgrad_library_ms", wgrad_library_ms(x, gy, rap, False)),
                             ("wgrad_library_tf32_ms", wgrad_library_ms(x, gy, rap, True))]
                vals += [(f"{k}_ms", v) for k, v in
                         device_ms_by_kind(call(kern), PAIR_KINDS[kind]).items()]
                for key, val in vals:
                    row[f"{kind}_{key}"] = add_ms(row.get(f"{kind}_{key}", 0.0), val)
                row[f"{kind}_bound_by"] = b["bound_by"]
                row[f"{kind}_flops"] = row.get(f"{kind}_flops", 0) + b["flops"]
                row[f"{kind}_bytes"] = row.get(f"{kind}_bytes", 0) + b["bytes"]
        blocks.append(row)
        print(f"[train-time] {name} [{n},{h},{w},{c}] two pairs: K2 {row['fwd_ms']:.4f} ms "
              f"(plain {row['fwd_plain_ms']:.4f}, bound {row['fwd_bound_ms']:.4f} fp32 / "
              f"{row['fwd_bound_3xtf32_ms']:.4f} 3xTF32; device "
              + ", ".join(f"{k} {fmt_ms(row[f'fwd_{k}_ms'])}" for k in K2_KINDS)
              + f"), K3 {row['bwd_ms']:.4f} ms (plain {row['bwd_plain_ms']:.4f}, bound "
              f"{row['bwd_bound_ms']:.4f} fp32 / {row['bwd_bound_3xtf32_ms']:.4f} 3xTF32; device "
              + ", ".join(f"{k} {fmt_ms(row[f'bwd_{k}_ms'])}" for k in K3_KINDS)
              + f"; weight-gradient matmuls {row['bwd_wgrad_library_ms']:.4f} fp32, "
              f"{row['bwd_wgrad_library_tf32_ms']:.4f} TF32)")
    out["blocks"] = blocks
    return out


# R0: the step's device time outside K1/K2/K3 by family, from the chrome trace of one profiled
# step (profile(with_stack=True)). Each device kernel, copy or fill is found where the host
# launched it: its runtime call (cudaLaunchKernel, ...; the trace's "correlation" argument), else
# the torch op of the same "External id". The torch ops and Python frames around that point on
# the launching thread name it; for an op of the backward (autograd::engine::evaluate_function,
# with a sequence number) so do those around the forward op that made its autograd node. It goes
# to the first family one of whose patterns is in one of those names; what no launch or name
# places goes by its own name (FAMILY_BY_KERNEL_NAME), else to "unattributed".
OWN_KERNELS = ("nb1d_pair_", "fwd_pair_mma_kernel", "bwd_dc_kernel", "bwd_du_kernel",
               "bwd_wgrad_kernel", "namespace)::reduce_kernel(")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
FAMILIES = (
    ("cuDNN conv and its backward", ("convolution", "cudnn")),
    ("Adam", ("train/optim.py",)),
    ("losses over the logits", ("losses.py",)),
    ("K1 operands (teacher's BN fold, weight stacks)", ("ops/nb1d_infer.py",)),
    ("BN and dropout glue, K2/K3 operands", ("ops/nb1d_train.py", "ops/norm.py",
                                              "ops/dropout.py")),
    ("model glue (layout, pooling, concat)", ("mdilss_tpu_torch/models/",)),
    ("gradient accumulation", ("AccumulateGrad",)),
    ("confusion matrix (iou_train)", ("metrics.py", "_train_cm")),
    ("the teacher's buffers saved and restored", ("_teacher_mode",)),
    ("other", ("mdilss_tpu_torch/",)),
)
FAMILY_BY_KERNEL_NAME = (("cuDNN conv and its backward", ("conv", "cudnn", "xmma", "implicit",
                                                          "dgrad", "wgrad", "fprop")),)


def family_of(names) -> str:
    for fam, pats in FAMILIES:
        if any(p in n for n in names for p in pats):
            return fam
    return "unattributed"


def _end(e: dict) -> float:
    return e["ts"] + e.get("dur", 0.0)


def ms_by_family(events: list[dict], top: int = 3) -> tuple[dict, dict, dict]:
    """(device ms by family, the `top` kernels of each family, counts) of the
    device work outside K1/K2/K3 in a chrome trace's `traceEvents` (see
    FAMILIES); counts: device events, those whose launch was found, those
    placed by a name around it."""
    device, launch, spans = [], {}, {}
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, args = e.get("cat", ""), e.get("args") or {}
        if cat in DEVICE_CATS:
            if not any(p in e["name"] for p in OWN_KERNELS):
                device.append(e)
        elif cat in ("cuda_runtime", "cuda_driver"):
            if "correlation" in args:
                launch[args["correlation"]] = (e["tid"], e["ts"])
        elif cat in ("cpu_op", "python_function", "user_annotation"):
            spans.setdefault(e["tid"], []).append(e)
    op_by_ext, fwd_by_seq = {}, {}
    for ss in spans.values():
        ss.sort(key=lambda e: (e["ts"], -e.get("dur", 0.0)))  # outer before inner
        for e in ss:
            if e["cat"] != "cpu_op":
                continue
            args = e.get("args") or {}
            op_by_ext.setdefault(args.get("External id"), e)
            seq = args.get("Sequence number", -1)
            if (seq >= 0 and not e["name"].startswith("autograd::engine")
                    and (seq not in fwd_by_seq or e["ts"] < fwd_by_seq[seq]["ts"])):
                fwd_by_seq[seq] = e

    def around(points):
        """key -> the spans around each (tid, ts, key), outermost first"""
        out, by_tid = {}, {}
        for tid, ts, key in points:
            by_tid.setdefault(tid, []).append((ts, key))
        for tid, pts in by_tid.items():
            ss, stack, i = spans.get(tid, []), [], 0
            for ts, key in sorted(pts, key=lambda p: p[0]):
                while i < len(ss) and ss[i]["ts"] <= ts:
                    while stack and _end(stack[-1]) < ss[i]["ts"]:
                        stack.pop()
                    stack.append(ss[i])
                    i += 1
                out[key] = [e for e in stack if _end(e) >= ts]
        return out

    points = []
    for k, e in enumerate(device):
        args = e.get("args") or {}
        at = launch.get(args.get("correlation"))
        op = op_by_ext.get(args.get("External id")) if at is None else None
        if op is not None:
            at = (op["tid"], op["ts"])
        if at is not None:
            points.append((*at, k))
    chains = around(points)
    fwd_points = []
    for k, chain in chains.items():
        for e in chain:
            seq = (e.get("args") or {}).get("Sequence number", -1)
            if e["name"].startswith("autograd::engine::evaluate_function") and seq in fwd_by_seq:
                f = fwd_by_seq[seq]
                fwd_points.append((f["tid"], f["ts"], k))
                break
    fwd_chains = around(fwd_points)

    names_ms: dict[str, dict[str, float]] = {}
    placed = 0
    for k, e in enumerate(device):
        names = [s["name"] for s in chains.get(k, []) + fwd_chains.get(k, [])]
        fam = family_of(names)
        if fam == "unattributed":
            fam = next((f for f, pats in FAMILY_BY_KERNEL_NAME
                        if any(p in e["name"].lower() for p in pats)), fam)
        else:
            placed += 1
        d = names_ms.setdefault(fam, {})
        d[e["name"]] = d.get(e["name"], 0.0) + e.get("dur", 0.0) / 1e3
    order = [f for f, _ in FAMILIES] + ["unattributed"]
    ms = {f: sum(names_ms[f].values()) for f in order if f in names_ms}
    fam_top = {f: [[k[:90], v] for k, v in sorted(names_ms[f].items(), key=lambda kv: -kv[1])[:top]]
               for f in ms}
    counts = {"device_events": len(device), "launch_found": len(points), "placed_by_name": placed}
    return ms, fam_top, counts


def state_copy(module: torch.nn.Module) -> dict:
    """Every parameter and buffer of `module`, cloned."""
    return {k: v.detach().clone() for k, v in module.state_dict().items()}


def changed(module: torch.nn.Module, before: dict) -> list[str]:
    """Names of the parameters and buffers of `module` not bitwise as in `before`."""
    return [k for k, v in module.state_dict().items() if not torch.equal(v, before[k])]


def step3_setup(seed: int, dev, n: int, h: int, w: int):
    """Student [20, 20, 27] and teacher [20, 20] with random weights and BN
    from `seed`, a batch of random images and IDD labels, and the host dropout
    masks of the three student forwards."""
    torch.manual_seed(seed)
    student = ERFNetRAP(STEP3_STUDENT, len(STEP3_STUDENT), device=dev)
    teacher = ERFNetRAP(STEP3_TEACHER, len(STEP3_TEACHER), device=dev)
    randomize_bn(student, torch.Generator().manual_seed(seed + 1))
    randomize_bn(teacher, torch.Generator().manual_seed(seed + 2))
    rng = np.random.default_rng(seed)
    images = torch.from_numpy(rng.random((n, h, w, 3), dtype=np.float32))
    labels = torch.from_numpy(rng.integers(0, STEP3_STUDENT[STEP3_CURRENT], (n, h, w)))
    masks = [make_dropout_masks(rng, n) for _ in range(1 + len(STEP3_PREV))]
    return student, teacher, images, labels, masks


def make_step3(student):
    lr = rap_lr_tree(student, current_task=STEP3_CURRENT, shared_lr=SHARED_LR, ds_lr=DS_LR)
    step = steps.make_two_phase_distill_step(
        current_task=STEP3_CURRENT, prev_tasks=STEP3_PREV, class_weight=CLASS_WEIGHTS["IDD"],
        lr_tree=lr, num_epochs=NUM_EPOCHS, lambda_c=LAMBDA_C, iou_train=True)
    return lr, step


def phase_step3(seed: int, dev: torch.device):
    """Phase 10: STEP3_STEPS two-phase step-3 batches at 6x512x1024 with the
    train-mode teacher; every batch launches exactly STEP3_LAUNCHES, takes
    two Adam steps, counts every pixel in its cm, and leaves the frozen
    student parameters and every teacher parameter and buffer bitwise as
    they were."""
    student, teacher, images, labels, masks = step3_setup(seed, dev, TRAIN_BATCH, HEIGHT, WIDTH)
    images, labels = images.to(dev), labels.to(dev)
    lr, step = make_step3(student)
    frozen = {k: p.detach().clone() for k, p in student.named_parameters() if lr[k] == 0.0}
    old = "|".join(str(t) for t in STEP3_PREV)
    slice_or_head = re.compile(rf"\.(parallel_conv_[12]|bns_[12]|bn_ini)\.({old})\.|^decoder\.({old})\.")
    check(frozen and all(slice_or_head.search(k) for k in frozen),
          "the LR dict freezes other parameters than the old tasks' slices and heads")
    teacher_before = state_copy(teacher)
    ts = steps.init_train_state(student)
    sync(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    record = {"steps": []}
    pixels = TRAIN_BATCH * HEIGHT * WIDTH
    zero_launch_counts()
    for i in range(STEP3_STEPS):
        before, count = launch_counts(), ts.opt.count
        t0 = time.perf_counter()
        ts, metrics = step(ts, teacher, images, labels, masks, 1)
        cm = metrics.pop("cm")
        vals = {k: float(v) for k, v in metrics.items()}  # waits for the step
        counted = int(cm.sum())
        secs = time.perf_counter() - t0
        launched = {k: v - before[k] for k, v in launch_counts().items()}
        params = dict(student.named_parameters())
        moved = [k for k, p in frozen.items() if not torch.equal(params[k], p)]
        t_moved = changed(teacher, teacher_before)
        record["steps"].append({**vals, "launches": launched, "seconds": secs,
                                "adam_steps": ts.opt.count - count, "cm_pixels": counted})
        print(f"[step3] batch {i + 1}: loss {vals['loss']:.6f} ce {vals['ce']:.6f} kld "
              f"{vals['kld']:.6f}; launches {launched}; Adam steps {ts.opt.count - count}; cm "
              f"counts {counted} pixels; {secs:.3f} s")
        check(all(np.isfinite(v) for v in vals.values()), f"non-finite step-3 losses {vals}")
        check(launched == STEP3_LAUNCHES, f"step-3 batch launched {launched}, "
                                          f"expected {STEP3_LAUNCHES}")
        check(ts.opt.count == count + 2, "a step-3 batch took other than two Adam steps")
        check(counted == pixels, f"the cm counts {counted} pixels of {pixels}")
        check(not moved, f"frozen student parameters moved: {moved[:5]}")
        check(not t_moved, f"the teacher's parameters or buffers changed: {t_moved[:5]}")
    record["launches"] = launch_counts()
    check(record["launches"]["K2"] > 0 and record["launches"]["K3"] > 0,
          "a kernel of the step-3 path never ran")
    record["peak_memory_bytes"] = torch.cuda.max_memory_allocated(dev)
    record["frozen_params"] = len(frozen)
    print(f"[step3] CE over {STEP3_STEPS} batches: {[round(r['ce'], 6) for r in record['steps']]}; "
          f"{len(frozen)} frozen student parameters and all {len(teacher_before)} teacher "
          f"parameters and buffers bitwise unchanged; peak memory "
          f"{record['peak_memory_bytes'] / 2**30:.2f} GiB; launches {record['launches']}")
    return (student, teacher, images, labels, masks, step, ts), record


def phase_step3_times(run) -> dict:
    """ms per step-3 batch (CUDA events after warm-up) and one profiled batch."""
    student, teacher, images, labels, masks, step, ts = run
    n = images.shape[0]
    state = {"ts": ts}

    def one_batch():
        state["ts"], _ = step(state["ts"], teacher, images, labels, masks, 1)

    ms = time_ms(one_batch, iters=3, warmup=1)
    print(f"[step3-time] batch {n}x{HEIGHT}x{WIDTH} f32: {ms:.3f} ms/batch, "
          f"{n * 1e3 / ms:.2f} img/s")
    prof = profile_once(one_batch, "step3-profile", "one batch")
    prof.update(family_split(one_batch, "step3-profile", "batch"))
    return {"batch_ms": ms, "img_per_s": n * 1e3 / ms, "profile": prof}


def phase_other_steps(seed: int, dev: torch.device, run) -> dict:
    """Phase 11, at full width: the eval step on head 2 of the step-3 student
    (EVAL_LAUNCHES) and one CE step on a [20] model (CE_LAUNCHES), each with
    its counts zeroed just before it, then timed and profiled."""
    student, _, images, labels, _, _, _ = run
    n = images.shape[0]
    out = {}
    nc = STEP3_STUDENT[STEP3_CURRENT]
    ev = steps.make_eval_step(task=STEP3_CURRENT, class_weight=CLASS_WEIGHTS["IDD"],
                              num_classes=nc)
    zero_launch_counts()
    loss, cm = ev(student, images, labels)
    vals = {"loss": float(loss), "cm_pixels": int(cm.sum())}
    launched = launch_counts()
    print(f"[eval-step] head {STEP3_CURRENT} {n}x{HEIGHT}x{WIDTH}: loss {vals['loss']:.6f}, cm "
          f"counts {vals['cm_pixels']} pixels; launches {launched}")
    check(launched == EVAL_LAUNCHES, f"eval step launched {launched}, expected {EVAL_LAUNCHES}")
    check(np.isfinite(vals["loss"]) and vals["cm_pixels"] == labels.numel(),
          f"eval step gave {vals}")
    ms = time_ms(lambda: ev(student, images, labels), iters=5, warmup=1)
    print(f"[eval-step] {ms:.3f} ms/call, {n * 1e3 / ms:.2f} img/s")
    out["eval"] = {**vals, "launches": launched, "ms": ms,
                   "profile": profile_once(lambda: ev(student, images, labels), "eval-profile",
                                           "one call")}

    torch.manual_seed(seed + 6)
    model = ERFNetRAP(CE_CLASSES, len(CE_CLASSES), device=dev)
    randomize_bn(model, torch.Generator().manual_seed(seed + 7))
    rng = np.random.default_rng(seed + 6)
    ce_labels = torch.from_numpy(rng.integers(0, CE_CLASSES[0], labels.shape)).to(dev)
    mask = make_dropout_masks(rng, n)
    lr = rap_lr_tree(model, current_task=0, shared_lr=DS_LR, ds_lr=DS_LR)
    ce = steps.make_ce_step(task=0, class_weight=CLASS_WEIGHTS["cityscapes"], lr_tree=lr,
                            num_epochs=NUM_EPOCHS)
    state = {"ts": steps.init_train_state(model)}
    zero_launch_counts()
    state["ts"], metrics = ce(state["ts"], images, ce_labels, mask, 1)
    vals = {k: float(v) for k, v in metrics.items()}
    launched = launch_counts()
    print(f"[ce-step] [20] {n}x{HEIGHT}x{WIDTH}: loss {vals['loss']:.6f}; launches {launched}")
    check(launched == CE_LAUNCHES, f"CE step launched {launched}, expected {CE_LAUNCHES}")
    check(np.isfinite(vals["loss"]) and state["ts"].opt.count == 1, f"CE step gave {vals}")

    def one_ce():
        state["ts"], _ = ce(state["ts"], images, ce_labels, mask, 1)

    ms = time_ms(one_ce, iters=3, warmup=1)
    print(f"[ce-step] {ms:.3f} ms/step, {n * 1e3 / ms:.2f} img/s")
    out["ce"] = {**vals, "launches": launched, "ms": ms,
                 "profile": profile_once(one_ce, "ce-profile", "one step")}
    return out


def phase_step3_vs_cpu(seed: int, dev: torch.device) -> dict:
    """One step-3 batch at 2x128x256 on the card and on the CPU (plain
    versions) from the same weights, masks and batch; then the eval step on
    the card's updated student and its CPU copy, its cm compared on labels
    that leave out the pixels whose CPU top-2 logit gap is within 4x the RMS
    card - CPU logit difference (a label of C counts nowhere)."""
    n, h, w = SMALL
    student, teacher, images, labels, masks = step3_setup(seed + 8, dev, n, h, w)
    s_state, t_state = state_copy(student), state_copy(teacher)
    runs = {}
    for name, d in (("card", dev), ("cpu", torch.device("cpu"))):
        s = student if d == dev else ERFNetRAP(STEP3_STUDENT, len(STEP3_STUDENT), device=d)
        t = teacher if d == dev else ERFNetRAP(STEP3_TEACHER, len(STEP3_TEACHER), device=d)
        s.load_state_dict(s_state)
        t.load_state_dict(t_state)
        _, step = make_step3(s)
        ts, m = step(steps.init_train_state(s), t, images.to(d), labels.to(d), masks, 1)
        runs[name] = {"student": s, "metrics": {k: float(v) for k, v in m.items() if k != "cm"},
                      "teacher_changed": changed(t, {k: v.to(d) for k, v in t_state.items()}),
                      "adam_steps": ts.opt.count}
    card, cpu = runs["card"], runs["cpu"]

    def running(s):
        return torch.cat([b.reshape(-1).cpu() for k, b in s.named_buffers() if "running" in k])

    def params(s):
        return torch.cat([p.detach().reshape(-1).cpu() for p in s.parameters()])

    rec = {"shape": list(SMALL), "card": card["metrics"], "cpu": cpu["metrics"],
           **{k: abs(card["metrics"][k] - cpu["metrics"][k]) / abs(cpu["metrics"][k])
              for k in ("loss", "ce", "kld")},
           "running": rel_l2(running(card["student"]), running(cpu["student"])),
           "params": rel_l2(params(card["student"]), params(cpu["student"])),
           "teacher_changed": card["teacher_changed"] + cpu["teacher_changed"]}
    print(f"[step3-cpu] {n}x{h}x{w} batch, card vs CPU: loss {rec['loss']:.2e}, ce "
          f"{rec['ce']:.2e}, kld {rec['kld']:.2e}, running stats {rec['running']:.2e}; "
          f"parameters {rec['params']:.2e} (information: Adam's sign noise); teacher "
          f"unchanged on both: {not rec['teacher_changed']}")
    check(all(rec[k] <= TOL_STEP3 for k in ("loss", "ce", "kld", "running"))
          and not rec["teacher_changed"] and card["adam_steps"] == cpu["adam_steps"] == 2,
          f"step-3 batch card vs CPU above {TOL_STEP3}: {rec}")

    nc = STEP3_STUDENT[STEP3_CURRENT]
    ev = steps.make_eval_step(task=STEP3_CURRENT, class_weight=CLASS_WEIGHTS["IDD"],
                              num_classes=nc)
    s_cpu = ERFNetRAP(STEP3_STUDENT, len(STEP3_STUDENT), device="cpu")
    s_cpu.load_state_dict(state_copy(student))
    x_g, y_g = images.to(dev), labels.to(dev)
    loss_g, _ = ev(student, x_g, y_g)
    loss_c, _ = ev(s_cpu, images, labels)
    logits_g, logits_c = student(x_g, STEP3_CURRENT).cpu(), s_cpu(images, STEP3_CURRENT)
    noise = float((logits_g - logits_c).pow(2).mean().sqrt())
    top2 = logits_c.topk(2, dim=-1).values
    decided = (top2[..., 0] - top2[..., 1]) > 4 * noise
    kept = torch.where(decided, labels, torch.full_like(labels, nc))
    _, cm_g = ev(student, x_g, kept.to(dev))
    _, cm_c = ev(s_cpu, images, kept)
    flips = logits_g.argmax(-1) != logits_c.argmax(-1)
    rec["eval"] = {"loss": abs(float(loss_g) - float(loss_c)) / abs(float(loss_c)),
                   "logit_rms_diff": noise, "undecided_pixels": int((~decided).sum()),
                   "flips": int(flips.sum()), "flips_decided": int(flips[decided].sum()),
                   "cm_equal": bool(torch.equal(cm_g.cpu(), cm_c))}
    e = rec["eval"]
    print(f"[step3-cpu] eval step head {STEP3_CURRENT}, card vs CPU: loss {e['loss']:.2e}; "
          f"logits RMS diff {noise:.2e}; {e['undecided_pixels']} of {labels.numel()} pixels "
          f"within 4x of it of a tie ({e['flips']} argmax flips, {e['flips_decided']} off "
          f"them); cm on the others equal: {e['cm_equal']}")
    check(e["loss"] <= TOL_STEP3 and e["cm_equal"], f"eval step card vs CPU: {e}")
    return rec


def kernel_entry(name: str, replaces: str, launches: int, cases: list[dict], keys, blocks,
                 kind: str, **more_launches) -> dict:
    """The kernels-line entry of K2 or K3: `launches` on the step-2 path (and
    `more_launches` on the other paths); times summed over the 17 blocks of
    one student forward (K2) or backward (K3) at 6x512x1024 float32; errors
    over the outputs `keys` of every case (max_abs_err without K2's stats,
    which are sums over up to 786k pixels)."""
    t_ops = sum(r["count"] * r[f"{kind}_flops"] / PEAK_FLOPS["f32"] for r in blocks)
    t_bytes = sum(r["count"] * r[f"{kind}_bytes"] / PEAK_BYTES for r in blocks)
    sums = ("bound_3xtf32_ms",) + (("wgrad_library_ms", "wgrad_library_tf32_ms")
                                   if kind == "bwd" else ())
    extra = {k: sum(r["count"] * r[f"{kind}_{k}"] for r in blocks) for k in sums}
    extra["device_ms_by_kind"] = {
        k: None if any(r[f"{kind}_{k}_ms"] is None for r in blocks)
        else sum(r["count"] * r[f"{kind}_{k}_ms"] for r in blocks) for k in PAIR_KINDS[kind]}
    return {
        "name": name, "route": "cuda", "source": "mdilss_tpu_torch/csrc/nb1d_train.cu",
        "replaces": replaces, "launches": launches, **more_launches,
        "max_abs_err": max(c["max_abs_err"][k] for c in cases for k in keys
                           if k in c["max_abs_err"] and k != "stats"),
        "max_rel_l2": max(c["rel_l2"][k] for c in cases for k in keys if k in c["rel_l2"]),
        "ms": sum(r["count"] * r[f"{kind}_ms"] for r in blocks),
        "plain_ms": sum(r["count"] * r[f"{kind}_plain_ms"] for r in blocks),
        "bound_ms": sum(r["count"] * r[f"{kind}_bound_ms"] for r in blocks),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": None,
        **extra,
        "at": f"sum over the 34 pair calls (17 blocks x 2) of one student "
              f"{'forward' if kind == 'fwd' else 'backward'} at 6x512x1024 float32",
    }


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    index = torch.cuda.current_device()
    return out[index] if index < len(out) else out[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="build/chip_smoke.json")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    # the plain versions and cuDNN run fp32 convs in full fp32, not TF32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"[setup] {torch.cuda.get_device_name(0)}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}; TF32 off for fp32 convs and matmuls")
    t0 = time.perf_counter()
    build = phase_build()
    cases = phase_kernels(args.seed, dev, BLOCKS + (RAGGED,), BATCHES)
    model, imgs, main_path = phase_main_path(args.seed, dev, HEIGHT, WIDTH, BATCHES)
    times = phase_times(args.seed, dev, model, imgs)
    times["profile"] = phase_profile(model, imgs, dev)
    train_cases = phase_train_kernels(args.seed, dev)
    train_blocks = phase_train_block(args.seed, dev)
    run, train_path = phase_train_step(args.seed, dev)
    train_path["vs_cpu"] = phase_train_vs_cpu(args.seed, dev)
    train_times = phase_train_times(args.seed, dev, run)
    del run
    run3, step3_path = phase_step3(args.seed, dev)
    step3_path["times"] = phase_step3_times(run3)
    other_steps = phase_other_steps(args.seed, dev, run3)
    del run3
    other_steps["step3_vs_cpu"] = phase_step3_vs_cpu(args.seed, dev)
    card = card_line()

    kernels = {"kernels": [{
        "name": "nb1d_infer", "route": "cuda", "source": "mdilss_tpu_torch/csrc/nb1d_infer.cu",
        "replaces": "mdilss_tpu/ops/pallas/nb1d.py:94",
        "launches": main_path["launches"],
        "launches_train_path": train_path["launches"]["K1"],
        "launches_step3_path": step3_path["launches"]["K1"],
        "launches_eval_step": other_steps["eval"]["launches"]["K1"],
        "max_abs_err": max(c["max_abs_err"] for c in cases),
        "max_rel_l2": {dt: max(c["rel_l2"] for c in cases if c["dtype"] == dt) for dt in DTYPES},
        **k1_sums(times["blocks"], "bf16", 1),
        "library_ms": None,
        "at": "sum over the 17 nb1d blocks of one 1x512x1024 bf16 forward (2 launches each)",
        "kernel_names": K1_KERNEL,
        "batch6": {dt: {"kernel": K1_KERNEL[dt], **k1_sums(times["blocks"], dt, 6)}
                   for dt in DTYPES},
        "batch6_at": "the same sums at 6x512x1024 in bf16 (tensor-core bound) and fp32 "
                     "(CUDA-core bound; bound_3xtf32_ms: 3xTF32 on the tensor cores)",
    }, kernel_entry("nb1d_train_fwd", "mdilss_tpu/ops/pallas/nb1d_train.py:137",
                    train_path["launches"]["K2"], train_cases, ("y", "stats"),
                    train_times["blocks"], "fwd",
                    launches_step3_path=step3_path["launches"]["K2"],
                    launches_ce_step=other_steps["ce"]["launches"]["K2"]),
        kernel_entry("nb1d_train_bwd", "mdilss_tpu/ops/pallas/nb1d_train.py:258",
                     train_path["launches"]["K3"], train_cases,
                     ("du", "dw31", "db31", "dw13", "drap"), train_times["blocks"], "bwd",
                     launches_step3_path=step3_path["launches"]["K3"],
                     launches_ce_step=other_steps["ce"]["launches"]["K3"])]}
    record = {"card": card, "device": torch.cuda.get_device_name(0), "seed": args.seed,
              "torch": torch.__version__, "cuda": torch.version.cuda, "build": build,
              "kernel_cases": cases, "main_path": main_path, "times": times,
              "train_kernel_cases": train_cases, "train_blocks": train_blocks,
              "train_path": train_path, "train_times": train_times, "step3_path": step3_path,
              "other_steps": other_steps,
              "kernels": kernels["kernels"], "seconds": time.perf_counter() - t0}
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(record, f, indent=1, default=str)
    print(f"[done] {record['seconds']:.1f} s; full record in {args.out}")
    print(card)
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
