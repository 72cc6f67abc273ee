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
     serve_fn_batches; the K1 launch count is zeroed before this phase and must
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
     the RMS card - CPU logit difference);
 12. the trainer (cuDNN on its deterministic algorithms): the step-2 Trainer
     (config.step2: student [20, 20] at task 1, eval-mode teacher [20],
     6x512x1024 fp32, synthetic sources of 24 images per domain and subset,
     2 epochs, both domains validated every epoch, device_cache "auto": every
     set cached in full) with its counts zeroed just before fit: exactly 4 x
     (34 K1, 68 K2, 68 K3) per train epoch and 4 x 34 K1 per validation,
     finite losses, the frozen task-0 parameters and the teacher bitwise
     unchanged; run B stops after epoch 1 and a new Trainer resumes it: every
     parameter, buffer and Adam tensor, automated_log.txt and metrics.jsonl
     (but its timing key) bitwise equal to run A; the hybrid arm (a budget of
     12 rows: HybridCache with 12 of 24 rows on the card): its epoch's batches
     equal to the streaming Loader's after device_prefetch and to a full
     DeviceCache's, its trained epoch bitwise run A's first; the train epoch's
     seconds and img/s beside phase 9's bare step, one profiled train epoch,
     a cache take + augment_batch, each validation pass and the peak memory
     with the cache resident; the step-3 Trainer (config.step3: student
     [20, 20, 27] at task 2, train-mode teacher [20, 20], two batches of
     6x512x1024, one epoch): exactly 0 K1 / 170 K2 / 102 K3 per batch, Adam's
     count +4, the teacher bitwise unchanged; evaluate_checkpoint of run A's
     best checkpoint (kind "rap", float32, batch 6, both heads): 34 K1 per
     batch at full width, and at 2x128x256 its per-class IoU beside the CPU's
     float64 run of the file and the two confusion matrices equal off the
     near-tie pixels; and, a reading and not a gate (C5), a resume under
     cuDNN's default algorithms against a straight run under them (the
     largest parameter difference);
 13. the command line (cuDNN on its deterministic algorithms), in-process
     through `mdilss_tpu_torch.cli.main`: `pipeline --with-baselines` at
     6x512x1024 (12 synthetic images per domain and subset, one epoch per
     stage, a pretrained-encoder file written from a seeded ERFNet under
     `module.features.*`): step1 -> step2 -> step3, single_cs -> ft_step2 ->
     ft_step3, multitask, with the counts zeroed just before and read just
     after, each stage's launches exactly its train steps' (CE 0/34/34, step 2
     34/68/68, step 3 0/170/102 per step) plus 34 K1 per validation batch;
     step 1's initial shared convs equal to the file's and its per-task slots
     untouched; build_trainer of step 2 again on the finished tree: its teacher
     bitwise step1/best, its student extend_for_new_task of it (but the new
     output_conv) and the pipeline's initial student; every LR-0 parameter of
     step 2 (step 3) bitwise as in step1/best (step2/best); a second pipeline
     call skips every stage and launches nothing; `--stages step3` on an empty
     savedir raises ValueError; `eval` of step3/best and of multitask/best
     (--kind multi_task), 34 K1 per batch per head; `convert --export` of
     step3/best and `eval` of the file, the same mIoU; each stage's wall
     seconds, train img/s and peak memory. Its tree stays for phase 14;
 14. slice 10 on phase 13's checkpoints (cuDNN deterministic): C4, one
     step-2 step and one eval step at 2x128x256 with the global TF32 flags
     at PyTorch's defaults, card vs CPU within 1e-5; `export` (cli.main) of
     step3/best's head 2 at 512x1024 in four artifacts (bf16 labels and fp32
     logits, batch 1 and a symbolic batch) served by `serve_batches` over
     six uint8 images (as 6 batches of 1, and as one of 6 for the symbolic
     ones) with exactly 34 K1 launches per forward, fp32 logits within 1e-6
     rel L2 of the in-process forward, bf16 labels equal to the in-process
     ones off near-ties, the symbolic artifacts equal at batch 1 and 6, and
     per-forward ms (CUDA events) exported and in-process at batch 1 and 6;
     `parity-check --synthetic` (cli.main, batch 1) on a manifest of the
     chain's step1, step2, step3, ft_step2 and single_cs checkpoints: the
     four complete settings fail, the other five miss a checkpoint, none
     errs, 34 K1 per image per head, each per-domain mIoU equal to
     evaluate_checkpoint's; extract_features of head 2 (encoder and
     penultimate) on the card against the CPU's plain path within 1e-5 rel
     L2;
 15. the four ablation models (erfnet_bn, erfnet_onlyRAP, erfnet_RA_series,
     erfnet_RCM; their encoder blocks plain PyTorch on cuDNN, the kernels in
     the decoders' 4 nb1d blocks), on phase 13's pretrained-encoder file: per
     model, one step-2 step and one eval forward at 2x128x256 on the card and
     on the CPU (random BN, random non-symmetric Wt for RCM; TF32 flags at
     their defaults): loss, ce, kld, logits and running statistics within
     1e-5; `step1 --pretrained-encoder` -> `step2` -> `step3 --model X`
     through cli.main at 6x512x1024 (6 synthetic images per domain and
     subset, one epoch), with the counts zeroed before each stage and exactly
     its launches (CE 0/8/8, step 2 8/16/16, step 3 0/40/24 per step, 8 K1
     per validation batch); after step 2 and step 3 every LR-0 parameter
     bitwise as in the previous step's best, every current-task parameter
     moved from its initial value, and onlyrap's shared BN moved; `eval
     --kind erfnet_RCM` of its step3/best (8 K1 per batch) and `export` of
     its head 2 (fp32 logits) served over two images, 8 K1 per forward,
     within 1e-6 of the in-process forward; per model, a step-2 step and a
     step-3 batch at 6x512x1024 timed (CUDA events), their exact launches,
     peak memory, one profiled call (busy, idle share, K1/K2/K3 ms), and
     `ms_by_family` of each step-2 step and of erfnet_RCM's step-3 batch.
     Phase 13's tree is removed at its end;
 16. bf16 training (compute_dtype="bfloat16"): K2/K3's bf16 kernels at the 7
     block shapes at batch 6 and the ragged one, RAP and pre-stage each on and
     off, against their plain bf16 versions (gate TOL_BF16_PAIR) and float64
     (reported), bitwise on a rerun; the bf16 training block on the kernels
     against float64, gated at BF16_BLOCK_FACTOR x the same block built from
     the plain pairs; a step-2 step (2 steps) and a step-3 batch at
     6x512x1024 bf16 from trainer_OURS.sh's settings with the counts zeroed
     just before: exactly 34 / 68 / 68 and 0 / 170 / 102 bf16 launches per
     step and no fp32 launch, the first step's losses within TOL_BF16_VS_FP32
     of the fp32 step's on the same weights, frozen parameters and the teacher
     bitwise unchanged, ms, peak, a profiled step and ms_by_family; one bf16
     step at 2x128x256 card vs CPU (TOL_BF16_CPU); `step1 -> step2 -> step3
     --dtype bfloat16` through cli.main (6 images per domain and subset, one
     epoch): exact bf16 launches per stage, LR-0 parameters bitwise, each
     best evaluated by `eval` in float32; K2/K3 bf16 per block shape (ms,
     plain ms, bf16 bound, device ms by kind, K3's weight-gradient products as
     bf16 torch.matmul);
 17. remat (cuDNN on its deterministic algorithms): the step-2 step and the
     step-3 batch of phases 7 and 10 at 6x512x1024, float32 and bfloat16, once
     without and once with remat=True, remat_prev=True from the same weights,
     batch and masks, each with its counts zeroed just before: exactly 34 / 68
     / 68 and 0 / 170 / 102 without and 34 / 170 / 68 and 0 / 340 / 102 with
     (K2 reruns in the backward: each region's replay, and each previous-task
     forward's replay as a whole), all bf16 in bf16, no call into
     torch.utils.checkpoint without remat and 34 / 57 with; the losses,
     confusion matrix, every student parameter, running statistic and Adam
     tensor bitwise equal with and without, the teacher unchanged; each
     call's peak memory (reset just before) and one profiled call's device
     busy ms and idle share; then `step1 --remat` -> `step2 --remat` through
     cli.main (6 images per domain and subset, one epoch): exact launches per
     stage, step 2's LR-0 parameters bitwise step1/best's;
 18. data-parallel training (mdilss_tpu_torch/parallel; cuDNN deterministic):
     (a) a process group of one rank under NCCL, made in-process from a
     FileStore: the step-2 step and the step-3 batch of phase 17 in float32
     and bfloat16 through make_*_step(mesh=), each bitwise the call without a
     mesh (outputs, parameters, running statistics, Adam) with phase 17's
     launches without remat, and the fp32 step-2 step's wall and busy ms with
     and without the one-rank collectives; (b) two processes on the one card
     (`--dp-worker`, LOCAL_RANK 0 for both): whether NCCL takes two ranks on
     one device (what it said is recorded), then gloo: each rank's fp32
     step-2 step on its 3 of the 6 images against this process's 6-image
     step (the loss to 1e-5 relative; tests/test_multichip.py's criterion on
     the parameters; the running statistics to 1e-4; the ranks bitwise
     equal), each rank's launches exactly a step's, its wall and busy ms and
     peak, and one step-2 Trainer epoch at full width with device_cache=
     "auto" (the cache's mesh arm, exact launches per rank); (c) `python -m
     torch.distributed.run --standalone --nproc_per_node 1 -m mdilss_tpu_torch
     step1` at 6x512x1024 for one epoch;
 19. the spatial axis (mdilss_tpu_torch/parallel/halo.py; cuDNN
     deterministic): (a) one process: K2 fp32 and bf16 at the 7 block shapes
     with the stats window the whole height, bitwise the call without one;
     K2 (pre-stage and RAP) and K3 on padded slabs of the encoder's 1/8 maps
     (6x128x64x128, d in 2, 4, 8, 16, S in 2, 4, 8 slabs, fp32 and bf16; each
     slab with d halo rows cut from the whole tensor, K2's stats over the
     slab's rows, K3's gy zero on the halo rows) and K1 on slabs with 1 + d
     halo rows, stitched and summed against the whole calls (SP_TOL); (b)
     the fp32 step-2 step at 6x512x1024 on a 1x2 mesh (2 processes) and a
     2x2 mesh (4 processes), gloo, all on the one card (`--sp-worker`,
     LOCAL_RANK 0): each rank's block of the batch (its data index's images,
     its 256 rows), its launches exactly a step's 34 / 68 / 68, against this
     process's step (tests/test_multichip.py's criterion, the ranks bitwise
     equal); per rank its halo collectives and bytes, wall and busy ms, idle
     share and peak.
It prints the card's name and power limit, one `kernels` JSON line (K1's
entry also carries its 17-block sums at batch 6 in bf16 and fp32; each
entry its launches on every path driven, K1's through the exported heads
and parity-check too, `launches_ablation_*` on phase 15's and
`launches_bf16_*` on phase 16's, `launches_remat_*` on phase 17's,
`launches_sharded_*` on phase 18's (per rank at world 2),
`launches_spatial_*` on phase 19's (per mesh and rank); K2's and
K3's a `bf16` block with their
bf16 launches, times, bound and errors) and, as the last line,
{"ok": true, "device": {...}}. The full record goes to --out.
Without a CUDA card it exits 2 and prints no result.
"""
from __future__ import annotations

import argparse
import contextlib
import copy
import dataclasses
import io
import json
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

from mdilss_tpu_torch import cli
from mdilss_tpu_torch import config as PC
from mdilss_tpu_torch import serving
from mdilss_tpu_torch.parity import SETTINGS as PARITY_SETTINGS
from mdilss_tpu_torch.ckpt import torch_io
from mdilss_tpu_torch.ckpt.surgery import extend_for_new_task, keep_tasks
from mdilss_tpu_torch.data.class_weights import CLASS_WEIGHTS
from mdilss_tpu_torch.data.device_cache import DeviceCache, HybridCache
from mdilss_tpu_torch.data.loader import Loader, SyntheticSource, device_prefetch
from mdilss_tpu_torch.data.transforms import augment_batch, draw_augment, prepare_batch
from mdilss_tpu_torch.evaluate import evaluate_checkpoint, load_checkpoint
from mdilss_tpu_torch.metrics import confusion_matrix
from mdilss_tpu_torch.models import ERFNet, ERFNetAblation, ERFNetRAP
from mdilss_tpu_torch.models.blocks import NonBottleneck1d, NonBottleneck1dRAP
from mdilss_tpu_torch.models.erfnet_ablations import REFERENCE_NAMES
from mdilss_tpu_torch.models import topology
from mdilss_tpu_torch.models.topology import (DECODER_PLAN, DECODER_REGIONS, ENCODER_REGIONS,
                                              make_dropout_masks)
from mdilss_tpu_torch.ops import _build
from mdilss_tpu_torch.ops import nb1d_infer as K
from mdilss_tpu_torch.ops import nb1d_train as T
from mdilss_tpu_torch.ops.precision import no_tf32
from mdilss_tpu_torch.train import pipeline as PL
from mdilss_tpu_torch.train import protocols, steps
from mdilss_tpu_torch.train.loop import Trainer, init_model
from mdilss_tpu_torch.train.masks import ablation_lr_tree, rap_lr_tree

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
        got = list(serving.serve_fn_batches(fn, served[task], height, width))
        forwards += len(served[task])
        check(K.LAUNCHES - before == len(served[task]) * LAUNCHES_PER_FORWARD,
              "serve_fn_batches did not launch the kernels of every block")
        check(len(got) == 2 and all(g.shape == (4, height, width) and g.dtype == np.int32
                                    and g.min() >= 0 and g.max() < nc for g in got),
              "serve_fn_batches gave bad labels")
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


def make_step(student, compute_dtype: str = "float32", **remat):
    """(LR dict, the step-2 step); `remat`: the maker's remat / remat_prev."""
    lr = rap_lr_tree(student, current_task=CURRENT_TASK, shared_lr=SHARED_LR, ds_lr=DS_LR)
    step = steps.make_distill_step(current_task=CURRENT_TASK, prev_tasks=PREV_TASKS,
                                   class_weight=CLASS_WEIGHTS["BDD"], lr_tree=lr,
                                   num_epochs=NUM_EPOCHS, lambda_c=LAMBDA_C,
                                   compute_dtype=compute_dtype, **remat)
    return lr, step


def launch_counts() -> dict:
    """Launches of every type: K1, K2, K3."""
    return {"K1": K.LAUNCHES, "K2": T.LAUNCHES_FWD, "K3": T.LAUNCHES_BWD}


def bf16_launch_counts() -> dict:
    """The bfloat16 launches among them."""
    return {"K1": K.LAUNCHES_BF16, "K2": T.LAUNCHES_FWD_BF16, "K3": T.LAUNCHES_BWD_BF16}


def zero_launch_counts() -> None:
    K.LAUNCHES = T.LAUNCHES_FWD = T.LAUNCHES_BWD = 0
    K.LAUNCHES_BF16 = T.LAUNCHES_FWD_BF16 = T.LAUNCHES_BWD_BF16 = 0


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


def pair_bound(n: int, c: int, h: int, w: int, rap: bool, kind: str, dt: str = "f32") -> dict:
    """Least time of one K2 ("fwd") or K3 ("bwd") call with activations of type
    dt: FLOPs at the type's peak (fp32 on the CUDA cores, bf16 on the tensor
    cores) against bytes read and written once. K2: 6C^2 MACs per pixel (+C^2
    RAP), reads x and the weights, writes y and the float32 stats. K3:
    recompute c, dc, du, dw31, dw13 (5 x 3C^2 MACs, +2C^2 RAP), reads u, gy and
    the weights, writes du and the float32 weight gradients. In fp32 also
    `bound_3xtf32_ms`: the same FLOPs done as 3xTF32 on the tensor cores (3
    TF32 products each at 495 TFLOP/s) against the same bytes."""
    px, item = n * h * w, torch.finfo(DTYPES[dt]).bits // 8
    macs = (6 + rap if kind == "fwd" else 15 + 2 * rap) * c * c
    acts = 2 if kind == "fwd" else 3
    weights = (6 + rap) * c * c
    flops = 2 * px * macs
    nbytes = item * (acts * px * c + weights) + 4 * (weights * (kind == "bwd") + 4 * c)
    out = {"flops": flops, "bytes": nbytes, **_bound(flops, nbytes, dt)}
    if dt == "f32":
        out["bound_3xtf32_ms"] = max(3 * flops / PEAK_FLOPS["tf32"], nbytes / PEAK_BYTES) * 1e3
    if kind == "bwd":
        out["kinds"] = k3_kind_bounds(n, c, h, w, rap, dt)
    return out


def student_pass_bound(kind: str, dt: str) -> dict:
    """pair_bound of K2 ("fwd") or K3 ("bwd") summed over the 34 pair calls
    (17 blocks x 2) of one student pass at TRAIN_BATCH x HEIGHT x WIDTH: the
    calls' bounds, operation times and byte times."""
    out = dict.fromkeys(("bound_ms", "ops_ms", "bytes_ms"), 0.0)
    for _, c, _, rap, h, w, count in BLOCKS:
        b = pair_bound(TRAIN_BATCH, c, h, w, rap, kind, dt)
        for k in out:
            out[k] += 2 * count * b[k]
    return out


def _bound(flops: int, nbytes: int, dt: str) -> dict:
    t_ops, t_bytes = flops / PEAK_FLOPS[dt], nbytes / PEAK_BYTES
    return {"ops_ms": t_ops * 1e3, "bytes_ms": t_bytes * 1e3, "bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def k3_kind_bounds(n: int, c: int, h: int, w: int, rap: bool, dt: str = "f32") -> dict:
    """K3's FLOPs and least time split by its launch kinds, each with the
    activation passes its own design moves (each read or written once):
    dc recomputes c (3C^2 MACs per pixel) and takes colconv^T (3C^2),
    reading u and gy and writing c and dc; du is rowconv^T (3C^2, +C^2 RAP),
    reading dc and gy and writing du; wgrad is dw31, dw13 (6C^2, +C^2 drap),
    reading u, c, dc and gy and writing the float32 gradients. The kinds'
    FLOPs sum to pair_bound's."""
    px, item, cc = n * h * w, torch.finfo(DTYPES[dt]).bits // 8, c * c
    kinds = {"dc": (6 * cc, 4, 6 * cc, 4 * c), "du": ((3 + rap) * cc, 3, (3 + rap) * cc, 0),
             "wgrad": ((6 + rap) * cc, 4, 0, 4 * ((6 + rap) * cc + c))}
    out = {}
    for kind, (macs, passes, weights, f32_bytes) in kinds.items():
        flops, nbytes = 2 * px * macs, item * (passes * px * c + weights) + f32_bytes
        out[kind] = {"flops": flops, "bytes": nbytes, **_bound(flops, nbytes, dt)}
    return out


# K2's and K3's launches by kernel name: K2's pair and the fixed-order sum of its partial stats;
# K3's c and dc, du, the weight-gradient partials, their fixed-order sum
K2_KINDS = {"pair": "fwd_pair_mma_kernel", "sum": "namespace)::reduce_kernel("}
K3_KINDS = {"dc": "bwd_dc_kernel", "du": "bwd_du_kernel", "wgrad": "bwd_wgrad_kernel",
            "sum": "namespace)::reduce_kernel("}
# the bf16 kernels of K2 and K3 (phase 16)
K2_BF16_KINDS = {"pair": "fwd_pair_bf16_kernel", "sum": "namespace)::reduce_kernel("}
K3_BF16_KINDS = {"dc": "k3_c_dc_bf16_kernel", "du": "k3_du_bf16_kernel",
                 "wgrad": "k3_wgrad_bf16_kernel", "sum": "namespace)::reduce_kernel("}
K3_BOUND_KINDS = tuple(k for k in K3_KINDS if k != "sum")  # the kinds k3_kind_bounds splits
PAIR_KINDS = {("fwd", "f32"): K2_KINDS, ("bwd", "f32"): K3_KINDS,
              ("fwd", "bf16"): K2_BF16_KINDS, ("bwd", "bf16"): K3_BF16_KINDS}


def device_ms_by_kind(fn, kinds: dict, iters: int = 3, tries: int = 10) -> dict:
    """Device ms per call of `fn` for each kind of kernel (name pattern; every
    kind launches once per call), from torch.profiler over `iters` calls
    after one warm-up call: the mean over the launches the traces hold. The
    profiler's CUDA activity records can come back short, or empty, so traces
    are taken until each kind has `iters` launches in all, up to `tries`
    traces; a kind never seen is None (not measured)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    total, seen = dict.fromkeys(kinds, 0.0), dict.fromkeys(kinds, 0)
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                for k, pat in kinds.items():
                    if pat in e.name:
                        total[k] += e.time_range.elapsed_us() / 1e3
                        seen[k] += 1
        if all(n >= iters for n in seen.values()):
            break
    return {k: total[k] / seen[k] if seen[k] else None for k in kinds}


def fmt_ms(v) -> str:
    return "not measured" if v is None else f"{v:.4f}"


def add_ms(a, b):
    """a + b for times that may be None (not measured)."""
    return None if a is None or b is None else a + b


def wgrad_library_ms(x: torch.Tensor, gy: torch.Tensor, rap: bool, tf32: bool) -> float:
    """ms of the weight-gradient products of one K3 call as torch.matmul
    calls: [pixels x C]^T [pixels x C], 7 with RAP (dw31 x3, dw13 x3, drap),
    else 6, in x's type (float32 with TF32 off, or on as information; bf16 on
    the tensor cores). A yardstick only: the port never calls it."""
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
    groups = {"K1": tuple(K1_KERNEL.values()), "K2": (K2_KINDS["pair"], K2_BF16_KINDS["pair"]),
              "K3": tuple(v for kinds in (K3_KINDS, K3_BF16_KINDS) for k, v in kinds.items()
                          if k != "sum"),
              "K2/K3 partial sums": ("namespace)::reduce_kernel(",)}
    shares = {g: sum(v for k, v in by_name.items() if any(p in k for p in pats))
              for g, pats in groups.items()}
    k3_kinds = {kind: sum(v for k, v in by_name.items() if pat in k or K3_BF16_KINDS[kind] in k)
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

    blocks = pair_times(seed, dev, n, "f32")
    out["blocks"] = blocks
    return out


def pair_times(seed: int, dev: torch.device, n: int, dt: str) -> list[dict]:
    """K2 and K3 with activations of type dt at each block shape of one
    n x 512 x 1024 forward, a row per block over its two pairs ((dilation 1, no
    pre-stage) and (d, pre-stage)): ms (CUDA events), the plain version's ms,
    the bound (fp32: also the 3xTF32 one), device ms per launch kind
    (torch.profiler) and, for K3, its weight-gradient products as torch.matmul
    calls in the same type (fp32: TF32 off, and on as information)."""
    blocks = []
    for i, spec in enumerate(BLOCKS):
        name, c, d, rap, h, w, count = spec
        gen = torch.Generator().manual_seed(seed + 100 * i)
        x = cl(torch.randn(n, c, h, w, generator=gen).to(dev, DTYPES[dt]))
        gy = cl(torch.randn(n, c, h, w, generator=gen).to(dev, DTYPES[dt]))
        row = {"block": name, "count": count, "shape": [n, h, w, c], "dtype": dt}
        for pair, (dd, pre) in enumerate(((1, False), (d, True))):
            w31, b31, w13, rapw, pre_ab = pair_args(gen, c, rap, pre, dev)
            args = (w31, b31, w13, rapw, pre_ab, dd)
            for kind, kern, plain in (("fwd", T.fwd_pair, T.fwd_pair_plain),
                                      ("bwd", T.bwd_pair, T.bwd_pair_plain)):
                call = (lambda f: (lambda: f(x, *args))) if kind == "fwd" else (
                    lambda f: (lambda: f(x, gy, *args)))
                b = pair_bound(n, c, h, w, rap, kind, dt)
                vals = [("ms", time_ms(call(kern), iters=10, warmup=2)),
                        ("plain_ms", time_ms(call(plain), iters=5, warmup=1)),
                        ("bound_ms", b["bound_ms"])]
                if dt == "f32":
                    vals.append(("bound_3xtf32_ms", b["bound_3xtf32_ms"]))
                if kind == "bwd":
                    vals.append(("wgrad_library_ms", wgrad_library_ms(x, gy, rap, False)))
                    if dt == "f32":
                        vals.append(("wgrad_library_tf32_ms", wgrad_library_ms(x, gy, rap, True)))
                vals += [(f"{k}_ms", v) for k, v in
                         device_ms_by_kind(call(kern), PAIR_KINDS[kind, dt]).items()]
                for key, val in vals:
                    row[f"{kind}_{key}"] = add_ms(row.get(f"{kind}_{key}", 0.0), val)
                row[f"{kind}_bound_by"] = b["bound_by"]
                row[f"{kind}_flops"] = row.get(f"{kind}_flops", 0) + b["flops"]
                row[f"{kind}_bytes"] = row.get(f"{kind}_bytes", 0) + b["bytes"]
                for k, kb in b.get("kinds", {}).items():  # K3's launch kinds
                    for key in ("bound_ms", "ops_ms", "flops"):
                        row[f"{kind}_{k}_{key}"] = row.get(f"{kind}_{k}_{key}", 0) + kb[key]
        blocks.append(row)
        tc = (lambda k: f" / {row[f'{k}_bound_3xtf32_ms']:.4f} 3xTF32") if dt == "f32" else (
            lambda k: "")
        print(f"[train-time] {name} [{n},{h},{w},{c}] {dt} two pairs: K2 {row['fwd_ms']:.4f} ms "
              f"(plain {row['fwd_plain_ms']:.4f}, bound {row['fwd_bound_ms']:.4f} {dt}{tc('fwd')}; "
              f"device " + ", ".join(f"{k} {fmt_ms(row[f'fwd_{k}_ms'])}" for k in K2_KINDS)
              + f"), K3 {row['bwd_ms']:.4f} ms (plain {row['bwd_plain_ms']:.4f}, bound "
              f"{row['bwd_bound_ms']:.4f} {dt}{tc('bwd')}; device "
              + ", ".join(f"{k} {fmt_ms(row[f'bwd_{k}_ms'])}"
                          + (f" (bound {row[f'bwd_{k}_bound_ms']:.4f})"
                             if f"bwd_{k}_bound_ms" in row else "") for k in K3_KINDS)
              + f"; weight-gradient matmuls {row['bwd_wgrad_library_ms']:.4f} {dt}"
              + (f", {row['bwd_wgrad_library_tf32_ms']:.4f} TF32)" if dt == "f32" else ")"))
    return blocks


# R0: the step's device time outside K1/K2/K3 by family, from the chrome trace of one profiled
# step (profile(with_stack=True)). Each device kernel, copy or fill is found where the host
# launched it: its runtime call (cudaLaunchKernel, ...; the trace's "correlation" argument), else
# the torch op of the same "External id". The torch ops and Python frames around that point on
# the launching thread name it; for an op of the backward (autograd::engine::evaluate_function,
# with a sequence number) so do those around the forward op that made its autograd node. It goes
# to the first family one of whose patterns is in one of those names; what no launch or name
# places goes by its own name (FAMILY_BY_KERNEL_NAME), else to "unattributed".
OWN_KERNELS = ("nb1d_pair_", "fwd_pair_mma_kernel", "bwd_dc_kernel", "bwd_du_kernel",
               "bwd_wgrad_kernel", "fwd_pair_bf16_kernel", "k3_c_dc_bf16_kernel",
               "k3_du_bf16_kernel", "k3_wgrad_bf16_kernel", "namespace)::reduce_kernel(")
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


def make_step3(student, compute_dtype: str = "float32", **remat):
    """(LR dict, the two-phase step-3 step); `remat` as make_step's."""
    lr = rap_lr_tree(student, current_task=STEP3_CURRENT, shared_lr=SHARED_LR, ds_lr=DS_LR)
    step = steps.make_two_phase_distill_step(
        current_task=STEP3_CURRENT, prev_tasks=STEP3_PREV, class_weight=CLASS_WEIGHTS["IDD"],
        lr_tree=lr, num_epochs=NUM_EPOCHS, lambda_c=LAMBDA_C, iou_train=True,
        compute_dtype=compute_dtype, **remat)
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


# ---- phase 12: the trainer ------------------------------------------------------------------
# config.step2 / config.step3 at the reference trainer_OURS.sh settings (6x512x1024 fp32, LR 5e-4
# domain-specific / 5e-6 shared, lambda 0.1, BDD / IDD class weights), synthetic data
TRAINER_IMAGES = 24  # per (domain, subset) of step 2: 4 batches of 6; 24 x 2 MiB cached
TRAINER_EPOCHS = 2
STEP3_TRAINER_IMAGES = 12  # two step-3 batches
# per step-2 train epoch: 4 steps of STEP_LAUNCHES; per domain's validation: 4 eval forwards
TRAIN_EPOCH_LAUNCHES = {k: 4 * v for k, v in STEP_LAUNCHES.items()}
VAL_LAUNCHES = {k: 4 * v for k, v in EVAL_LAUNCHES.items()}
HYBRID_ROWS = 12  # the hybrid arm's budget: 12 rows of 512x1024 uint8 image + label
EVAL_CKPT_BATCH = 6  # evaluate_checkpoint: 8 synthetic images per head, 2 batches of 6


# The K4 glue (ops/nb1d_train.Nb1dTrain outside K2/K3: BN statistics and affine, dropout, the
# residual, the BN backward) in float32: the least bytes it moves, each [N, C, H, W] activation
# read or written once per pass its forward and backward need. Forward, one pass: read y2 and
# x, write out (3). Backward, five passes: BN2's reductions (read out, g_out, y2: 3), BN2's
# apply (the same three, write g_y2: 4), BN1's reductions (read dm, y1: 2), BN1's apply (the
# same two, write g_y1: 3), dx = relu'(out) g_out + dx_c (read out, g_out, dx_c, write dx: 4).
# A block's dropout mask and per-channel vectors are [N, C] and [C]: left out.
GLUE_FWD_ACTS, GLUE_BWD_ACTS = 3, 3 + 4 + 2 + 3 + 4


def glue_bound(n: int = TRAIN_BATCH, item: int = 4) -> dict:
    """K4's byte bound at n x 512 x 1024 over the 17 blocks of one forward,
    activations of `item` bytes (4: float32, 2: bf16): ms per forward without
    backward (a train-mode teacher), per forward with backward (a student),
    per step-2 step (two students) and per step-3 batch (three students, two
    teachers), at PEAK_BYTES."""
    act = sum(count * n * c * h * w * item for _, c, _, _, h, w, count in BLOCKS)
    fwd_ms = GLUE_FWD_ACTS * act / PEAK_BYTES * 1e3
    fb_ms = (GLUE_FWD_ACTS + GLUE_BWD_ACTS) * act / PEAK_BYTES * 1e3
    return {"activation_bytes_per_forward": act, "fwd_ms": fwd_ms, "fwd_bwd_ms": fb_ms,
            "step2_ms": 2 * fb_ms, "step3_ms": 3 * fb_ms + 2 * fwd_ms,
            "blocks_step2": 2 * 17, "blocks_step3": 5 * 17, "blocks_step3_with_backward": 3 * 17,
            "bound_by": "bytes"}


def trainer_cfg(root: str, name: str, protocol: str, **kw):
    kw = {"synthetic": True, "batch_size": TRAIN_BATCH, "height": HEIGHT, "width": WIDTH,
          "device_cache": "auto", "savedir": os.path.join(root, name), **kw}
    if protocol == "step2":
        return PC.step2(num_epochs=TRAINER_EPOCHS, eval_every=1, eval_old_every=1,
                        synthetic_size=TRAINER_IMAGES, **kw)
    return PC.step3(num_epochs=1, synthetic_size=STEP3_TRAINER_IMAGES, **kw)


def count_calls(tr, log: list, dev) -> None:
    """Wrap the trainer's train_epoch and evaluate: each call appends its kind,
    argument, launches and seconds (the device synchronised at both ends) to `log`."""
    for kind, name in (("train", "train_epoch"), ("val", "evaluate")):
        fn = getattr(tr, name)

        def wrapped(*a, _fn=fn, _kind=kind):
            sync(dev)
            before, t0 = launch_counts(), time.perf_counter()
            out = _fn(*a)
            sync(dev)
            log.append({"kind": _kind, "arg": a[0], "seconds": time.perf_counter() - t0,
                        "launches": {k: v - before[k] for k, v in launch_counts().items()}})
            return out

        setattr(tr, name, wrapped)


def trainer_state(tr) -> dict:
    """The student's parameters and buffers and Adam's state, cloned."""
    out = state_copy(tr.ts.model)
    out.update(opt_m=tr.ts.opt.m.clone(), opt_v=tr.ts.opt.v.clone(),
               opt_count=torch.tensor(tr.ts.opt.count))
    return out


def unequal(a: dict, b: dict) -> list[str]:
    return [k for k in a if not torch.equal(a[k], b[k])]


def run_files(savedir: str) -> tuple[str, list[dict]]:
    """automated_log.txt, and metrics.jsonl's rows without their timing key."""
    with open(os.path.join(savedir, "automated_log.txt")) as f:
        log = f.read()
    with open(os.path.join(savedir, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    for r in rows:
        del r["epoch_seconds"]
    return log, rows


def batches_equal(a, b) -> bool:
    """Two lists of (images, labels, valid) batches, bitwise."""
    def host(t):
        return torch.as_tensor(t).cpu()

    return len(a) == len(b) and all(
        all(torch.equal(host(x), host(y)) for x, y in zip(ba, bb)) for ba, bb in zip(a, b))


def phase_trainer(seed: int, dev: torch.device, bare_img_per_s: float) -> dict:
    """Phase 12: the step-2 Trainer at full width (run A: 2 epochs; run B: 1
    epoch, a stop, a resumed Trainer, the second epoch; bitwise equal), the
    hybrid cache arm, the step-3 Trainer and evaluate_checkpoint, with cuDNN
    on its deterministic algorithms."""
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "trainer_runs")
    shutil.rmtree(root, ignore_errors=True)
    old = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        rec = phase_trainer_step2(seed, dev, root, bare_img_per_s)
        rec["step3"] = phase_trainer_step3(seed, dev, root)
        rec["evaluate_checkpoint"] = phase_evaluate_checkpoint(
            dev, os.path.join(root, "a", "best"))
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = old
    shutil.rmtree(root, ignore_errors=True)
    return rec


def phase_trainer_step2(seed: int, dev: torch.device, root: str, bare_img_per_s: float) -> dict:
    torch.manual_seed(seed + 20)
    teacher = ERFNetRAP(TEACHER_CLASSES, len(TEACHER_CLASSES), device=dev)
    randomize_bn(teacher, torch.Generator().manual_seed(seed + 21))
    teacher_before = state_copy(teacher)
    cur = "BDD"
    rec = {}

    # run A: two epochs; the counts zeroed just before fit and read just after
    calls: list[dict] = []
    tr_a = Trainer(trainer_cfg(root, "a", "step2", seed=seed), teacher=teacher, device=dev)
    lr = rap_lr_tree(tr_a.ts.model, current_task=CURRENT_TASK, shared_lr=SHARED_LR, ds_lr=DS_LR)
    frozen = {k: p.detach().clone() for k, p in tr_a.ts.model.named_parameters() if lr[k] == 0.0}
    count_calls(tr_a, calls, dev)
    sync(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    zero_launch_counts()
    hist_a = tr_a.fit()
    rec["launches"] = launch_counts()
    rec["peak_memory_bytes"] = torch.cuda.max_memory_allocated(dev)
    caches = [type(c).__name__ for c in (*tr_a._train_caches.values(),
                                         *tr_a._val_caches.values())]
    rec["calls"] = calls
    for c in calls:
        want = TRAIN_EPOCH_LAUNCHES if c["kind"] == "train" else VAL_LAUNCHES
        print(f"[trainer] run A {c['kind']} {c['arg']}: launches {c['launches']}; "
              f"{c['seconds']:.3f} s")
        check(c["launches"] == want, f"trainer {c['kind']} {c['arg']} launched {c['launches']}, "
                                     f"expected {want}")
    check([c["kind"] for c in calls] == ["train", "val", "val"] * TRAINER_EPOCHS,
          f"run A made the calls {[(c['kind'], c['arg']) for c in calls]}")
    check(rec["launches"] == {k: sum(c["launches"][k] for c in calls) for k in rec["launches"]},
          f"run A launched {rec['launches']} outside its epochs and validations")
    check(caches == ["DeviceCache"] * 3, f"run A's caches {caches}: expected all three full")
    rows = [json.loads(line) for line in open(os.path.join(tr_a.cfg.savedir, "metrics.jsonl"))]
    losses = [r[k] for r in rows for k in ("train_loss", "train_ce", "train_kld",
                                           f"val_loss_{cur}", "val_loss_cityscapes")]
    check(len(rows) == TRAINER_EPOCHS and all(np.isfinite(losses)), f"run A's rows {rows}")
    params = dict(tr_a.ts.model.named_parameters())
    moved = [k for k, p in frozen.items() if not torch.equal(params[k], p)]
    check(len(frozen) > 0 and not moved, f"frozen task-0 parameters moved: {moved[:5]}")
    check(not changed(teacher, teacher_before), "the step-2 teacher changed")
    epoch_s = [c["seconds"] for c in calls if c["kind"] == "train"]
    val_ms = [c["seconds"] * 1e3 for c in calls if c["kind"] == "val"]
    rec.update(rows=rows, epoch_seconds=epoch_s, val_ms=val_ms,
               epoch_img_per_s=[TRAINER_IMAGES / s for s in epoch_s],
               bare_step_img_per_s=bare_img_per_s, frozen_params=len(frozen))
    print(f"[trainer] run A: losses {[round(v, 6) for v in losses]}; {len(frozen)} frozen "
          f"task-0 parameters bitwise unchanged, the teacher unchanged; peak memory with the "
          f"cache resident {rec['peak_memory_bytes'] / 2**30:.2f} GiB; launches "
          f"{rec['launches']}")
    print(f"[trainer-time] train epoch ({TRAINER_IMAGES} images, 6x{HEIGHT}x{WIDTH} f32): "
          + ", ".join(f"{s:.3f} s ({TRAINER_IMAGES / s:.2f} img/s)" for s in epoch_s)
          + f"; the bare step (phase 9) {bare_img_per_s:.2f} img/s; validation passes "
          + ", ".join(f"{v:.3f}" for v in val_ms) + " ms")

    # run B: stop after epoch 1, resume in a new Trainer
    tr_b1 = Trainer(trainer_cfg(root, "b", "step2", seed=seed), teacher=teacher, device=dev)
    tr_b1.fit(stop_after=1)
    after_1 = trainer_state(tr_b1)
    del tr_b1
    tr_b2 = Trainer(trainer_cfg(root, "b", "step2", seed=seed, resume=True), teacher=teacher,
                    device=dev)
    check(tr_b2.start_epoch == 2, f"run B resumed at epoch {tr_b2.start_epoch}")
    tr_b2.fit()
    diff = unequal(trainer_state(tr_a), trainer_state(tr_b2))
    files_a, files_b = run_files(tr_a.cfg.savedir), run_files(tr_b2.cfg.savedir)
    rec["resume"] = {"unequal": diff, "files_equal": files_a == files_b,
                     "gen_equal": torch.equal(tr_a.aug_gen.get_state(), tr_b2.aug_gen.get_state())}
    print(f"[trainer] run B (stop after epoch 1, resume): {len(trainer_state(tr_a))} "
          f"parameters, buffers and Adam tensors unequal to run A: {len(diff)}; "
          f"automated_log.txt and metrics.jsonl (but epoch_seconds) equal: "
          f"{rec['resume']['files_equal']}")
    check(not diff and rec["resume"]["files_equal"] and rec["resume"]["gen_equal"],
          f"resume is not bitwise the uninterrupted run: {rec['resume']}")
    del tr_b2
    rec["resume_default_cudnn"] = resume_default_cudnn(seed, root, teacher, dev, tr_a)

    # the hybrid arm: 12 of 24 training rows on the card
    tr_h = Trainer(trainer_cfg(root, "h", "step2", seed=seed,
                               device_cache=str(HYBRID_ROWS * HEIGHT * WIDTH * 4)),
                   teacher=teacher, device=dev)
    hybrid = tr_h._cache_for(cur, "train")
    check(isinstance(hybrid, HybridCache) and hybrid.k == HYBRID_ROWS,
          f"the hybrid budget gave {hybrid!r}")
    ld = tr_h.train_loaders[cur]
    full = DeviceCache(ld, device=dev)
    ld.set_epoch(1)
    got = {"hybrid": list(hybrid.epoch_batches(1)), "full": list(full.epoch_batches(1)),
           "stream": list(device_prefetch(ld, device=dev))}
    same = {k: batches_equal(got[k], got["stream"]) for k in ("hybrid", "full")}
    del got, full
    print(f"[trainer] hybrid arm ({HYBRID_ROWS}/{TRAINER_IMAGES} rows cached): epoch-1 batches "
          f"equal to the streaming Loader's after device_prefetch: {same['hybrid']}; the full "
          f"cache's equal to them: {same['full']}")
    check(all(same.values()), f"cached batches differ from the streamed ones: {same}")
    tr_h.fit(stop_after=1)
    diff = unequal(after_1, trainer_state(tr_h))
    row_equal = run_files(tr_h.cfg.savedir)[1][0] == files_a[1][0]
    print(f"[trainer] hybrid arm epoch 1 vs run A's epoch 1: {len(diff)} tensors unequal; "
          f"metrics row equal: {row_equal}")
    check(not diff and row_equal, f"the hybrid arm's epoch 1 differs from run A's: {diff[:5]}")
    rec["hybrid"] = {"batches_equal": same, "unequal": diff, "row_equal": row_equal}
    del tr_h, hybrid

    # timing: one profiled train epoch with cuDNN's deterministic algorithms (as the gates
    # above ran), then one timed and one profiled with its default ones (as phase 9 runs the
    # bare step)
    def epoch():
        Trainer.train_epoch(tr_a, TRAINER_EPOCHS)

    keys = ("wall_ms", "device_ms", "idle_share", "kernels_per_step", "ms_by_group")
    what = f"one train epoch ({TRAINER_IMAGES // TRAIN_BATCH} steps)"
    prof = profile_once(epoch, "trainer-profile", f"{what}, cuDNN deterministic")
    rec["profile"] = {k: prof[k] for k in keys}
    torch.backends.cudnn.deterministic = False
    try:
        epoch()
        sync(dev)
        t0 = time.perf_counter()
        epoch()
        sync(dev)
        rec["epoch_seconds_default_cudnn"] = time.perf_counter() - t0
        prof = profile_once(epoch, "trainer-profile", f"{what}, cuDNN default")
        rec["profile_default_cudnn"] = {k: prof[k] for k in keys}
    finally:
        torch.backends.cudnn.deterministic = True
    s_def = rec["epoch_seconds_default_cudnn"]
    print(f"[trainer-time] train epoch with cuDNN's default algorithms: {s_def:.3f} s "
          f"({TRAINER_IMAGES / s_def:.2f} img/s; the bare step {bare_img_per_s:.2f})")
    cache = tr_a._cache_for(cur, "train")
    idx = np.arange(TRAIN_BATCH) * 3
    flip, tx, ty = draw_augment(torch.Generator().manual_seed(seed), TRAIN_BATCH)

    def take_augment():
        return augment_batch(*cache.take(idx), flip, tx, ty, num_classes=20)

    rec["take_augment_ms"] = time_ms(take_augment, iters=20, warmup=3)
    prof = profile_once(take_augment, "take-augment-profile", "one take + augment_batch")
    rec["take_augment_device_ms"] = prof["device_ms"]
    print(f"[trainer-time] cache take + augment_batch at {TRAIN_BATCH}x{HEIGHT}x{WIDTH}: "
          f"{rec['take_augment_ms']:.4f} ms per call (CUDA events), device busy "
          f"{prof['device_ms']:.4f} ms")
    return rec


def resume_default_cudnn(seed: int, root: str, teacher, dev, tr_a) -> dict:
    """C5, a reading and not a gate: with cuDNN's default algorithms (the
    package sets none), run C stops after epoch 1 and a new Trainer resumes
    it; run D trains both epochs straight. The largest parameter difference
    of C against D, and of D against run A (deterministic algorithms)."""
    torch.backends.cudnn.deterministic = False
    try:
        Trainer(trainer_cfg(root, "c", "step2", seed=seed), teacher=teacher,
                device=dev).fit(stop_after=1)
        tr_c = Trainer(trainer_cfg(root, "c", "step2", seed=seed, resume=True), teacher=teacher,
                       device=dev)
        tr_c.fit()
        tr_d = Trainer(trainer_cfg(root, "d", "step2", seed=seed), teacher=teacher, device=dev)
        tr_d.fit()
    finally:
        torch.backends.cudnn.deterministic = True

    def params(tr):
        return {k: p.detach() for k, p in tr.ts.model.named_parameters()}

    def diff(a: dict, b: dict) -> tuple[float, int]:
        return (max(float((a[k] - b[k]).abs().max()) for k in a),
                sum(not torch.equal(a[k], b[k]) for k in a))

    (c_d, n_cd), (d_a, n_da) = diff(params(tr_c), params(tr_d)), diff(params(tr_d), params(tr_a))
    rec = {"resumed_vs_straight_max_abs": c_d, "resumed_vs_straight_unequal": n_cd,
           "straight_vs_deterministic_max_abs": d_a, "straight_vs_deterministic_unequal": n_da,
           "params": len(params(tr_d))}
    print(f"[trainer] C5 reading, cuDNN's default algorithms: run C (stop after epoch 1, "
          f"resume) vs run D (2 epochs straight): largest parameter difference {c_d:.3e}, "
          f"{n_cd} of {rec['params']} parameters unequal; run D vs run A (deterministic "
          f"algorithms): {d_a:.3e}, {n_da} unequal")
    return rec


def phase_trainer_step3(seed: int, dev: torch.device, root: str) -> dict:
    """The step-3 Trainer: two batches, one epoch; per batch exactly
    STEP3_LAUNCHES, the teacher bitwise unchanged, Adam's count +4."""
    torch.manual_seed(seed + 22)
    teacher = ERFNetRAP(STEP3_TEACHER, len(STEP3_TEACHER), device=dev)
    randomize_bn(teacher, torch.Generator().manual_seed(seed + 23))
    before = state_copy(teacher)
    tr = Trainer(trainer_cfg(root, "s3", "step3", seed=seed), teacher=teacher, device=dev)
    batches: list[dict] = []
    one_batch = tr._one_batch

    def counted(*a):
        b = launch_counts()
        one_batch(*a)
        batches.append({k: v - b[k] for k, v in launch_counts().items()})

    tr._one_batch = counted
    calls: list[dict] = []
    count_calls(tr, calls, dev)
    zero_launch_counts()
    row = tr.fit()
    launches = launch_counts()
    t_moved = changed(teacher, before)
    rec = {"batches": batches, "calls": calls, "launches": launches, "adam_count": tr.ts.opt.count,
           "row": row, "teacher_changed": t_moved}
    print(f"[trainer-step3] batches launched {batches}; Adam count {tr.ts.opt.count}; calls "
          + ", ".join(f"{c['kind']} {c['arg']} {c['launches']} {c['seconds']:.3f} s"
                      for c in calls)
          + f"; teacher unchanged: {not t_moved}; loss {row['train_loss']:.6f}")
    check(batches == [STEP3_LAUNCHES] * (STEP3_TRAINER_IMAGES // TRAIN_BATCH),
          f"step-3 trainer batches launched {batches}, expected {STEP3_LAUNCHES} each")
    check(tr.ts.opt.count == 2 * len(batches), f"Adam took {tr.ts.opt.count} steps")
    check(not t_moved, f"the step-3 teacher changed: {t_moved[:5]}")
    check(np.isfinite(row["train_loss"]) and [c["kind"] for c in calls] == ["train", "val"],
          f"step-3 trainer: {row}, calls {calls}")
    check(calls[1]["launches"]["K1"] == 34 * 2, f"step-3 validation launched {calls[1]}")
    return rec


def phase_evaluate_checkpoint(dev: torch.device, best: str) -> dict:
    """evaluate_checkpoint of run A's best checkpoint: at full width exactly
    34 K1 per batch; at 2x128x256 its per-class IoU beside the CPU's float64
    run of the same file, and the confusion matrices of the same weights and
    batches equal off the pixels whose float64 top-2 gap is within 4x the RMS
    card - CPU logit difference."""
    heads = ["cityscapes", "BDD"]
    zero_launch_counts()
    full = evaluate_checkpoint(best, kind="rap", datasets=heads, batch_size=EVAL_CKPT_BATCH,
                               height=HEIGHT, width=WIDTH, synthetic=True, device=dev)
    launches = launch_counts()
    n_batches = len(heads) * -(-8 // EVAL_CKPT_BATCH)
    print(f"[evaluate-checkpoint] {best}: mIoU {full}; launches {launches} over {n_batches} "
          f"batches of {EVAL_CKPT_BATCH}x{HEIGHT}x{WIDTH}")
    check(launches == {"K1": 34 * n_batches, "K2": 0, "K3": 0},
          f"evaluate_checkpoint launched {launches}")
    n, h, w = SMALL
    kw = dict(kind="rap", datasets=heads, batch_size=n, height=h, width=w, synthetic=True,
              return_per_class=True)
    _, pc_card = evaluate_checkpoint(best, device=dev, **kw)
    _, pc_cpu = evaluate_checkpoint(best, device="cpu", compute_dtype="float64", **kw)
    model = load_checkpoint(best, kind="rap", device=dev)
    model64 = load_checkpoint(best, kind="rap", device="cpu").to(torch.float64)
    rec = {"launches": launches, "miou_full_width": full}
    for t, d in enumerate(heads):
        nc = model.decoder[t].output_conv.bias.shape[0]
        cms, undecided, flips, noise_max = {"card": 0, "cpu": 0}, 0, 0, 0.0
        for imgs, lbls, _ in Loader(SyntheticSource(nc, n=8, height=h, width=w),
                                    batch_size=n, height=h, width=w):
            x, y = prepare_batch(torch.from_numpy(imgs), torch.from_numpy(lbls), num_classes=nc)
            l_card = model(x.to(dev), t).cpu().double()
            l_cpu = model64(x.double(), t)
            noise = float((l_card - l_cpu).pow(2).mean().sqrt())
            top2 = l_cpu.topk(2, dim=-1).values
            decided = (top2[..., 0] - top2[..., 1]) > 4 * noise
            kept = torch.where(decided, y, torch.full_like(y, nc))  # a label of C counts nowhere
            for name, logits in (("card", l_card), ("cpu", l_cpu)):
                cms[name] = cms[name] + confusion_matrix(logits.argmax(-1), kept, num_classes=nc)
            flips += int((l_card.argmax(-1) != l_cpu.argmax(-1)).sum())
            undecided += int((~decided).sum())
            noise_max = max(noise_max, noise)
        pc_diff = float(np.abs(pc_card[d] - pc_cpu[d]).max())
        rec[d] = {"cm_equal": bool(torch.equal(cms["card"], cms["cpu"])), "flips": flips,
                  "undecided_pixels": undecided, "logit_rms_diff": noise_max,
                  "per_class_max_abs_diff": pc_diff}
        print(f"[evaluate-checkpoint] {d} at {n}x{h}x{w}, card float32 vs CPU float64: logits "
              f"RMS diff <= {noise_max:.2e}; {undecided} pixels within 4x of it of a tie, "
              f"{flips} argmax flips; cm off them equal: {rec[d]['cm_equal']}; per-class IoU "
              f"max |diff| {pc_diff:.2e}")
        check(rec[d]["cm_equal"] and (flips > 0 or pc_diff == 0.0),
              f"evaluate_checkpoint card vs CPU float64 for {d}: {rec[d]}")
    return rec


# ---- phase 13: the CLI chain ------------------------------------------------------------------
# `python -m mdilss_tpu_torch pipeline --with-baselines` at the reference settings (6x512x1024
# fp32, trainer_OURS.sh's LRs and lambda), in-process through cli.main, one epoch per stage on
# synthetic sources of CHAIN_IMAGES per domain and subset (2 batches of 6)
CHAIN_IMAGES = 12
CHAIN_BATCHES = CHAIN_IMAGES // TRAIN_BATCH
CHAIN_STAGES = ("step1", "step2", "step3", "single_cs", "ft_step2", "ft_step3", "multitask")
# per stage: launches per train step, train steps in its epoch (multitask: one per domain in turn),
# and the domains it validates in that epoch (the current one; step 2 and ft every old one too,
# eval_old_every 1; step 3 and multitask none of the others at epoch 1: eval_old_every 10 / 5)
CHAIN_PLAN = {
    "step1": (CE_LAUNCHES, CHAIN_BATCHES, 1),
    "step2": (STEP_LAUNCHES, CHAIN_BATCHES, 2),
    "step3": (STEP3_LAUNCHES, CHAIN_BATCHES, 1),
    "single_cs": (CE_LAUNCHES, CHAIN_BATCHES, 1),
    "ft_step2": (CE_LAUNCHES, CHAIN_BATCHES, 2),
    "ft_step3": (CE_LAUNCHES, CHAIN_BATCHES, 3),
    "multitask": (CE_LAUNCHES, 3 * CHAIN_BATCHES, 1),
}
CHAIN_EVAL_BATCHES = 2  # eval: 8 synthetic images per head in batches of 6


def chain_expected(stage: str) -> dict:
    per_step, n_steps, n_val = CHAIN_PLAN[stage]
    return {k: n_steps * v + (n_val * CHAIN_BATCHES * EVAL_LAUNCHES[k]) for k, v in
            per_step.items()}


def write_pretrained_encoder(seed: int, path: str) -> dict:
    """A reference-grammar ImageNet encoder file: a seeded single-task ERFNet's
    encoder with random BN, under `module.features.*`; returns its state dict
    (without the prefix)."""
    torch.manual_seed(seed)
    net = ERFNet(20, device="cpu")
    randomize_bn(net, torch.Generator().manual_seed(seed + 1))
    enc = {k: v.clone() for k, v in net.state_dict().items() if k.startswith("encoder.")}
    torch.save({"epoch": 90, "arch": "erfnet_imagenet", "best_acc": 0.0,
                "state_dict": {"module.features." + k: v for k, v in enc.items()}}, path)
    return enc


def run_cli(argv: list[str]) -> tuple[str, float]:
    """cli.main(argv) with its standard output captured (and echoed, its
    last 3 lines); returns (output, seconds)."""
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        cli.main(argv)
    secs = time.perf_counter() - t0
    out = buf.getvalue()
    for line in out.strip().splitlines()[-3:]:
        print(f"[cli-chain]   | {line[:300]}")
    return out, secs


def phase_cli_chain(seed: int, dev: torch.device) -> dict:
    """Phase 13: the pipeline, eval and convert commands in-process, with the
    gates fixed in PERF.md before the first run: exact launches per stage and
    in all, the pretrained encoder in step 1's initial weights, the step-2
    teacher and student rebuilt from step1/best, the frozen parameters across
    the chain, a rerun that trains nothing, the predecessor rule, and the
    export round trip. Its tree under build/cli_chain stays for phase 14."""
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "cli_chain")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    t_phase = time.perf_counter()
    old = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        rec = _cli_chain(seed, dev, root)
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = old
        PL.build_trainer = protocols.build_trainer
    rec["seconds"] = time.perf_counter() - t_phase
    print(f"[cli-chain] phase 13 in {rec['seconds']:.1f} s")
    return rec


def _cli_chain(seed: int, dev: torch.device, root: str) -> dict:
    enc_path = os.path.join(root, "encoder.pth.tar")
    enc = write_pretrained_encoder(seed + 30, enc_path)
    runs = os.path.join(root, "runs")
    argv = ["pipeline", "--with-baselines", "--synthetic", "--synthetic-size", str(CHAIN_IMAGES),
            "--num-epochs", "1", "--batch-size", str(TRAIN_BATCH), "--height", str(HEIGHT),
            "--width", str(WIDTH), "--pretrained-encoder", enc_path, "--savedir", runs,
            "--seed", str(seed)]
    stages: dict[str, dict] = {}

    def recording_build(cfg, device=None):
        """build_trainer, recording each stage's initial student and timing its fit."""
        tr = protocols.build_trainer(cfg, device=device)
        stage = os.path.basename(cfg.savedir)
        rec = stages[stage] = {"initial": {k: v.cpu() for k, v in state_copy(tr.ts.model).items()},
                               "cfg": cfg}
        fit = tr.fit

        def timed_fit(*a, **kw):
            sync(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            before, t0 = launch_counts(), time.perf_counter()
            row = fit(*a, **kw)
            sync(dev)
            rec.update(seconds=time.perf_counter() - t0, row=row,
                       launches={k: v - before[k] for k, v in launch_counts().items()},
                       peak_memory_bytes=torch.cuda.max_memory_allocated(dev))
            return row

        tr.fit = timed_fit
        return tr

    PL.build_trainer = recording_build
    zero_launch_counts()
    _, chain_s = run_cli(argv)
    launches = launch_counts()
    PL.build_trainer = protocols.build_trainer
    out = {"launches": launches, "seconds": chain_s, "stages": {}}
    check(tuple(stages) == CHAIN_STAGES, f"the pipeline ran {tuple(stages)}")
    want_all = {k: 0 for k in launches}
    for stage in CHAIN_STAGES:
        r, want = stages[stage], chain_expected(stage)
        images = CHAIN_IMAGES * (3 if stage == "multitask" else 1)
        row = r["row"]
        info = {"launches": r["launches"], "expected": want, "seconds": r["seconds"],
                "train_img_per_s": images / row["epoch_seconds"],
                "epoch_seconds": row["epoch_seconds"],
                "peak_memory_bytes": r["peak_memory_bytes"], "train_loss": row["train_loss"]}
        out["stages"][stage] = info
        print(f"[cli-chain] {stage}: {r['seconds']:.3f} s wall (fit), train epoch "
              f"{row['epoch_seconds']:.3f} s = {info['train_img_per_s']:.2f} img/s, peak "
              f"{info['peak_memory_bytes'] / 2**30:.2f} GiB; launches {r['launches']} "
              f"(expected {want}); loss {row['train_loss']:.6f}")
        check(r["launches"] == want, f"{stage} launched {r['launches']}, expected {want}")
        check(np.isfinite(row["train_loss"]), f"{stage}: {row}")
        for k in want_all:
            want_all[k] += want[k]
    print(f"[cli-chain] pipeline --with-baselines: {chain_s:.3f} s; launches {launches} "
          f"(expected {want_all})")
    check(launches == want_all, f"the pipeline launched {launches}, expected {want_all}")

    # step 1's initial weights: the file's shared convs, its own per-task slots
    init1 = stages["step1"]["initial"]
    fresh = init_model(stages["step1"]["cfg"]).state_dict()
    shared = [k for k in init1 if k in enc and ".bn" not in k and "num_batches" not in k]
    slots = [k for k in init1 if "bn_ini" in k or "bns_" in k or "parallel_conv" in k]
    bad = [k for k in shared if not torch.equal(init1[k], enc[k])]
    bad += [k for k in slots if not torch.equal(init1[k], fresh[k])]
    print(f"[cli-chain] step 1's initial weights: {len(shared)} shared encoder convs equal to "
          f"the pretrained file's, {len(slots)} per-task slot entries untouched; unequal {bad}")
    check(len(shared) == 110 and slots and not bad, f"step 1's pretrained encoder: {bad[:5]}")

    # the step-2 teacher and student, rebuilt from step1/best on the finished tree
    best = {s: os.path.join(runs, s, "best") for s in CHAIN_STAGES}
    sd1 = torch_io.load_state(best["step1"], "rap")
    cfg2 = stages["step2"]["cfg"]
    tr2 = protocols.build_trainer(dataclasses.replace(cfg2, savedir=os.path.join(root, "s2b")),
                                  device=dev)
    t_sd, s_sd = tr2.teacher.state_dict(), tr2.ts.model.state_dict()
    ext = extend_for_new_task(sd1, cfg2.num_classes[-1],
                              generator=torch.Generator().manual_seed(cfg2.seed))
    t_bad = [k for k in sd1 if not torch.equal(t_sd[k].cpu(), sd1[k])] + sorted(
        set(t_sd) ^ set(sd1))
    s_bad = [k for k in ext if ".1.output_conv." not in k
             and not torch.equal(s_sd[k].cpu(), ext[k])] + sorted(set(s_sd) ^ set(ext))
    s_init = [k for k in s_sd if not torch.equal(s_sd[k].cpu(), stages["step2"]["initial"][k])]
    print(f"[cli-chain] step 2 rebuilt from step1/best: teacher keys unequal to the file "
          f"{len(t_bad)} of {len(sd1)}; student keys unequal to extend_for_new_task (but the "
          f"new output_conv) {len(s_bad)} of {len(ext)}; unequal to the pipeline's initial "
          f"student {len(s_init)}")
    check(not t_bad and not s_bad and not s_init,
          f"step-2 rebuild: teacher {t_bad[:5]}, student {s_bad[:5]}, initial {s_init[:5]}")
    del tr2, t_sd, s_sd

    # frozen parameters across the chain: LR 0 in step t leaves step t-1's values
    frozen = {}
    for prev, cur, task in (("step1", "step2", 1), ("step2", "step3", 2)):
        a, b = torch_io.load_state(best[prev], "rap"), torch_io.load_state(best[cur], "rap")
        model = ERFNetRAP(stages[cur]["cfg"].num_classes, task + 1, device="cpu")
        lr = rap_lr_tree(model, current_task=task, shared_lr=SHARED_LR, ds_lr=DS_LR)
        keys = [k for k, v in lr.items() if v == 0.0]
        moved = [k for k in keys if not torch.equal(a[k], b[k])]
        frozen[cur] = {"frozen": len(keys), "moved": moved}
        print(f"[cli-chain] {cur}/best vs {prev}/best: {len(keys)} parameters at LR 0, "
              f"{len(moved)} moved")
        check(keys and not moved, f"{cur}: frozen parameters moved: {moved[:5]}")
    out["frozen"] = frozen

    # a rerun trains nothing and launches nothing; a lone step 3 needs step 2
    mtimes = {s: os.path.getmtime(os.path.join(best[s], f"{torch_io.latest_epoch(best[s])}.pt"))
              for s in CHAIN_STAGES}
    zero_launch_counts()
    text, rerun_s = run_cli(argv)
    rerun = launch_counts()
    same = all(os.path.getmtime(os.path.join(best[s], "1.pt")) == mtimes[s] for s in CHAIN_STAGES)
    skipped = text.count("found existing")
    print(f"[cli-chain] rerun: {rerun_s:.3f} s, launches {rerun}, stages skipped {skipped}, "
          f"checkpoints untouched {same}")
    check(rerun == {"K1": 0, "K2": 0, "K3": 0} and skipped == len(CHAIN_STAGES) and same,
          f"the rerun launched {rerun}, skipped {skipped}, checkpoints untouched {same}")
    lone = argv[:-4] + ["--stages", "step3", "--savedir", os.path.join(root, "empty"),
                        "--seed", str(seed)]
    try:
        run_cli(lone)
        raised = None
    except ValueError as e:
        raised = str(e)
    print(f"[cli-chain] --stages step3 without step 2: ValueError {raised!r}")
    check(raised is not None and "step2" in raised, "--stages step3 without step 2 did not raise")
    out["rerun"] = {"launches": rerun, "seconds": rerun_s, "skipped": skipped}

    # eval of step3/best and multitask/best; convert --export and eval of the file
    ev = ["--synthetic", "--batch-size", str(TRAIN_BATCH), "--height", str(HEIGHT), "--width",
          str(WIDTH), "--datasets", "cityscapes", "BDD", "IDD"]
    want_eval = {"K1": 3 * CHAIN_EVAL_BATCHES * EVAL_LAUNCHES["K1"], "K2": 0, "K3": 0}
    evals = {}
    for name, extra in (("step3", [best["step3"]]),
                        ("multitask", [best["multitask"], "--kind", "multi_task"]),
                        ("exported", [os.path.join(root, "step3.pth.tar")])):
        if name == "exported":
            run_cli(["convert", best["step3"], extra[0], "--export", "--kind", "rap"])
        zero_launch_counts()
        text, secs = run_cli(["eval", *extra, *ev])
        got = launch_counts()
        miou = json.loads(text.strip().splitlines()[-1])
        evals[name] = {"miou": miou, "launches": got, "seconds": secs}
        print(f"[cli-chain] eval {name}: {miou}; launches {got}; {secs:.3f} s")
        check(got == want_eval, f"eval {name} launched {got}, expected {want_eval}")
    check(evals["exported"]["miou"] == evals["step3"]["miou"],
          f"the exported file's mIoU {evals['exported']['miou']} differs from the "
          f"directory's {evals['step3']['miou']}")
    out["eval"] = evals
    out["root"] = root
    return out


# ---- phase 14: the parity runbook, the analysis tools and serving export ------------------------
EXPORT_TASK = 2  # the newest head (IDD, 27 classes) of step3/best
EXPORTS = {  # name: (export options, batch sizes served)
    "bf16_labels_b1": (["--output", "labels"], (1,)),
    "bf16_labels_sym": (["--output", "labels", "--batch-size", "0"], (1, TRAIN_BATCH)),
    "f32_logits_b1": (["--output", "logits", "--dtype", "float32"], (1,)),
    "f32_logits_sym": (["--output", "logits", "--dtype", "float32", "--batch-size", "0"],
                       (1, TRAIN_BATCH)),
}
TOL_EXPORT_REL_L2 = 1e-6  # an exported float32 program vs the in-process forward: the same ops
TIE_BF16 = 1e-2  # bf16 labels compared off pixels whose top-2 gap is within 1% of the scale
# the chain's checkpoints for parity-check; singletask names its Cityscapes job only, so that
# setting stays missing_checkpoint with the six settings the chain has no run of
PARITY_MANIFEST = {"step1": "runs/step1/best", "step2_CS_BDD": "runs/step2/best",
                   "step3_CS_BDD_IDD": "runs/step3/best", "ft_step2_CS_BDD": "runs/ft_step2/best",
                   "singletask": ["runs/single_cs/best"]}
PARITY_EVAL_IMAGES = 8  # evaluate_checkpoint's synthetic source per domain, batch 1


def tf32_defaults_vs_cpu(seed: int, dev: torch.device) -> dict:
    """C4: the global flags at PyTorch's defaults (TF32 on for cuDNN's fp32
    convs); one step-2 step (make_distill_step) and one eval step at 2x128x256
    on the card and on the CPU from the same weights, masks and batch: loss
    and running statistics within 1e-5, as phase 11 holds them."""
    old = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = True, False
    try:
        n, h, w = SMALL
        student, teacher, images, labels, masks = train_setup(seed + 40, dev, n, h, w)
        s_cpu = ERFNetRAP(STUDENT_CLASSES, len(STUDENT_CLASSES), device="cpu")
        s_cpu.load_state_dict(student.state_dict())
        t_cpu = ERFNetRAP(TEACHER_CLASSES, len(TEACHER_CLASSES), device="cpu")
        t_cpu.load_state_dict(teacher.state_dict())
        out = {}
        for name, (s, t, x, y) in {"card": (student, teacher, images.to(dev), labels.to(dev)),
                                   "cpu": (s_cpu, t_cpu, images, labels)}.items():
            _, step = make_step(s)
            _, m = step(steps.init_train_state(s), t, x, y, masks, 1)
            ev = steps.make_eval_step(task=0, class_weight=CLASS_WEIGHTS["cityscapes"],
                                      num_classes=TEACHER_CLASSES[0])
            eval_loss, _ = ev(t, x, y)
            running = torch.cat([b.reshape(-1).cpu() for k, b in s.named_buffers()
                                 if "running" in k])
            out[name] = (float(m["loss"]), running, float(eval_loss))
        flags = torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = old
    (l_g, r_g, e_g), (l_c, r_c, e_c) = out["card"], out["cpu"]
    rec = {"cudnn_allow_tf32_after": flags, "loss": abs(l_g - l_c) / abs(l_c),
           "running": rel_l2(r_g, r_c), "eval_loss": abs(e_g - e_c) / abs(e_c)}
    print(f"[c4] TF32 at PyTorch's defaults (cudnn.allow_tf32 True): {n}x{h}x{w} step-2 step, "
          f"card vs CPU: loss {rec['loss']:.2e}, running stats {rec['running']:.2e}; eval "
          f"step loss {rec['eval_loss']:.2e}; the flag after the steps: {flags}")
    check(flags and max(rec["loss"], rec["running"], rec["eval_loss"]) <= TOL_STEP["loss"],
          f"with TF32 at its defaults the card's steps differ from the CPU: {rec}")
    return rec


def near_tie_free(labels_a, labels_b, logits) -> tuple[bool, int, int]:
    """(labels equal off the pixels whose top-2 logit gap is within TIE_BF16 of
    the logit scale, pixels that differ, near-tie pixels)."""
    logits = torch.as_tensor(logits).float()
    top2 = logits.topk(2, dim=-1).values
    tie = (top2[..., 0] - top2[..., 1]) <= TIE_BF16 * float(logits.abs().max())
    differ = torch.as_tensor(labels_a) != torch.as_tensor(labels_b)
    return not bool((differ & ~tie.cpu()).any()), int(differ.sum()), int(tie.sum())


def phase_slice10(seed: int, dev: torch.device, chain_root: str) -> dict:
    """Phase 14 on phase 13's checkpoints (build/cli_chain, removed after
    phase 15): the C4 reading, `export` of step3/best and its artifacts served,
    `parity-check --synthetic` on a manifest of the chain's checkpoints, and
    extract_features on the card against the CPU."""
    t_phase = time.perf_counter()
    old = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        rec = {"c4": tf32_defaults_vs_cpu(seed, dev),
               "export": _export_phase(seed, dev, chain_root),
               "parity_check": _parity_phase(dev, chain_root),
               "features": _features_phase(dev, chain_root)}
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = old
    rec["seconds"] = time.perf_counter() - t_phase
    print(f"[slice10] phase 14 in {rec['seconds']:.1f} s")
    return rec


def _export_phase(seed: int, dev: torch.device, root: str) -> dict:
    best = os.path.join(root, "runs", "step3", "best")
    model = load_checkpoint(best, kind="rap", device=dev)
    rng = np.random.default_rng(seed + 50)
    images = rng.integers(0, 256, (TRAIN_BATCH, HEIGHT, WIDTH, 3), np.uint8)
    x = {n: torch.from_numpy(images[:n].astype(np.float32) / 255.0).to(dev)
         for n in (1, TRAIN_BATCH)}
    inproc = {dt: {out: serving.build_infer_fn(model, EXPORT_TASK, output=out,
                                               compute_dtype=DTYPES[dt])
                   for out in ("logits", "labels")} for dt in ("bf16", "f32")}
    rec: dict = {"artifacts": {}, "forward_ms": {}}
    served: dict = {}
    launches = 0
    for name, (opts, batches) in EXPORTS.items():
        out_dir = os.path.join(root, "serving", name)
        text, secs = run_cli(["export", best, out_dir, "--tasks", str(EXPORT_TASK), "--height",
                              str(HEIGHT), "--width", str(WIDTH), *opts])
        meta = json.loads(text.strip().splitlines()[-1])
        art = {"export_seconds": secs,
               "bytes": sum(meta["artifact_bytes"][str(EXPORT_TASK)].values())}
        # the 6 images as 6 batches of 1 (and, symbolic batch, then as one batch of 6) through
        # one serve_batches call, which loads the artifact; K1 launches counted per forward
        groups = [(n, images[i:i + n]) for n in batches for i in range(0, TRAIN_BATCH, n)]
        outs: dict = {n: [] for n in batches}
        t0 = time.perf_counter()
        before = K.LAUNCHES
        for (n, _), got in zip(groups, serving.serve_batches(out_dir, EXPORT_TASK,
                                                             [g for _, g in groups])):
            outs[n].append(got)  # .cpu() in serve_batches waits for the forward
            art.setdefault(f"launches_per_forward_batch{n}", set()).add(K.LAUNCHES - before)
            before = K.LAUNCHES
        art["serve_seconds"] = time.perf_counter() - t0
        for n in batches:
            served[name, n] = np.concatenate(outs[n])
            per_forward = sorted(art[f"launches_per_forward_batch{n}"])
            art[f"launches_per_forward_batch{n}"] = per_forward
            launches += per_forward[0] * len(outs[n])
            check(per_forward == [LAUNCHES_PER_FORWARD],
                  f"{name} at batch {n}: {per_forward} K1 launches per forward, expected "
                  f"{LAUNCHES_PER_FORWARD}")
        rec["artifacts"][name] = art
        print(f"[export] {name}: export {secs:.2f} s, {art['bytes'] / 2**20:.1f} MiB; "
              f"serve_batches (load and {len(groups)} forwards) {art['serve_seconds']:.2f} s; "
              f"K1 launches per forward "
              + ", ".join(f"batch {n}: {art[f'launches_per_forward_batch{n}']}" for n in batches))
    # gates: fp32 logits vs the in-process forward; bf16 labels vs in-process off near-ties;
    # the symbolic batch at 1 and 6
    want32 = inproc["f32"]["logits"](x[TRAIN_BATCH]).cpu()
    logits16 = inproc["bf16"]["logits"](x[TRAIN_BATCH]).cpu()
    want16 = inproc["bf16"]["labels"](x[TRAIN_BATCH]).cpu()
    errs = {k: rel_l2(torch.from_numpy(served[k]), want32)
            for k in (("f32_logits_b1", 1), ("f32_logits_sym", 1), ("f32_logits_sym", TRAIN_BATCH))}
    sym32 = rel_l2(torch.from_numpy(served["f32_logits_sym", TRAIN_BATCH]),
                   torch.from_numpy(served["f32_logits_sym", 1]))
    labels = {k: near_tie_free(served[k], want16, logits16)
              for k in (("bf16_labels_b1", 1), ("bf16_labels_sym", 1),
                        ("bf16_labels_sym", TRAIN_BATCH))}
    sym16 = near_tie_free(served["bf16_labels_sym", TRAIN_BATCH], served["bf16_labels_sym", 1],
                          logits16)
    rec.update(f32_rel_l2={f"{a}@{b}": v for (a, b), v in errs.items()}, f32_sym_1_vs_6=sym32,
               bf16_labels={f"{a}@{b}": v for (a, b), v in labels.items()},
               bf16_sym_1_vs_6=sym16, launches=launches)
    print(f"[export] fp32 logits vs the in-process forward, rel L2: "
          + ", ".join(f"{a} batch {b} {v:.2e}" for (a, b), v in errs.items())
          + f"; the symbolic artifact at batch 6 vs 1: {sym32:.2e}")
    print(f"[export] bf16 labels vs the in-process bf16 labels (equal off near-ties, pixels "
          f"that differ, near-tie pixels): "
          + ", ".join(f"{a} batch {b} {v}" for (a, b), v in labels.items())
          + f"; the symbolic artifact at batch 6 vs 1: {sym16}")
    check(max(errs.values()) <= TOL_EXPORT_REL_L2 and sym32 <= TOL_EXPORT_REL_L2,
          f"exported fp32 logits differ: {errs}, batch 6 vs 1 {sym32}")
    check(all(v[0] for v in labels.values()) and sym16[0],
          f"exported bf16 labels differ off near-ties: {labels}, batch 6 vs 1 {sym16}")
    # per-forward ms, CUDA events after warm-up: the exported and the in-process bf16 forward
    t0 = time.perf_counter()
    fns = {name: serving.load_head(os.path.join(root, "serving", name), EXPORT_TASK)
           for name in ("bf16_labels_b1", "bf16_labels_sym")}
    rec["load_seconds"] = (time.perf_counter() - t0) / len(fns)
    for n in (1, TRAIN_BATCH):
        r = rec["forward_ms"][f"batch{n}"] = {
            "in_process": time_ms(lambda: inproc["bf16"]["labels"](x[n]), iters=10, warmup=2),
            "exported_symbolic": time_ms(lambda: fns["bf16_labels_sym"](x[n]), iters=10,
                                         warmup=2)}
        if n == 1:
            r["exported"] = time_ms(lambda: fns["bf16_labels_b1"](x[n]), iters=10, warmup=2)
        print(f"[export-time] bf16 labels forward {n}x{HEIGHT}x{WIDTH} (head {EXPORT_TASK}), "
              f"CUDA events: in-process {r['in_process']:.3f} ms, exported "
              + (f"{r['exported']:.3f} ms (batch-1 artifact), " if n == 1 else "")
              + f"{r['exported_symbolic']:.3f} ms (symbolic-batch artifact)")
    print(f"[export-time] load_head {rec['load_seconds']:.2f} s per artifact")
    return rec


def _parity_phase(dev: torch.device, root: str) -> dict:
    with open(os.path.join(root, "parity_manifest.json"), "w") as f:
        json.dump(PARITY_MANIFEST, f)
    report_path = os.path.join(root, "parity_report.json")
    zero_launch_counts()
    buf = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            cli.main(["parity-check", root, "--synthetic", "--batch-size", "1", "--height",
                      str(HEIGHT), "--width", str(WIDTH), "--out", report_path])
        code = 0
    except SystemExit as e:
        code = e.code
    secs = time.perf_counter() - t0
    launches = launch_counts()
    with open(report_path) as f:
        report = json.load(f)
    status = {k: v["status"] for k, v in report["settings"].items()}
    mapped = [k for k, v in PARITY_MANIFEST.items() if not isinstance(v, list)]
    heads = sum(len(report["settings"][k]["results"]) for k in mapped)
    want_launches = {"K1": heads * PARITY_EVAL_IMAGES * LAUNCHES_PER_FORWARD, "K2": 0, "K3": 0}
    print(f"[parity-check] exit {code} in {secs:.2f} s; statuses {status}; summary "
          f"{report['summary']}; launches {launches} (expected {want_launches})")
    check(code == 1 and all(status[k] == "fail" for k in mapped)
          and all(v == "missing_checkpoint" for k, v in status.items() if k not in mapped),
          f"parity-check: exit {code}, statuses {status}")
    check(launches == want_launches, f"parity-check launched {launches}, expected {want_launches}")
    # each per-domain mIoU equal to evaluate_checkpoint run directly
    direct = {}
    for setting in mapped:
        (job,) = PARITY_SETTINGS[setting]
        with contextlib.redirect_stdout(io.StringIO()):
            got = evaluate_checkpoint(os.path.join(root, PARITY_MANIFEST[setting]),
                                      kind=job["kind"], datasets=job["datasets"],
                                      synthetic=True, height=HEIGHT, width=WIDTH, device=dev)
        direct[setting] = {d: round(float(v), 4) for d, v in got.items()}
    reported = {k: report["settings"][k]["results"] for k in mapped}
    print(f"[parity-check] per-domain mIoU, the report {reported}; evaluate_checkpoint run "
          f"directly {direct}")
    check(direct == reported, "parity-check's mIoU differ from evaluate_checkpoint's")
    return {"exit": code, "statuses": status, "summary": report["summary"], "seconds": secs,
            "launches": launches, "results": reported}


def _features_phase(dev: torch.device, root: str) -> dict:
    """extract_features (tsne's device half) of step3/best's head 2 on the card
    and on the CPU's plain path, fp32 at 512x1024, relative L2."""
    from mdilss_tpu_torch.analysis.tsne import extract_features

    best = os.path.join(root, "runs", "step3", "best")
    source = SyntheticSource(NUM_CLASSES[EXPORT_TASK], n=1, height=HEIGHT, width=WIDTH)
    kw = dict(task=EXPORT_TASK, num_classes=NUM_CLASSES[EXPORT_TASK], height=HEIGHT,
              width=WIDTH, select=lambda labels, n: True)
    rec = {}
    for which in ("encoder", "penultimate"):
        before = K.LAUNCHES
        got, lbl_g, _ = extract_features(load_checkpoint(best, kind="rap", device=dev), source,
                                         which=which, device=dev, **kw)
        launched = K.LAUNCHES - before
        want, lbl_c, _ = extract_features(load_checkpoint(best, kind="rap", device="cpu"),
                                          source, which=which, device="cpu", **kw)
        err = rel_l2(torch.from_numpy(got), torch.from_numpy(want))
        rec[which] = {"shape": list(got.shape), "rel_l2": err, "launches": launched}
        print(f"[features] {which} {list(got.shape)}: card vs CPU rel L2 {err:.2e}; "
              f"K1 launches {launched}")
        check(err <= TOL_STEP3 and np.array_equal(lbl_g, lbl_c)
              and launched == LAUNCHES_PER_FORWARD, f"extract_features {which}: {rec[which]}")
    return rec


# ---- phase 15: the ablation models ------------------------------------------------------------
# the four ablation models (models/erfnet_ablations.py) at the step protocols' settings: their
# encoder blocks are plain PyTorch (cuDNN), so the kernels run in the 4 nb1d blocks of each decoder
ABLATION_MODELS = tuple(REFERENCE_NAMES)
DECODER_NB = sum(1 for spec in DECODER_PLAN if spec[0] == "nb")  # 4
ABL_FWD = DECODER_NB * K.LAUNCHES_PER_BLOCK  # K1 per eval forward, K2 per training forward: 8
ABL_EVAL_LAUNCHES = {"K1": ABL_FWD, "K2": 0, "K3": 0}
ABL_CE_LAUNCHES = {"K1": 0, "K2": ABL_FWD, "K3": ABL_FWD}  # one student forward and backward
# step 2: 2 student forwards and backwards, the eval-mode teacher's forward
ABL_STEP_LAUNCHES = {"K1": ABL_FWD, "K2": 2 * ABL_FWD, "K3": 2 * ABL_FWD}
# step 3 (two-phase, train-mode teacher): 3 student forwards and backwards, 2 teacher forwards
ABL_STEP3_LAUNCHES = {"K1": 0, "K2": 5 * ABL_FWD, "K3": 3 * ABL_FWD}
ABL_IMAGES = TRAIN_BATCH  # per domain and subset: one train and one validation batch per stage
# per stage: launches per train step, and the domains validated at epoch 1 (step 2 every old
# one too, eval_old_every 1; step 3 the current one only, eval_old_every 10)
ABL_CHAIN = {"step1": (ABL_CE_LAUNCHES, 1), "step2": (ABL_STEP_LAUNCHES, 2),
             "step3": (ABL_STEP3_LAUNCHES, 1)}
ABL_EXPORT_MODEL = "erfnet_RCM"


def ablation_model(name: str, classes, seed: int, dev) -> ERFNetAblation:
    """An ablation model with torch's initialisation from `seed`, random BN and,
    for RCM, random non-symmetric matrices Wt = I + N(0, 0.3^2 / C) (its
    identity init would hide a transposed Wt)."""
    torch.manual_seed(seed)
    model = ERFNetAblation(classes, len(classes), REFERENCE_NAMES[name], device="cpu")
    gen = torch.Generator().manual_seed(seed + 1)
    randomize_bn(model, gen)
    with torch.no_grad():
        for k, p in model.named_parameters():
            if ".Wt_" in k:
                c = p.shape[0]
                p.copy_(torch.eye(c) + 0.3 / c ** 0.5 * torch.randn(c, c, generator=gen))
    return model.to(dev)


def ablation_setup(name: str, seed: int, dev, n: int, h: int, w: int, step3: bool = False):
    """Student and teacher of step 2 ([20, 20] / [20]) or step 3 ([20, 20, 27] /
    [20, 20]), a batch of random images and labels, the student forwards' masks,
    and the step (eval-mode teacher for step 2, the two-phase step with the
    train-mode teacher for step 3)."""
    s_nc, t_nc = (STEP3_STUDENT, STEP3_TEACHER) if step3 else (STUDENT_CLASSES, TEACHER_CLASSES)
    cur, prev = (STEP3_CURRENT, STEP3_PREV) if step3 else (CURRENT_TASK, PREV_TASKS)
    student = ablation_model(name, s_nc, seed, dev)
    teacher = ablation_model(name, t_nc, seed + 2, dev)
    rng = np.random.default_rng(seed)
    images = torch.from_numpy(rng.random((n, h, w, 3), dtype=np.float32))
    labels = torch.from_numpy(rng.integers(0, s_nc[cur], (n, h, w)))
    masks = [make_dropout_masks(rng, n) for _ in range(1 + len(prev))]
    lr = ablation_lr_tree(student, variant=REFERENCE_NAMES[name], current_task=cur,
                          shared_lr=SHARED_LR, ds_lr=DS_LR)
    kw = dict(current_task=cur, prev_tasks=prev, lr_tree=lr, num_epochs=NUM_EPOCHS,
              lambda_c=LAMBDA_C)
    step = (steps.make_two_phase_distill_step(class_weight=CLASS_WEIGHTS["IDD"], **kw) if step3
            else steps.make_distill_step(class_weight=CLASS_WEIGHTS["BDD"], **kw))
    return student, teacher, images, labels, masks, step


def ablation_vs_cpu(name: str, seed: int, dev: torch.device) -> dict:
    """One step-2 step and one eval forward of head 1 at 2x128x256 on the card
    and on the CPU from the same weights, masks and batch, the global TF32 flags
    at PyTorch's defaults (the steps and forwards turn TF32 off themselves, C4):
    loss, ce, kld, the eval logits and the student's running statistics."""
    old = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = True, False
    try:
        n, h, w = SMALL
        student, teacher, images, labels, masks, step = ablation_setup(name, seed, "cpu", n, h, w)
        s_state, t_state = state_copy(student), state_copy(teacher)
        out = {}
        for where, d in (("card", dev), ("cpu", torch.device("cpu"))):
            s, t = copy.deepcopy(student).to(d), copy.deepcopy(teacher).to(d)
            s.load_state_dict(s_state)
            t.load_state_dict(t_state)
            x, y = images.to(d), labels.to(d)
            with no_tf32():
                logits = s(x, CURRENT_TASK).cpu()
            _, m = step(steps.init_train_state(s), t, x, y, masks, 1)
            running = torch.cat([b.reshape(-1).cpu() for k, b in s.named_buffers()
                                 if "running" in k])
            out[where] = ({k: float(v) for k, v in m.items()}, logits, running)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = old
    (m_g, l_g, r_g), (m_c, l_c, r_c) = out["card"], out["cpu"]
    rec = {**{k: abs(m_g[k] - m_c[k]) / abs(m_c[k]) for k in ("loss", "ce", "kld")},
           "logits": rel_l2(l_g, l_c), "running": rel_l2(r_g, r_c), "card": m_g, "cpu": m_c}
    print(f"[ablation-cpu] {name} {n}x{h}x{w} step-2 step, card vs CPU (TF32 flags at their "
          f"defaults): loss {rec['loss']:.2e}, ce {rec['ce']:.2e}, kld {rec['kld']:.2e}, running "
          f"stats {rec['running']:.2e}; eval logits {rec['logits']:.2e}")
    check(max(rec[k] for k in ("loss", "ce", "kld", "logits", "running")) <= TOL_STEP3,
          f"{name}: card vs CPU above {TOL_STEP3}: {rec}")
    return rec


def ablation_frozen(name: str, prev_best: str, best: str, cfg_seed: int, classes) -> dict:
    """Step t's best against step t-1's: every LR-0 parameter (the old tasks'
    slices and heads) bitwise unchanged; every parameter of the current task
    (its slices and head) moved from its initial value (`extend_for_new_task` of
    step t-1's checkpoint, the protocol's init); onlyrap's shared BN moved."""
    task = len(classes) - 1
    a = keep_tasks(torch_io.load_state(prev_best, name), task)
    b = torch_io.load_state(best, name)
    init = extend_for_new_task(a, classes[-1], generator=torch.Generator().manual_seed(cfg_seed))
    model = ERFNetAblation(classes, len(classes), REFERENCE_NAMES[name], device="cpu")
    lr = ablation_lr_tree(model, variant=REFERENCE_NAMES[name], current_task=task,
                          shared_lr=SHARED_LR, ds_lr=DS_LR)
    frozen = [k for k, v in lr.items() if v == 0.0]
    current = [k for k, v in lr.items() if v == DS_LR]
    shared_bn = [k for k in lr if re.search(r"\.(bn|bn1|bn2)\.(weight|bias)$", k)
                 and k.startswith("encoder.")]
    rec = {"frozen": len(frozen), "current": len(current), "shared_bn": len(shared_bn),
           "frozen_moved": [k for k in frozen if not torch.equal(a[k], b[k])],
           "current_unmoved": [k for k in current if torch.equal(init[k], b[k])],
           "shared_bn_unmoved": [k for k in shared_bn if torch.equal(a[k], b[k])]}
    print(f"[ablation-chain] {name} step {task + 1}/best vs step {task}/best: {len(frozen)} "
          f"parameters at LR 0, {len(rec['frozen_moved'])} moved; {len(current)} of the current "
          f"task, {len(rec['current_unmoved'])} unmoved; {len(shared_bn)} of the shared BN, "
          f"{len(rec['shared_bn_unmoved'])} unmoved")
    check(frozen and current and not rec["frozen_moved"] and not rec["current_unmoved"]
          and not rec["shared_bn_unmoved"]
          and bool(shared_bn) == (REFERENCE_NAMES[name] == "onlyrap"),
          f"{name} step {task + 1}: frozen / current / shared BN gates: {rec}")
    return rec


def ablation_chain(name: str, seed: int, root: str, enc_path: str) -> dict:
    """step1 (the pretrained encoder) -> step2 -> step3 of `name` through
    cli.main, one epoch of one batch per stage; exact launches per stage."""
    common = ["--model", name, "--synthetic", "--synthetic-size", str(ABL_IMAGES),
              "--num-epochs", "1", "--batch-size", str(TRAIN_BATCH), "--height", str(HEIGHT),
              "--width", str(WIDTH), "--seed", str(seed)]
    best = {s: os.path.join(root, name, s, "best") for s in ABL_CHAIN}
    stages = {}
    for stage, prev in (("step1", None), ("step2", "step1"), ("step3", "step2")):
        argv = [stage, "--savedir", os.path.dirname(best[stage]), *common]
        argv += ["--pretrained-encoder", enc_path] if prev is None else ["--state", best[prev]]
        per_step, n_val = ABL_CHAIN[stage]
        want = {k: v + n_val * ABL_EVAL_LAUNCHES[k] for k, v in per_step.items()}
        zero_launch_counts()
        text, secs = run_cli(argv)
        got = launch_counts()
        row = json.loads(text.strip().splitlines()[-1])
        stages[stage] = {"launches": got, "expected": want, "seconds": secs,
                         "train_loss": row["train_loss"], "epoch_seconds": row["epoch_seconds"]}
        print(f"[ablation-chain] {name} {stage}: {secs:.3f} s; launches {got} (expected {want}); "
              f"loss {row['train_loss']:.6f}")
        check(got == want, f"{name} {stage} launched {got}, expected {want}")
        check(np.isfinite(row["train_loss"]), f"{name} {stage}: {row}")
    stages["frozen"] = {
        "step2": ablation_frozen(name, best["step1"], best["step2"], seed, STUDENT_CLASSES),
        "step3": ablation_frozen(name, best["step2"], best["step3"], seed, STEP3_STUDENT)}
    return stages


def ablation_eval_export(dev: torch.device, best: str, root: str) -> dict:
    """`eval --kind erfnet_RCM` of step3/best (3 heads, 8 synthetic images
    each in batches of 6) and `export` of its head 2 (fp32 logits, batch 1)
    served over 2 images: exactly ABL_FWD K1 launches per forward, the logits
    within TOL_EXPORT_REL_L2 of the in-process forward."""
    name = ABL_EXPORT_MODEL
    zero_launch_counts()
    text, secs = run_cli(["eval", best, "--kind", name, "--synthetic", "--batch-size",
                          str(TRAIN_BATCH), "--height", str(HEIGHT), "--width", str(WIDTH),
                          "--datasets", "cityscapes", "BDD", "IDD"])
    got = launch_counts()
    miou = json.loads(text.strip().splitlines()[-1])
    want = {"K1": 3 * CHAIN_EVAL_BATCHES * ABL_FWD, "K2": 0, "K3": 0}
    print(f"[ablation-eval] eval --kind {name}: {miou}; launches {got} (expected {want}); "
          f"{secs:.3f} s")
    check(got == want and all(0.0 <= v <= 1.0 for v in miou.values()),
          f"eval --kind {name}: {miou}, launched {got}, expected {want}")
    out_dir = os.path.join(root, "serving")
    text, export_s = run_cli(["export", best, out_dir, "--kind", name, "--tasks",
                              str(EXPORT_TASK), "--output", "logits", "--dtype", "float32",
                              "--height", str(HEIGHT), "--width", str(WIDTH)])
    images = np.random.default_rng(7).integers(0, 256, (2, 1, HEIGHT, WIDTH, 3), np.uint8)
    served, per_forward = [], []
    before = K.LAUNCHES
    for out in serving.serve_batches(out_dir, EXPORT_TASK, list(images)):
        served.append(out)
        per_forward.append(K.LAUNCHES - before)
        before = K.LAUNCHES
    fn = serving.build_infer_fn(load_checkpoint(best, kind=name, device=dev), EXPORT_TASK,
                                compute_dtype=torch.float32)
    want_logits = np.concatenate(list(serving.serve_fn_batches(fn, list(images), HEIGHT, WIDTH)))
    err = rel_l2(torch.from_numpy(np.concatenate(served)), torch.from_numpy(want_logits))
    print(f"[ablation-export] export --kind {name} head {EXPORT_TASK}: {export_s:.2f} s; K1 "
          f"launches per served forward {per_forward}; fp32 logits vs the in-process forward "
          f"rel L2 {err:.2e}")
    check(per_forward == [ABL_FWD] * len(images) and err <= TOL_EXPORT_REL_L2,
          f"export --kind {name}: launches per forward {per_forward}, rel L2 {err}")
    return {"eval": {"miou": miou, "launches": got, "seconds": secs},
            "export": {"seconds": export_s, "launches_per_forward": per_forward,
                       "rel_l2": err, "launches": sum(per_forward)}}


def ablation_times(name: str, seed: int, dev: torch.device) -> dict:
    """A step-2 step and a step-3 batch at 6x512x1024: ms (CUDA events over 3
    after one warm-up, launches exact for each), peak memory, one profiled
    call (device busy, idle share, K1/K2/K3 ms) and ms_by_family: of the
    step-2 step of every model, of the step-3 batch of ABL_EXPORT_MODEL only
    (a profile with Python stacks costs ~8 s of host time per step-3 batch,
    and the variants' step-3 families differ as their step-2 ones do)."""
    rec = {}
    for kind, step3, want in (("step2", False, ABL_STEP_LAUNCHES),
                              ("step3", True, ABL_STEP3_LAUNCHES)):
        student, teacher, images, labels, masks, step = ablation_setup(
            name, seed, dev, TRAIN_BATCH, HEIGHT, WIDTH, step3=step3)
        images, labels = images.to(dev), labels.to(dev)
        state = {"ts": steps.init_train_state(student)}

        def one():
            state["ts"], _ = step(state["ts"], teacher, images, labels, masks, 1)

        sync(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        zero_launch_counts()
        ms = time_ms(one, iters=3, warmup=1)
        got = launch_counts()
        r = rec[kind] = {"ms": ms, "img_per_s": TRAIN_BATCH * 1e3 / ms, "launches": got,
                         "peak_memory_bytes": torch.cuda.max_memory_allocated(dev)}
        print(f"[ablation-time] {name} {kind} {TRAIN_BATCH}x{HEIGHT}x{WIDTH} f32: {ms:.3f} ms, "
              f"{r['img_per_s']:.2f} img/s, peak {r['peak_memory_bytes'] / 2**30:.2f} GiB; "
              f"launches over 4 calls {got}")
        check(got == {k: 4 * v for k, v in want.items()},
              f"{name} {kind}: 4 calls launched {got}, expected 4 x {want}")
        r["profile"] = profile_once(one, "ablation-profile", f"{name} {kind}")
        if kind == "step2" or name == ABL_EXPORT_MODEL:
            r["profile"].update(family_split(one, "ablation-profile", f"{name} {kind}"))
        del student, teacher, state
    return rec


def phase_ablations(seed: int, dev: torch.device, chain_root: str) -> dict:
    """Phase 15: the four ablation models, card vs CPU, their step chain
    through the CLI on phase 13's pretrained-encoder file, eval and export of
    erfnet_RCM, and their step timings; phase 13's tree is removed at the end."""
    t_phase = time.perf_counter()
    root = os.path.join(chain_root, "ablations")
    enc_path = os.path.join(chain_root, "encoder.pth.tar")
    rec: dict = {"vs_cpu": {}, "chain": {}, "times": {}, "part_seconds": {}}
    t_part = time.perf_counter()

    def part(name: str) -> None:
        nonlocal t_part
        rec["part_seconds"][name] = time.perf_counter() - t_part
        t_part = time.perf_counter()

    try:
        for i, name in enumerate(ABLATION_MODELS):
            rec["vs_cpu"][name] = ablation_vs_cpu(name, seed + 60 + i, dev)
        part("vs_cpu")
        launches = {"K1": 0, "K2": 0, "K3": 0}
        for name in ABLATION_MODELS:
            rec["chain"][name] = ablation_chain(name, seed, root, enc_path)
            for stage in ABL_CHAIN:
                for k, v in rec["chain"][name][stage]["launches"].items():
                    launches[k] += v
        rec["chain_launches"] = launches
        part("chain")
        rec.update(ablation_eval_export(
            dev, os.path.join(root, ABL_EXPORT_MODEL, "step3", "best"), root))
        part("eval_export")
        for i, name in enumerate(ABLATION_MODELS):
            rec["times"][name] = ablation_times(name, seed + 70 + i, dev)
        part("times")
    finally:
        shutil.rmtree(chain_root, ignore_errors=True)
    rec["step_launches"] = {k: sum(t[kind]["launches"][k] for t in rec["times"].values()
                                   for kind in ("step2", "step3")) for k in ("K1", "K2", "K3")}
    rec["seconds"] = time.perf_counter() - t_phase
    print(f"[ablations] phase 15 in {rec['seconds']:.1f} s ("
          + ", ".join(f"{k} {v:.1f} s" for k, v in rec["part_seconds"].items()) + ")")
    return rec


# ---- phase 16: bf16 training ---------------------------------------------------------------------
# K2 / K3 in bfloat16 (csrc/nb1d_train.cu: fwd_pair_bf16_kernel, bwd_dc/du/wgrad_bf16_kernel) and
# compute_dtype="bfloat16" through the steps, the Trainer and the CLI, at trainer_OURS.sh's
# settings. The gates below were fixed before the first run of this phase.
BF16 = torch.bfloat16
# K2/K3 bf16 vs their plain bf16 versions (float32 arithmetic on the bf16 values, rounded to bf16
# at the kernels' points), relative L2 per output: the two sum in different orders, so now and
# then an element rounds to its other bf16 neighbour (an ulp is 2^-8 relative) or a relu within
# float32 rounding of its kink flips
TOL_BF16_PAIR = 1e-2
# the bf16 training block on the kernels, its error against float64 (the block from the plain
# pairs in float64) at most this factor times the error of the same bf16 block built from the
# plain pairs, plus the float32 floor: both round at the same points
BF16_BLOCK_FACTOR, BF16_BLOCK_FLOOR = 1.5, 1e-5
# the bf16 step's loss, ce and kld against the fp32 step's on the same weights, batch and masks,
# relative
TOL_BF16_VS_FP32 = 1e-2
# one bf16 step-2 step at 2x128x256, the card (kernels) vs the CPU (plain pairs): losses and
# running statistics, relative
TOL_BF16_CPU = {"loss": 2e-2, "running": 1e-2}
BF16_CHAIN = {"step1": (CE_LAUNCHES, 1), "step2": (STEP_LAUNCHES, 2), "step3": (STEP3_LAUNCHES, 1)}
BF16_CHAIN_CLASSES = {"step1": [20], "step2": STUDENT_CLASSES, "step3": STEP3_STUDENT}
BF16_CHAIN_DATASETS = {"step1": ["cityscapes"], "step2": ["cityscapes", "BDD"],
                       "step3": ["cityscapes", "BDD", "IDD"]}


def bf16_exact(t: torch.Tensor | None) -> torch.Tensor | None:
    """t rounded to values bf16 represents (float32), so the kernel, its plain
    version and the float64 reference see the same numbers."""
    return None if t is None else t.to(BF16).float()


def bf16_pair_cases(seed: int, dev: torch.device) -> list[dict]:
    """K2/K3 bf16 at the 7 block shapes at batch 6 and the ragged one, RAP and
    pre-stage each on and off: each output against the plain bf16 version
    (gate TOL_BF16_PAIR) and against float64 (reported); two runs bitwise
    equal; the output types."""
    cases = []
    for i, spec in enumerate(BLOCKS + (RAGGED,)):
        name, c, d, _, h, w, _ = spec
        for rap in (False, True):
            for pre in (False, True):
                gen = torch.Generator().manual_seed(seed + 300 + 100 * i + 2 * rap + pre)
                w31, b31, w13, rapw, pre_ab = pair_args(gen, c, rap, pre, dev)
                w31, w13, rapw = bf16_exact(w31), bf16_exact(w13), bf16_exact(rapw)
                x = cl(torch.randn(TRAIN_BATCH, c, h, w, generator=gen).to(dev, BF16))
                gy = cl(torch.randn(TRAIN_BATCH, c, h, w, generator=gen).to(dev, BF16))
                args = (w31, b31, w13, rapw, pre_ab, d)
                got = [*T.fwd_pair(x, *args), *T.bwd_pair(x, gy, *args)]
                again = [*T.fwd_pair(x, *args), *T.bwd_pair(x, gy, *args)]
                sync(dev)
                bitwise = all(torch.equal(a, b) for a, b in zip(got, again) if a is not None)
                del again
                names = ("y", "stats", "du", "dw31", "db31", "dw13", "drap")
                got = dict(zip(names, got))
                plain = dict(zip(names, [*T.fwd_pair_plain(x, *args),
                                         *T.bwd_pair_plain(x, gy, *args)]))
                a64 = (*(as_f64(t) for t in args[:5]), d)
                want = dict(zip(names, [*T.fwd_pair_plain(x.double(), *a64),
                                        *T.bwd_pair_plain(x.double(), gy.double(), *a64)]))
                keys = [k for k in names if want[k] is not None]
                vs_plain = {k: rel_l2(got[k], plain[k]) for k in keys}
                vs_f64 = {k: rel_l2(got[k], want[k]) for k in keys}
                plain_f64 = {k: rel_l2(plain[k], want[k]) for k in keys}
                types = (got["y"].dtype == got["du"].dtype == BF16
                         and all(got[k].dtype == torch.float32 for k in keys
                                 if k not in ("y", "du")))
                case = {"block": name, "shape": [TRAIN_BATCH, h, w, c], "dilation": d,
                        "rap": rap, "pre": pre, "rel_l2_vs_plain": vs_plain,
                        "rel_l2_vs_f64": vs_f64, "plain_rel_l2_vs_f64": plain_f64,
                        "max_abs_err_vs_plain": {k: float((got[k].double() - plain[k].double())
                                                          .abs().max()) for k in keys},
                        "bitwise": bitwise, "types": types,
                        "finite": all(bool(torch.isfinite(got[k]).all()) for k in keys)}
                case["ok"] = (case["finite"] and bitwise and types
                              and all(v <= TOL_BF16_PAIR for v in vs_plain.values()))
                cases.append(case)
                worst = max(vs_plain, key=vs_plain.get)
                print(f"[bf16-kernel] {name} [{TRAIN_BATCH},{h},{w},{c}] d={d} rap={int(rap)} "
                      f"pre={int(pre)}: worst rel_l2 vs plain bf16 {vs_plain[worst]:.2e} ({worst}, "
                      f"gate {TOL_BF16_PAIR:.0e}); vs float64 kernel "
                      f"{max(vs_f64.values()):.2e}, plain {max(plain_f64.values()):.2e}; bitwise "
                      f"repeat {bitwise}")
                del got, plain, want
    bad = [c for c in cases if not c["ok"]]
    check(not bad, f"K2/K3 bf16 above rel_l2 {TOL_BF16_PAIR} vs their plain bf16 versions, not "
                   f"bitwise repeatable, or of the wrong type: {bad}")
    return cases


def bf16_block(seed: int, dev: torch.device) -> list[dict]:
    """The bf16 training block at the 7 block shapes at batch 6: on the kernels
    and built from the plain pairs, each against the block from the plain
    pairs in float64 (the same bf16 input): output, dx, every parameter's
    gradient (one vector), running statistics. Gate: kernel error <=
    BF16_BLOCK_FACTOR x plain error + BF16_BLOCK_FLOOR, each."""
    rows = []
    for i, spec in enumerate(BLOCKS):
        name, c, d, rap, h, w, _ = spec
        torch.manual_seed(seed + 400 + 10 * i)
        drop = (0.3 if c == 128 else 0.03) if rap else 0.0
        blk = NonBottleneck1dRAP(c, d, 2, drop) if rap else NonBottleneck1d(c, d)
        randomize_bn(blk, torch.Generator().manual_seed(seed + 401 + 10 * i))
        gen = torch.Generator().manual_seed(seed + 402 + 10 * i)
        x = cl(torch.randn(TRAIN_BATCH, c, h, w, generator=gen).to(dev, BF16))
        cot = torch.randn(TRAIN_BATCH, c, h, w, generator=gen).to(dev)
        mask = (torch.rand(TRAIN_BATCH, c, generator=gen) < 1 - drop).to(dev) if rap else None
        res = {}
        for run, dt, pairs in (("kernel", BF16, T.KERNEL_PAIRS), ("plain", BF16, T.PLAIN_PAIRS),
                               ("f64", torch.float64, T.PLAIN_PAIRS)):
            b = copy.deepcopy(blk).to(dev).train()
            if dt == torch.float64:
                b = b.double()
            acc = torch.float64 if dt == torch.float64 else torch.float32
            xi = x.to(dt).requires_grad_()
            out = T.nb1d_train_apply(b, xi, 1 if rap else None, drop, mask, pairs)
            grads = torch.autograd.grad((out.to(acc) * cot.to(acc)).sum(),
                                        [xi] + list(b.parameters()), allow_unused=True)
            flat = torch.cat([(torch.zeros_like(p) if g is None else g).reshape(-1).double()
                              for g, p in zip(grads[1:], b.parameters())])
            running = torch.cat([t.reshape(-1).double() for n_, t in b.named_buffers()
                                 if "running" in n_])
            res[run] = {"out": out.detach(), "dx": grads[0], "dparams": flat, "running": running,
                        "out_dtype": out.dtype}
            del b, grads
        sync(dev)
        row = {"block": name, "shape": [TRAIN_BATCH, h, w, c],
               "out_bf16": res["kernel"]["out_dtype"] == BF16}
        for k in ("out", "dx", "dparams", "running"):
            e_k = rel_l2(res["kernel"][k], res["f64"][k])
            e_p = rel_l2(res["plain"][k], res["f64"][k])
            row[k] = {"kernel_vs_f64": e_k, "plain_vs_f64": e_p,
                      "gate": BF16_BLOCK_FACTOR * e_p + BF16_BLOCK_FLOOR}
        row["ok"] = row["out_bf16"] and all(row[k]["kernel_vs_f64"] <= row[k]["gate"]
                                            for k in ("out", "dx", "dparams", "running"))
        rows.append(row)
        print(f"[bf16-block] {name} [{TRAIN_BATCH},{h},{w},{c}] vs float64, kernel / plain bf16 "
              f"(gate): " + ", ".join(f"{k} {row[k]['kernel_vs_f64']:.2e} / "
                                      f"{row[k]['plain_vs_f64']:.2e} ({row[k]['gate']:.2e})"
                                      for k in ("out", "dx", "dparams", "running")))
        del res
    bad = [r for r in rows if not r["ok"]]
    check(not bad, f"the bf16 training block on the kernels above {BF16_BLOCK_FACTOR} x the plain "
                   f"block's error vs float64 (+{BF16_BLOCK_FLOOR}): {bad}")
    return rows


def bf16_path(setup, make, want: dict, n_steps: int, tag: str, seed: int, dev) -> dict:
    """`n_steps` bf16 steps (make(student, "bfloat16")) at 6x512x1024 from
    setup(seed, dev, ...)'s weights, batch and masks, the counts zeroed just
    before: every step exactly `want` launches, all bf16 (no fp32 launch of
    K1/K2/K3); the first step's losses against the fp32 step's from the same
    weights (TOL_BF16_VS_FP32); the frozen student parameters and the teacher
    bitwise unchanged; then ms (CUDA events), peak memory, one profiled step
    (busy, idle share) and ms_by_family."""
    student, teacher, images, labels, masks = setup(seed, dev, TRAIN_BATCH, HEIGHT, WIDTH)
    images, labels = images.to(dev), labels.to(dev)
    s_state, t_state = state_copy(student), state_copy(teacher)
    _, step32 = make(student)
    _, m32 = step32(steps.init_train_state(student), teacher, images, labels, masks, 1)
    ref = {k: float(v) for k, v in m32.items() if k != "cm"}
    del step32, m32
    student.load_state_dict(s_state)
    teacher.load_state_dict(t_state)
    lr, step = make(student, "bfloat16")
    frozen = {k: p.detach().clone() for k, p in student.named_parameters() if lr[k] == 0.0}
    ts = steps.init_train_state(student)
    sync(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    rec = {"steps": [], "fp32_losses": ref}
    zero_launch_counts()
    for i in range(n_steps):
        before, before16 = launch_counts(), bf16_launch_counts()
        t0 = time.perf_counter()
        ts, m = step(ts, teacher, images, labels, masks, 1)
        vals = {k: float(v) for k, v in m.items() if k != "cm"}
        secs = time.perf_counter() - t0
        got16 = {k: v - before16[k] for k, v in bf16_launch_counts().items()}
        got32 = {k: v - before[k] - got16[k] for k, v in launch_counts().items()}
        rec["steps"].append({**vals, "launches_bf16": got16, "launches_fp32": got32,
                             "seconds": secs, "dtypes": {k: str(v.dtype) for k, v in m.items()}})
        print(f"[bf16-{tag}] step {i + 1}: loss {vals['loss']:.6f} ce {vals['ce']:.6f} kld "
              f"{vals['kld']:.6f}; bf16 launches {got16}, fp32 {got32}; {secs:.3f} s")
        check(all(np.isfinite(v) for v in vals.values()), f"bf16 {tag}: non-finite {vals}")
        check(got16 == want and not any(got32.values()),
              f"bf16 {tag} step launched bf16 {got16} and fp32 {got32}, expected bf16 {want}")
    first = rec["steps"][0]
    rec["vs_fp32"] = {k: abs(first[k] - ref[k]) / abs(ref[k]) for k in ("loss", "ce", "kld")}
    params = dict(student.named_parameters())
    rec["frozen_moved"] = [k for k, p in frozen.items() if not torch.equal(params[k], p)]
    rec["teacher_changed"] = changed(teacher, {k: v.to(dev) for k, v in t_state.items()})
    rec["peak_memory_bytes"] = torch.cuda.max_memory_allocated(dev)
    print(f"[bf16-{tag}] step 1 vs the fp32 step on the same weights, relative: "
          + ", ".join(f"{k} {v:.2e}" for k, v in rec["vs_fp32"].items())
          + f" (gate {TOL_BF16_VS_FP32:.0e}); {len(frozen)} frozen student parameters, "
          f"{len(rec['frozen_moved'])} moved; teacher changed: {rec['teacher_changed'][:3]}; "
          f"peak {rec['peak_memory_bytes'] / 2**30:.2f} GiB")
    check(all(v <= TOL_BF16_VS_FP32 for v in rec["vs_fp32"].values()),
          f"bf16 {tag}: losses vs fp32 above {TOL_BF16_VS_FP32}: {rec['vs_fp32']}")
    check(frozen and not rec["frozen_moved"] and not rec["teacher_changed"],
          f"bf16 {tag}: frozen parameters moved {rec['frozen_moved'][:5]} or the teacher "
          f"changed {rec['teacher_changed'][:5]}")
    state = {"ts": ts}

    def one():
        state["ts"], _ = step(state["ts"], teacher, images, labels, masks, 1)

    rec["ms"] = time_ms(one, iters=3, warmup=1)
    rec["img_per_s"] = TRAIN_BATCH * 1e3 / rec["ms"]
    print(f"[bf16-{tag}] {TRAIN_BATCH}x{HEIGHT}x{WIDTH} bf16: {rec['ms']:.3f} ms, "
          f"{rec['img_per_s']:.2f} img/s")
    rec["profile"] = profile_once(one, f"bf16-{tag}-profile", f"one bf16 {tag} call")
    rec["profile"].update(family_split(one, f"bf16-{tag}-profile", f"bf16 {tag} call"))
    rec["launches_bf16"] = {k: sum(r["launches_bf16"][k] for r in rec["steps"])
                            for k in ("K1", "K2", "K3")}
    return rec


def bf16_vs_cpu(seed: int, dev: torch.device) -> dict:
    """One bf16 step-2 step at 2x128x256 on the card (kernels) and on the CPU
    (plain pairs) from the same weights, masks and batch: loss, ce, kld and
    the student's running statistics (TOL_BF16_CPU)."""
    n, h, w = SMALL
    student, teacher, images, labels, masks = train_setup(seed, "cpu", n, h, w)
    out = {}
    for where, d in (("card", dev), ("cpu", torch.device("cpu"))):
        s, t = copy.deepcopy(student).to(d), copy.deepcopy(teacher).to(d)
        _, step = make_step(s, "bfloat16")
        _, m = step(steps.init_train_state(s), t, images.to(d), labels.to(d), masks, 1)
        out[where] = ({k: float(v) for k, v in m.items()},
                      torch.cat([b.reshape(-1).cpu() for k, b in s.named_buffers()
                                 if "running" in k]))
    (m_g, r_g), (m_c, r_c) = out["card"], out["cpu"]
    rec = {**{k: abs(m_g[k] - m_c[k]) / abs(m_c[k]) for k in ("loss", "ce", "kld")},
           "running": rel_l2(r_g, r_c), "card": m_g, "cpu": m_c}
    print(f"[bf16-cpu] {n}x{h}x{w} bf16 step-2 step, card vs CPU: loss {rec['loss']:.2e}, ce "
          f"{rec['ce']:.2e}, kld {rec['kld']:.2e}, running stats {rec['running']:.2e} (gates "
          f"{TOL_BF16_CPU})")
    check(max(rec[k] for k in ("loss", "ce", "kld")) <= TOL_BF16_CPU["loss"]
          and rec["running"] <= TOL_BF16_CPU["running"], f"bf16 card vs CPU: {rec}")
    return rec


def bf16_cli_chain(seed: int, dev: torch.device) -> dict:
    """step1 -> step2 -> step3 --dtype bfloat16 through cli.main at 6x512x1024
    (6 synthetic images per domain and subset, one epoch): each stage's
    launches exactly its train step's plus 34 K1 per validation batch, all
    bf16; every LR-0 parameter of step 2 (step 3) bitwise as in step1/best
    (step2/best); `eval` (float32) of each best: 34 fp32 K1 per batch per head."""
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "bf16_chain")
    shutil.rmtree(root, ignore_errors=True)
    common = ["--synthetic", "--synthetic-size", str(TRAIN_BATCH), "--num-epochs", "1",
              "--batch-size", str(TRAIN_BATCH), "--height", str(HEIGHT), "--width",
              str(WIDTH), "--seed", str(seed), "--dtype", "bfloat16"]
    best = {s: os.path.join(root, s, "best") for s in BF16_CHAIN}
    rec: dict = {}
    old = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        for stage, prev in (("step1", None), ("step2", "step1"), ("step3", "step2")):
            argv = [stage, "--savedir", os.path.dirname(best[stage]), *common]
            argv += [] if prev is None else ["--state", best[prev]]
            per_step, n_val = BF16_CHAIN[stage]
            want = {k: v + n_val * EVAL_LAUNCHES[k] for k, v in per_step.items()}
            zero_launch_counts()
            text, secs = run_cli(argv)
            got16 = bf16_launch_counts()
            got32 = {k: v - got16[k] for k, v in launch_counts().items()}
            row = json.loads(text.strip().splitlines()[-1])
            r = rec[stage] = {"launches_bf16": got16, "launches_fp32": got32, "expected": want,
                              "seconds": secs, "train_loss": row["train_loss"]}
            print(f"[bf16-chain] {stage} --dtype bfloat16: {secs:.3f} s; bf16 launches {got16}, "
                  f"fp32 {got32} (expected bf16 {want}); loss {row['train_loss']:.6f}")
            check(got16 == want and not any(got32.values()) and np.isfinite(row["train_loss"]),
                  f"bf16 chain {stage}: {r}")
            if prev is not None:
                classes = BF16_CHAIN_CLASSES[stage]
                task = len(classes) - 1
                a = keep_tasks(torch_io.load_state(best[prev], "rap"), task)
                b = torch_io.load_state(best[stage], "rap")
                lr = rap_lr_tree(ERFNetRAP(classes, len(classes), device="cpu"),
                                 current_task=task, shared_lr=SHARED_LR, ds_lr=DS_LR)
                frozen = [k for k, v in lr.items() if v == 0.0]
                r["frozen"] = len(frozen)
                r["frozen_moved"] = [k for k in frozen if not torch.equal(a[k], b[k])]
                print(f"[bf16-chain] {stage}/best vs {prev}/best: {len(frozen)} parameters at "
                      f"LR 0, {len(r['frozen_moved'])} moved")
                check(frozen and not r["frozen_moved"], f"bf16 chain {stage}: {r}")
            datasets = BF16_CHAIN_DATASETS[stage]
            zero_launch_counts()
            text, secs = run_cli(["eval", best[stage], "--synthetic", "--batch-size",
                                  str(TRAIN_BATCH), "--height", str(HEIGHT), "--width", str(WIDTH),
                                  "--datasets", *datasets])
            miou = json.loads(text.strip().splitlines()[-1])
            got, got16 = launch_counts(), bf16_launch_counts()
            want_eval = {k: len(datasets) * CHAIN_EVAL_BATCHES * v for k, v in EVAL_LAUNCHES.items()}
            r["eval"] = {"miou": miou, "launches": got, "launches_bf16": got16, "seconds": secs}
            print(f"[bf16-chain] eval (float32) of {stage}/best: {miou}; launches {got}, bf16 "
                  f"{got16} (expected {want_eval}, none bf16)")
            check(got == want_eval and not any(got16.values())
                  and all(0.0 <= v <= 1.0 for v in miou.values()), f"eval of {stage}: {r['eval']}")
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = old
        shutil.rmtree(root, ignore_errors=True)
    rec["launches_bf16"] = {k: sum(rec[s]["launches_bf16"][k] for s in BF16_CHAIN)
                            for k in ("K1", "K2", "K3")}
    return rec


def phase_bf16(seed: int, dev: torch.device) -> dict:
    """Phase 16: bf16 training. K2/K3 bf16 against their plain versions and
    float64, the bf16 block against float64, a step-2 step and a step-3 batch
    at 6x512x1024 in bf16 (exact bf16 launches, losses against fp32, frozen
    parameters and the teacher, times, profiles), card vs CPU, the CLI chain
    --dtype bfloat16, and K2/K3 bf16's per-block times."""
    t_phase = time.perf_counter()
    rec: dict = {"part_seconds": {}}
    t_part = time.perf_counter()

    def part(name: str) -> None:
        nonlocal t_part
        rec["part_seconds"][name] = time.perf_counter() - t_part
        t_part = time.perf_counter()

    rec["kernel_cases"] = bf16_pair_cases(seed, dev)
    part("kernels")
    rec["blocks"] = bf16_block(seed, dev)
    part("block")
    rec["step2"] = bf16_path(train_setup, make_step, STEP_LAUNCHES, 2, "step2", seed + 500, dev)
    part("step2")
    rec["step3"] = bf16_path(step3_setup, make_step3, STEP3_LAUNCHES, 1, "step3", seed + 510, dev)
    part("step3")
    rec["vs_cpu"] = bf16_vs_cpu(seed + 520, dev)
    part("vs_cpu")
    rec["cli_chain"] = bf16_cli_chain(seed, dev)
    part("cli_chain")
    rec["times"] = pair_times(seed + 530, dev, TRAIN_BATCH, "bf16")
    part("times")
    rec["k3_by_kind"] = k3_kind_totals(rec["times"])
    print(f"[bf16] K3 bf16 per student backward at {TRAIN_BATCH}x{HEIGHT}x{WIDTH}, device ms by "
          f"launch kind (bound: each kind's operations and activation passes, k3_kind_bounds): "
          + ", ".join(f"{k} {fmt_ms(v['device_ms'])} (bound {v['bound_ms']:.4f}, "
                      f"{v['bound_by']})" if "bound_ms" in v else f"{k} {fmt_ms(v['device_ms'])}"
                      for k, v in rec["k3_by_kind"].items()))
    rec["k2_per_forward"] = {
        "device_ms": {k: None if any(r[f"fwd_{k}_ms"] is None for r in rec["times"])
                      else sum(r["count"] * r[f"fwd_{k}_ms"] for r in rec["times"])
                      for k in K2_BF16_KINDS},
        **student_pass_bound("fwd", "bf16")}
    k2 = rec["k2_per_forward"]
    print(f"[bf16] K2 bf16 per student forward at {TRAIN_BATCH}x{HEIGHT}x{WIDTH}, device ms: "
          + " + ".join(f"{k} {fmt_ms(v)}" for k, v in k2["device_ms"].items())
          + f" (bound {k2['bound_ms']:.4f}: operations {k2['ops_ms']:.4f}, bytes "
            f"{k2['bytes_ms']:.4f})")
    rec["glue_bound"] = glue_bound(item=2)
    rec["seconds"] = time.perf_counter() - t_phase
    print(f"[bf16] phase 16 in {rec['seconds']:.1f} s ("
          + ", ".join(f"{k} {v:.1f} s" for k, v in rec["part_seconds"].items()) + ")")
    return rec


# ---- phase 17: remat ------------------------------------------------------------------------
# a remat forward makes one region per group64 block, group128 chain and decoder nb1d block;
# remat_prev makes each previous-task forward one region as well, whose replay runs its
# regions' forwards again (11 more regions made) before they replay in their turn
REGIONS_PER_FORWARD = len(ENCODER_REGIONS) + len(DECODER_REGIONS)  # 5 + 2 + 4
REGIONS_PER_PREV = 1 + 2 * REGIONS_PER_FORWARD
# launches per call with remat and remat_prev: each student forward's regions replay once
# (+34 K2), each previous-task forward replays once more as a whole (+34 K2); K1, K3 as without
REMAT_CELLS = {  # kind: (setup, make, launches without remat, with, previous tasks)
    "step2": (train_setup, make_step, STEP_LAUNCHES,
              {"K1": 34, "K2": 68 + 34 * 2 + 34 * len(PREV_TASKS), "K3": 68}, PREV_TASKS),
    "step3": (step3_setup, make_step3, STEP3_LAUNCHES,
              {"K1": 0, "K2": 170 + 34 * 3 + 34 * len(STEP3_PREV), "K3": 102}, STEP3_PREV),
}
REMAT_CHAIN = {"step1": ({"K1": 0, "K2": 68, "K3": 34}, 1),  # per train step, validation batches
               "step2": (REMAT_CELLS["step2"][3], 2)}


@contextlib.contextmanager
def checkpoint_calls():
    """Counts the calls into torch.utils.checkpoint.checkpoint, by the name the
    port's regions call it (models/topology.py) and its own."""
    import torch.utils.checkpoint as tc

    calls = []
    orig = topology.checkpoint

    def counting(*args, **kw):
        calls.append(1)
        return orig(*args, **kw)

    topology.checkpoint = tc.checkpoint = counting
    try:
        yield calls
    finally:
        topology.checkpoint = tc.checkpoint = orig


def remat_cell(kind: str, dt: str, seed: int, dev: torch.device) -> dict:
    """One step-2 step or step-3 batch at 6x512x1024 in `dt`, without and with
    remat (remat=True, remat_prev=True), from the same weights, batch and
    masks, each with its counts zeroed and its peak reset just before: exact
    launches (all bf16 in bf16) and calls into torch.utils.checkpoint (none
    without remat); the losses and confusion matrix, every student parameter,
    running statistic and Adam tensor after the call bitwise equal; the
    teacher unchanged; peak memory; then one profiled call of each (device
    busy ms, idle share)."""
    setup, make, plain_want, remat_want, prev = REMAT_CELLS[kind]
    student, teacher, images, labels, masks = setup(seed, dev, TRAIN_BATCH, HEIGHT, WIDTH)
    images, labels = images.to(dev), labels.to(dev)
    s_state, t_state = state_copy(student), state_copy(teacher)
    rec, after = {}, {}
    for remat in (False, True):
        tag = f"remat-{kind}-{dt}-{'on' if remat else 'off'}"
        student.load_state_dict(s_state)
        _, step = make(student, dt, remat=remat, remat_prev=remat)
        ts = steps.init_train_state(student)
        sync(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        zero_launch_counts()
        t0 = time.perf_counter()
        with checkpoint_calls() as calls:
            ts, m = step(ts, teacher, images, labels, masks, 1)
            sync(dev)
        secs = time.perf_counter() - t0
        r = rec["remat" if remat else "plain"] = {
            "launches": launch_counts(), "launches_bf16": bf16_launch_counts(),
            "checkpoint_calls": len(calls), "seconds": secs,
            "peak_memory_bytes": torch.cuda.max_memory_allocated(dev),
            "losses": {k: float(v) for k, v in m.items() if k != "cm"}}
        after[remat] = ({k: v.detach().cpu() for k, v in m.items()},
                        {**{k: v.cpu() for k, v in state_copy(student).items()},
                         "opt.m": ts.opt.m.cpu(), "opt.v": ts.opt.v.cpu()})
        r["teacher_changed"] = changed(teacher, t_state)
        want = remat_want if remat else plain_want
        want_calls = REGIONS_PER_FORWARD + len(prev) * REGIONS_PER_PREV if remat else 0
        print(f"[{tag}] launches {r['launches']} (expected {want}), bf16 {r['launches_bf16']}; "
              f"{r['checkpoint_calls']} checkpoint calls (expected {want_calls}); peak "
              f"{r['peak_memory_bytes'] / 2**30:.3f} GiB; loss {r['losses']['loss']:.6f}; "
              f"{secs:.3f} s")
        check(r["launches"] == want, f"{tag}: launched {r['launches']}, expected {want}")
        check(r["launches_bf16"] == (want if dt == "bfloat16" else {k: 0 for k in want}),
              f"{tag}: bf16 launches {r['launches_bf16']}")
        check(r["checkpoint_calls"] == want_calls,
              f"{tag}: {r['checkpoint_calls']} calls into torch.utils.checkpoint, "
              f"expected {want_calls}")
        check(not r["teacher_changed"], f"{tag}: the teacher changed {r['teacher_changed'][:5]}")
        state = {"ts": ts}

        def one():
            state["ts"], _ = step(state["ts"], teacher, images, labels, masks, 1)

        r["profile"] = profile_once(one, tag, f"one {kind} call")
        del state, one, ts, m  # nothing of this call in the next one's peak
    (m_a, s_a), (m_b, s_b) = after[False], after[True]
    rec["unequal_metrics"] = [k for k in m_a if not torch.equal(m_a[k], m_b[k])]
    rec["unequal_state"] = [k for k in s_a if not torch.equal(s_a[k], s_b[k])]
    rec["max_rel_diff"] = max((float((s_a[k].double() - s_b[k].double()).abs().max()
                                     / s_a[k].double().abs().max().clamp_min(1e-30))
                               for k in rec["unequal_state"]), default=0.0)
    pa, pr = rec["plain"], rec["remat"]
    print(f"[remat-{kind}-{dt}] remat vs not, bitwise: metrics unequal {rec['unequal_metrics']}, "
          f"{len(rec['unequal_state'])} of {len(s_a)} student tensors (parameters, running "
          f"statistics, Adam) unequal (largest relative difference {rec['max_rel_diff']:.3e}); "
          f"peak {pa['peak_memory_bytes'] / 2**30:.3f} -> {pr['peak_memory_bytes'] / 2**30:.3f} "
          f"GiB; busy {pa['profile']['device_ms']:.3f} -> {pr['profile']['device_ms']:.3f} ms, "
          f"idle share {pa['profile']['idle_share']:.3f} -> {pr['profile']['idle_share']:.3f}")
    check(not rec["unequal_metrics"] and not rec["unequal_state"],
          f"remat {kind} {dt}: not bitwise: {rec['unequal_metrics']} {rec['unequal_state'][:5]}")
    return rec


def remat_cli_chain(seed: int) -> dict:
    """`step1 --remat` -> `step2 --remat` through cli.main at 6x512x1024 (6
    synthetic images per domain and subset, one epoch), the counts zeroed
    just before each stage: exactly its train step's remat launches plus 34
    K1 per validation batch; every LR-0 parameter of step2/best bitwise as in
    step1/best."""
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "remat_chain")
    shutil.rmtree(root, ignore_errors=True)
    common = ["--synthetic", "--synthetic-size", str(TRAIN_BATCH), "--num-epochs", "1",
              "--batch-size", str(TRAIN_BATCH), "--height", str(HEIGHT), "--width",
              str(WIDTH), "--seed", str(seed), "--remat"]
    best = {s: os.path.join(root, s, "best") for s in REMAT_CHAIN}
    rec: dict = {}
    try:
        for stage, prev in (("step1", None), ("step2", "step1")):
            argv = [stage, "--savedir", os.path.dirname(best[stage]), *common]
            argv += [] if prev is None else ["--state", best[prev]]
            per_step, n_val = REMAT_CHAIN[stage]
            want = {k: v + n_val * EVAL_LAUNCHES[k] for k, v in per_step.items()}
            zero_launch_counts()
            text, secs = run_cli(argv)
            got = launch_counts()
            row = json.loads(text.strip().splitlines()[-1])
            r = rec[stage] = {"launches": got, "expected": want, "seconds": secs,
                              "train_loss": row["train_loss"]}
            print(f"[remat-chain] {stage} --remat: {secs:.3f} s; launches {got} (expected "
                  f"{want}); loss {row['train_loss']:.6f}")
            check(got == want and np.isfinite(row["train_loss"]), f"remat chain {stage}: {r}")
        a = keep_tasks(torch_io.load_state(best["step1"], "rap"), 1)
        b = torch_io.load_state(best["step2"], "rap")
        lr = rap_lr_tree(ERFNetRAP(STUDENT_CLASSES, len(STUDENT_CLASSES), device="cpu"),
                         current_task=CURRENT_TASK, shared_lr=SHARED_LR, ds_lr=DS_LR)
        frozen = [k for k, v in lr.items() if v == 0.0]
        rec["frozen"] = len(frozen)
        rec["frozen_moved"] = [k for k in frozen if not torch.equal(a[k], b[k])]
        print(f"[remat-chain] step2/best vs step1/best: {len(frozen)} parameters at LR 0, "
              f"{len(rec['frozen_moved'])} moved")
        check(frozen and not rec["frozen_moved"], f"remat chain: {rec['frozen_moved'][:5]}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    rec["launches"] = {k: sum(rec[s]["launches"][k] for s in REMAT_CHAIN) for k in ("K1", "K2", "K3")}
    return rec


def phase_remat(seed: int, dev: torch.device) -> dict:
    """Phase 17: remat, cuDNN on its deterministic algorithms. The step-2 step
    and the step-3 batch at 6x512x1024 in float32 and bfloat16 with and
    without remat (`remat_cell`), then the CLI with --remat
    (`remat_cli_chain`)."""
    t_phase = time.perf_counter()
    rec: dict = {"cells": {}}
    old = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        for i, (kind, dt) in enumerate((k, d) for k in REMAT_CELLS
                                       for d in ("float32", "bfloat16")):
            rec["cells"][f"{kind}_{dt}"] = remat_cell(kind, dt, seed + 600 + i, dev)
        rec["cli_chain"] = remat_cli_chain(seed)
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = old
    print(f"[remat] {TRAIN_BATCH}x{HEIGHT}x{WIDTH}, per call without -> with remat: peak GiB, "
          f"device busy ms, idle share")
    for name, c in rec["cells"].items():
        pa, pr = c["plain"], c["remat"]
        print(f"[remat]   {name}: {pa['peak_memory_bytes'] / 2**30:.3f} -> "
              f"{pr['peak_memory_bytes'] / 2**30:.3f} GiB, {pa['profile']['device_ms']:.3f} -> "
              f"{pr['profile']['device_ms']:.3f} ms, {pa['profile']['idle_share']:.3f} -> "
              f"{pr['profile']['idle_share']:.3f}")
    rec["seconds"] = time.perf_counter() - t_phase
    print(f"[remat] phase 17 in {rec['seconds']:.1f} s")
    return rec


def remat_launches(rec: dict, k: str) -> dict:
    """The kernels-line keys of kernel `k` ("K1" / "K2" / "K3") on phase 17's paths."""
    out = {f"launches_remat_{name}": c["remat"]["launches"][k] for name, c in rec["cells"].items()}
    out["launches_remat_cli_chain"] = rec["cli_chain"]["launches"][k]
    return out


# ---- phase 18: data-parallel training ------------------------------------------------------
DP_CELLS = {"step2": (train_setup, make_step, STEP_LAUNCHES),
            "step3": (step3_setup, make_step3, STEP3_LAUNCHES)}
DP_WORLD = 2  # processes on the one card, gloo
DP_TRAINER_IMAGES = 12  # per domain and subset: 2 global batches of 6, 3 rows per rank
# per rank, the Trainer epoch at world 2: 2 steps, then 2 validation batches of each domain
DP_TRAINER_LAUNCHES = {k: 2 * v + 2 * 2 * EVAL_LAUNCHES[k] for k, v in STEP_LAUNCHES.items()}
DP_TIMEOUT = 300  # seconds for the world-2 processes


def dp_root() -> str:
    return os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "data_parallel")


def dp_state(student, ts) -> dict:
    """The student's parameters, buffers and Adam tensors on the CPU."""
    return {**{k: v.cpu() for k, v in state_copy(student).items()},
            "opt.m": ts.opt.m.cpu(), "opt.v": ts.opt.v.cpu()}


def dp_world1_cell(kind: str, dt: str, seed: int, dev: torch.device, mesh) -> dict:
    """One step-2 step or step-3 batch at 6x512x1024 in `dt`, without and with
    `mesh` (one NCCL rank) from the same weights, batch and masks, each with
    its counts zeroed just before: the launches exactly phase 17's without
    remat in both, and every output, parameter, running statistic and Adam
    tensor bitwise equal; the peak of each call."""
    setup, make, want = DP_CELLS[kind]
    student, teacher, images, labels, masks = setup(seed, dev, TRAIN_BATCH, HEIGHT, WIDTH)
    images, labels = images.to(dev), labels.to(dev)
    s_state = state_copy(student)
    rec, after = {}, {}
    for m in (None, mesh):
        tag = f"dp-world1-{kind}-{dt}-{'nccl' if m is not None else 'no-mesh'}"
        student.load_state_dict(s_state)
        _, step = make(student, dt, mesh=m)
        ts = steps.init_train_state(student)
        sync(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        zero_launch_counts()
        ts, metrics = step(ts, teacher, images, labels, masks, 1)
        sync(dev)
        r = rec["mesh" if m is not None else "plain"] = {
            "launches": launch_counts(), "peak_memory_bytes": torch.cuda.max_memory_allocated(dev),
            "loss": float(metrics["loss"])}
        after[m is not None] = ({k: v.detach().cpu() for k, v in metrics.items()},
                                dp_state(student, ts))
        print(f"[{tag}] launches {r['launches']} (expected {want}); peak "
              f"{r['peak_memory_bytes'] / 2**30:.3f} GiB; loss {r['loss']:.6f}")
        check(r["launches"] == want, f"{tag}: launched {r['launches']}, expected {want}")
        del ts, metrics
    (m_a, s_a), (m_b, s_b) = after[False], after[True]
    rec["unequal"] = ([k for k in m_a if not torch.equal(m_a[k], m_b[k])]
                      + [k for k in s_a if not torch.equal(s_a[k], s_b[k])])
    print(f"[dp-world1-{kind}-{dt}] one NCCL rank vs no mesh, bitwise: {len(rec['unequal'])} of "
          f"{len(m_a) + len(s_a)} outputs and student tensors unequal")
    check(not rec["unequal"], f"world 1 {kind} {dt}: not bitwise: {rec['unequal'][:5]}")
    return rec


def dp_world1_times(seed: int, dev: torch.device, mesh) -> dict:
    """The fp32 step-2 step at 6x512x1024 without and with the one-rank mesh:
    wall ms per step (CUDA events over 5 steps) and one profiled step's
    device busy ms and idle share."""
    student, teacher, images, labels, masks = train_setup(seed, dev, TRAIN_BATCH, HEIGHT, WIDTH)
    images, labels = images.to(dev), labels.to(dev)
    rec = {}
    for name, m in (("no_mesh", None), ("nccl_world1", mesh)):
        _, step = make_step(student, mesh=m)
        state = {"ts": steps.init_train_state(student)}

        def one():
            state["ts"], _ = step(state["ts"], teacher, images, labels, masks, 1)

        rec[name] = {"wall_ms": time_ms(one, iters=5, warmup=1),
                     "profile": profile_once(one, f"dp-world1-{name}", "one fp32 step-2 step")}
        del state, one
    return rec


def phase_dp_world1(seed: int, dev: torch.device) -> dict:
    """Phase 18 (a): a process group of one rank under NCCL, made in-process
    from a FileStore, and the port's mesh over it (`make_mesh`): the step-2
    step and the step-3 batch in fp32 and bf16 through `make_*_step(mesh=)`,
    each bitwise the step without a mesh (`dp_world1_cell`), and the fp32
    step-2 step's times with and without the collectives."""
    import torch.distributed as dist

    from mdilss_tpu_torch.parallel import make_mesh

    os.makedirs(dp_root(), exist_ok=True)
    store = os.path.join(dp_root(), "world1_store")
    if os.path.exists(store):
        os.remove(store)
    dist.init_process_group("nccl", store=dist.FileStore(store, 1), rank=0, world_size=1,
                            device_id=torch.device("cuda", torch.cuda.current_device()))
    rec: dict = {"cells": {}}
    try:
        mesh = make_mesh(TRAIN_BATCH, device=dev)
        check(mesh.active and mesh.data == 1 and dist.get_backend() == "nccl",
              f"world-1 mesh {mesh}")
        for i, (kind, dt) in enumerate((k, d) for k in DP_CELLS for d in ("float32", "bfloat16")):
            rec["cells"][f"{kind}_{dt}"] = dp_world1_cell(kind, dt, seed + 700 + i, dev, mesh)
        rec["times"] = dp_world1_times(seed + 710, dev, mesh)
    finally:
        dist.destroy_process_group()
    return rec


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def dp_spawn(kind: str, seed: int, timeout: float, probe: bool = False) -> list[dict]:
    """Start DP_WORLD processes of `chip_smoke.py --dp-worker kind`, every rank
    on the one card (LOCAL_RANK 0), and wait for them -> each rank's record
    (its JSON file); a rank that fails or outlasts `timeout` fails the phase,
    unless `probe`: then its record says how it ended."""
    root = os.path.join(dp_root(), kind)
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    env = {**os.environ, "MASTER_ADDR": "localhost", "MASTER_PORT": str(free_port()),
           "WORLD_SIZE": str(DP_WORLD), "LOCAL_RANK": "0"}
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--seed", str(seed),
                               "--dp-worker", kind, "--out", root],
                              env={**env, "RANK": str(r)}, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(DP_WORLD)]
    outs, deadline = [], time.monotonic() + timeout
    try:
        for p in procs:
            try:
                outs.append(p.communicate(timeout=max(deadline - time.monotonic(), 1))[0])
            except subprocess.TimeoutExpired:
                check(probe, f"--dp-worker {kind} outlasted {timeout} s")
                p.kill()
                outs.append(p.communicate()[0] + f"\n(killed after {timeout} s)")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    recs = []
    for r, (p, out) in enumerate(zip(procs, outs)):
        for line in out.strip().splitlines()[-40:]:
            print(f"[dp-{kind} rank {r}] {line[:300]}")
        path = os.path.join(root, f"rank{r}.json")
        if probe and not os.path.exists(path):
            recs.append({"rank": r, "error": f"exit code {p.returncode}: "
                                             + " | ".join(out.strip().splitlines()[-3:])})
            continue
        check(p.returncode == 0, f"--dp-worker {kind} rank {r} exited {p.returncode}")
        with open(path) as f:
            recs.append(json.load(f))
    return recs


def dp_worker(kind: str, seed: int, root: str) -> int:
    """One rank of phase 18 (b), under the environment `dp_spawn` sets.

    "nccl": joins an NCCL group on cuda:0 beside the other rank on the same
    card and all-reduces one number; records what NCCL said.
    "step": joins the gloo group (`make_mesh(backend="gloo")`), takes its 3
    rows of the 6 images, dropout masks and all, and takes the fp32 step-2
    step through `make_step(mesh=)`, its counts zeroed just before (its
    state saved for the parent); then 3 more steps timed (wall ms, CUDA
    events) and one profiled, and one epoch of the step-2 Trainer on
    synthetic data at full width with device_cache="auto" (the cache's mesh
    arm), counted per train epoch and validation."""
    import torch.distributed as dist

    from mdilss_tpu_torch.parallel import make_mesh, shard_rows
    from mdilss_tpu_torch.models.topology import shard_dropout_masks

    rank = int(os.environ["RANK"])
    dev = torch.device("cuda", 0)
    rec: dict = {"rank": rank}
    if kind == "nccl":
        try:
            make_mesh(TRAIN_BATCH, device=dev, backend="nccl")
            t = torch.ones(1, device=dev)
            dist.all_reduce(t)
            torch.cuda.synchronize(dev)
            rec["error"] = None
            rec["sum"] = float(t)
        except Exception as e:  # what NCCL says of two ranks on one device
            rec["error"] = f"{type(e).__name__}: {e}"[:2000]
        with open(os.path.join(root, f"rank{rank}.json"), "w") as f:
            json.dump(rec, f)
        os._exit(0)  # a group that failed to form can hang at exit
    else:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
        mesh = make_mesh(TRAIN_BATCH, device=dev, backend="gloo")
        check(mesh.data == DP_WORLD and dist.get_backend() == "gloo", f"mesh {mesh}")
        student, teacher, images, labels, masks = train_setup(seed, dev, TRAIN_BATCH, HEIGHT,
                                                              WIDTH)
        x, y = shard_rows(images, mesh).to(dev), shard_rows(labels, mesh).to(dev)
        masks = [shard_dropout_masks(m, mesh) for m in masks]
        _, step = make_step(student, mesh=mesh)
        ts = steps.init_train_state(student)
        sync(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        zero_launch_counts()
        ts, m = step(ts, teacher, x, y, masks, 1)
        sync(dev)
        rec.update(rows=int(x.shape[0]), launches=launch_counts(),
                   metrics={k: float(v) for k, v in m.items()},
                   peak_memory_bytes=torch.cuda.max_memory_allocated(dev))
        torch.save(dp_state(student, ts), os.path.join(root, f"rank{rank}.pt"))
        state = {"ts": ts}

        def one():
            state["ts"], _ = step(state["ts"], teacher, x, y, masks, 1)

        rec["wall_ms"] = time_ms(one, iters=3, warmup=1)
        rec["profile"] = profile_once(one, f"dp-world2-rank{rank}", "one fp32 step-2 step")
        del state, one, ts, m
        rec["trainer"] = dp_trainer_epoch(seed, dev, root, rank)
        dist.barrier()
        dist.destroy_process_group()
    with open(os.path.join(root, f"rank{rank}.json"), "w") as f:
        json.dump(rec, f, default=str)
    return 0


def dp_trainer_epoch(seed: int, dev: torch.device, root: str, rank: int) -> dict:
    """One epoch of the step-2 Trainer at world 2 (synthetic, 6x512x1024,
    DP_TRAINER_IMAGES per domain and subset, device_cache="auto"): each train
    epoch and validation counted; the caches must be the mesh arm's."""
    torch.manual_seed(seed + 20)
    teacher = ERFNetRAP(TEACHER_CLASSES, len(TEACHER_CLASSES), device=dev)
    randomize_bn(teacher, torch.Generator().manual_seed(seed + 21))
    cfg = PC.step2(num_epochs=1, eval_every=1, eval_old_every=1, synthetic=True,
                   synthetic_size=DP_TRAINER_IMAGES, batch_size=TRAIN_BATCH, height=HEIGHT,
                   width=WIDTH, device_cache="auto", seed=seed,
                   savedir=os.path.join(root, "trainer"))
    tr = Trainer(cfg, teacher=teacher, device=dev)
    calls: list[dict] = []
    count_calls(tr, calls, dev)
    sync(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    zero_launch_counts()
    t0 = time.perf_counter()
    hist = tr.fit()
    secs = time.perf_counter() - t0
    caches = [(type(c).__name__, getattr(c, "mesh", None) is not None)
              for c in (*tr._train_caches.values(), *tr._val_caches.values())]
    rec = {"launches": launch_counts(), "calls": calls, "seconds": secs, "caches": caches,
           "train_loss": hist["train_loss"], "peak_memory_bytes":
           torch.cuda.max_memory_allocated(dev),
           "files": sorted(os.listdir(cfg.savedir)) if rank == 0 else None}
    return rec


def dp_world2(seed: int, dev: torch.device) -> dict:
    """Phase 18 (b): two processes on the one card. First whether NCCL takes
    two ranks on one device (`dp_worker("nccl")`: what it said is recorded);
    then gloo (`dp_worker("step")`): each rank's fp32 step-2 step on 3 of the
    6 images against this process's 6-image step from the same weights and
    data (the loss to 1e-5 relative; every parameter within 1.1e-3 and at
    most 1% beyond 2e-5, tests/test_multichip.py:62-71; the running
    statistics to 1e-4 relative; the two ranks bitwise equal), each rank's
    K1/K2/K3 launches exactly a step's, and its Trainer epoch with the
    cache's mesh arm."""
    rec: dict = {}
    nccl = dp_spawn("nccl", seed, 90, probe=True)
    rec["nccl_two_ranks_one_card"] = [r["error"] for r in nccl]
    print(f"[dp-world2] NCCL with two ranks on one card: "
          + ("; ".join(f"rank {r['rank']}: {r['error'] or 'no error, sum ' + str(r.get('sum'))}"
                       for r in nccl)))
    ranks = dp_spawn("step", seed + 720, DP_TIMEOUT)
    rec["ranks"] = ranks
    # the single process: the same weights, the 6 images, the same masks
    student, teacher, images, labels, masks = train_setup(seed + 720, dev, TRAIN_BATCH, HEIGHT,
                                                          WIDTH)
    _, step = make_step(student)
    old = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        ts, m = step(steps.init_train_state(student), teacher, images.to(dev), labels.to(dev),
                     masks, 1)
        sync(dev)
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = old
    one = dp_state(student, ts)
    two = [torch.load(os.path.join(dp_root(), "step", f"rank{r}.pt")) for r in range(DP_WORLD)]
    rec["ranks_unequal"] = [k for k in two[0] if not torch.equal(two[0][k], two[1][k])]
    params = [k for k, _ in student.named_parameters()]
    d = torch.cat([(two[0][k] - one[k]).abs().flatten() for k in params])
    running = {k: float((two[0][k].double() - one[k].double()).norm()
                        / one[k].double().norm().clamp_min(1e-30))
               for k in one if "running" in k}
    rec.update(max_abs_param_diff=float(d.max()), frac_beyond_2e5=float((d > 2e-5).float().mean()),
               max_running_rel=max(running.values()), loss_one=float(m["loss"]),
               loss_two=ranks[0]["metrics"]["loss"])
    rel_loss = abs(rec["loss_two"] - rec["loss_one"]) / abs(rec["loss_one"])
    print(f"[dp-world2] gloo, 2 ranks x 3 images vs one process x 6: loss {rec['loss_two']:.6f} "
          f"vs {rec['loss_one']:.6f} (rel {rel_loss:.2e}); parameters max |diff| "
          f"{rec['max_abs_param_diff']:.3e}, {100 * rec['frac_beyond_2e5']:.3f}% beyond 2e-5; "
          f"running statistics max rel {rec['max_running_rel']:.2e}; ranks unequal "
          f"{len(rec['ranks_unequal'])}")
    check(rel_loss <= 1e-5, f"world 2 loss {rec['loss_two']} vs {rec['loss_one']}")
    check(rec["max_abs_param_diff"] <= 1.1e-3 and rec["frac_beyond_2e5"] <= 0.01,
          f"world 2 parameters: {rec['max_abs_param_diff']}, {rec['frac_beyond_2e5']}")
    check(rec["max_running_rel"] <= 1e-4, f"world 2 running statistics {rec['max_running_rel']}")
    check(not rec["ranks_unequal"], f"the ranks differ: {rec['ranks_unequal'][:5]}")
    for r in ranks:
        t = r["trainer"]
        print(f"[dp-world2] rank {r['rank']}: {r['rows']} rows; step launches {r['launches']} "
              f"(expected {STEP_LAUNCHES}); peak {r['peak_memory_bytes'] / 2**30:.3f} GiB; "
              f"step wall {r['wall_ms']:.3f} ms, busy {r['profile']['device_ms']:.3f} ms, idle "
              f"share {r['profile']['idle_share']:.3f}; Trainer epoch {t['seconds']:.3f} s, "
              f"launches {t['launches']} (expected {DP_TRAINER_LAUNCHES}), caches {t['caches']}, "
              f"loss {t['train_loss']:.6f}, peak {t['peak_memory_bytes'] / 2**30:.3f} GiB")
        check(r["rows"] == TRAIN_BATCH // DP_WORLD and r["launches"] == STEP_LAUNCHES,
              f"rank {r['rank']}: {r['rows']} rows, launches {r['launches']}")
        check(t["launches"] == DP_TRAINER_LAUNCHES, f"rank {r['rank']} Trainer: {t['launches']}")
        check([c["kind"] for c in t["calls"]] == ["train", "val", "val"],
              f"rank {r['rank']} Trainer calls {t['calls']}")
        check(t["caches"] == [["DeviceCache", True]] * 3,
              f"rank {r['rank']} caches {t['caches']}: expected the mesh arm's three")
        check(np.isfinite(t["train_loss"]), f"rank {r['rank']} Trainer loss {t['train_loss']}")
    check(ranks[0]["trainer"]["train_loss"] == ranks[1]["trainer"]["train_loss"],
          "the ranks' Trainer results differ")
    check(ranks[0]["trainer"]["files"] and "automated_log.txt" in ranks[0]["trainer"]["files"],
          f"rank 0 wrote {ranks[0]['trainer']['files']}")
    return rec


def dp_cli(seed: int) -> dict:
    """Phase 18 (c): `python -m torch.distributed.run --standalone
    --nproc_per_node 1 -m mdilss_tpu_torch step1 ...` at 6x512x1024, 6
    synthetic images per domain and subset, one epoch (NCCL, one rank)."""
    root = os.path.join(dp_root(), "cli")
    shutil.rmtree(root, ignore_errors=True)
    argv = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
            "1", "-m", "mdilss_tpu_torch", "step1", "--synthetic", "--synthetic-size",
            str(TRAIN_BATCH), "--num-epochs", "1", "--batch-size", str(TRAIN_BATCH), "--height",
            str(HEIGHT), "--width", str(WIDTH), "--seed", str(seed), "--savedir", root]
    t0 = time.perf_counter()
    p = subprocess.run(argv, capture_output=True, text=True, timeout=DP_TIMEOUT,
                       cwd=os.path.dirname(os.path.abspath(__file__)))
    secs = time.perf_counter() - t0
    for line in (p.stdout + p.stderr).strip().splitlines()[-6:]:
        print(f"[dp-cli] | {line[:300]}")
    check(p.returncode == 0, f"torchrun step1 exited {p.returncode}")
    rows = [json.loads(line) for line in p.stdout.splitlines() if line.startswith("{")]
    check(len(rows) == 1 and np.isfinite(rows[0]["train_loss"]), f"torchrun step1 printed {rows}")
    files = sorted(os.listdir(root))
    check("automated_log.txt" in files and "best" in files, f"torchrun step1 wrote {files}")
    print(f"[dp-cli] torchrun --nproc_per_node 1 step1: {secs:.3f} s, loss "
          f"{rows[0]['train_loss']:.6f}, files {files}")
    return {"seconds": secs, "train_loss": rows[0]["train_loss"], "files": files}


def phase_data_parallel(seed: int, dev: torch.device) -> dict:
    """Phase 18: data-parallel training (ROADMAP A10), cuDNN on its
    deterministic algorithms: (a) one NCCL rank, bitwise the unsharded
    steps; (b) two gloo ranks on the one card against one process, and a
    Trainer epoch with the cache's mesh arm; (c) the CLI under torchrun."""
    t_phase = time.perf_counter()
    old = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        rec = {"world1": phase_dp_world1(seed, dev)}
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = old
    rec["world2"] = dp_world2(seed, dev)
    rec["cli"] = dp_cli(seed)
    shutil.rmtree(dp_root(), ignore_errors=True)
    card = card_line()
    w1 = rec["world1"]["times"]
    print(f"[dp] {card}: fp32 step-2 step at {TRAIN_BATCH}x{HEIGHT}x{WIDTH}: no mesh wall "
          f"{w1['no_mesh']['wall_ms']:.3f} ms, busy {w1['no_mesh']['profile']['device_ms']:.3f} "
          f"ms; one NCCL rank wall {w1['nccl_world1']['wall_ms']:.3f} ms, busy "
          f"{w1['nccl_world1']['profile']['device_ms']:.3f} ms")
    for r in rec["world2"]["ranks"]:
        print(f"[dp] {card}: world 2 (gloo, both on this card) rank {r['rank']}: step wall "
              f"{r['wall_ms']:.3f} ms, busy {r['profile']['device_ms']:.3f} ms, peak "
              f"{r['peak_memory_bytes'] / 2**30:.3f} GiB")
    for name, c in rec["world1"]["cells"].items():
        print(f"[dp] {card}: world 1 {name}: peak {c['plain']['peak_memory_bytes'] / 2**30:.3f} "
              f"-> {c['mesh']['peak_memory_bytes'] / 2**30:.3f} GiB with the mesh")
    rec["seconds"] = time.perf_counter() - t_phase
    print(f"[dp] phase 18 in {rec['seconds']:.1f} s")
    return rec


def dp_launches(rec: dict, k: str) -> dict:
    """The kernels-line keys of kernel `k` on phase 18's paths."""
    out = {f"launches_sharded_world1_{name}": c["mesh"]["launches"][k]
           for name, c in rec["world1"]["cells"].items()}
    for r in rec["world2"]["ranks"]:
        out[f"launches_sharded_world2_step2_rank{r['rank']}"] = r["launches"][k]
        out[f"launches_sharded_trainer_rank{r['rank']}"] = r["trainer"]["launches"][k]
    return out


# ---- phase 19: the spatial axis (A11) ---------------------------------------------------------
SP_SLAB = (6, 128, 64, 128)  # n, c, h, w: the encoder's 1/8 maps of 6x512x1024
SP_DILATIONS, SP_SHARDS = (2, 4, 8, 16), (2, 4, 8)
# the slabs against the whole call: (fp32, bf16) of each output's largest |difference| over
# the output's largest |value| (y and du per pixel, the stats and weight gradients as sums)
SP_TOL = {"y": (1e-6, 2.0 ** -8), "du": (1e-5, 2.0 ** -6), "sums": (1e-6, 1e-5),
          "k1": (1e-6, 2.0 ** -8)}
SP_MESHES = {"1x2": 2, "2x2": 4}  # mesh (data x spatial): processes on the card, gloo
SP_TIMEOUT = 420  # seconds for a mesh's processes


def slab_rows(s: int, n_sp: int, h: int, halo: int) -> tuple[int, int, int]:
    """(first row, end row, rows above) of slab s of n_sp with `halo` rows
    of its neighbours each side, clipped at the image's edges."""
    hs = h // n_sp
    top, bottom = min(halo, s * hs), min(halo, (n_sp - 1 - s) * hs)
    return s * hs - top, (s + 1) * hs + bottom, top


def _rel_max(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got.double() - want.double()).abs().max() / want.double().abs().max()
                 .clamp_min(1e-30))


def padded_slab_case(seed: int, dev: torch.device, dt: str, d: int, n_sp: int) -> dict:
    """K2 (pre-stage and RAP) and K3 on n_sp padded slabs of an SP_SLAB input
    (each slab with d halo rows each side, cut from the whole tensor, K2's
    stats window on the slab's rows, K3's gy zero on the halo rows), and K1
    on slabs with 1 + d halo rows, each stitched (K3's du summed over the
    slabs that hold a row) against the whole call: the largest difference
    over the largest value of each output, and whether y and K1's output are
    bitwise the whole call's."""
    n, c, h, w = SP_SLAB
    dtype = DTYPES[dt]
    gen = torch.Generator().manual_seed(seed)
    mk = lambda *s, scale=1.0: (torch.randn(*s, generator=gen) * scale).to(dev)  # noqa: E731
    x = cl(mk(n, c, h, w).to(dtype))
    gy = cl(mk(n, c, h, w).to(dtype))
    w31, b31, w13, rap = (mk(c, c, 3, 1, scale=c ** -0.5), mk(c, scale=0.1),
                          mk(c, c, 1, 3, scale=c ** -0.5), mk(c, c, scale=c ** -0.5))
    pre = ((1.0 + 0.2 * mk(c)).abs(), 0.2 * mk(c))
    y, st = T.fwd_pair(x, w31, b31, w13, rap, pre, d)
    whole_bwd = T.bwd_pair(x, gy, w31, b31, w13, rap, pre, d)
    y_s, du_s = torch.empty_like(y), torch.zeros(n, c, h, w, dtype=torch.float32, device=dev)
    st_s, grads_s = torch.zeros_like(st), [torch.zeros_like(g) for g in whole_bwd[1:]]
    hs = h // n_sp
    for s in range(n_sp):
        lo, hi, top = slab_rows(s, n_sp, h, d)
        raw = cl(x[:, :, lo:hi])
        yp, stp = T.fwd_pair(raw, w31, b31, w13, rap, pre, d, (top, top + hs))
        y_s[:, :, s * hs:(s + 1) * hs] = yp[:, :, top:top + hs]
        st_s += stp
        gyp = torch.zeros_like(raw)
        gyp[:, :, top:top + hs] = gy[:, :, s * hs:(s + 1) * hs]
        dup, *gp = T.bwd_pair(raw, cl(gyp), w31, b31, w13, rap, pre, d)
        du_s[:, :, lo:hi] += dup.float()
        for acc, g in zip(grads_s, gp):
            acc += g
    blk = NonBottleneck1dRAP(c, d, 1).to(dev)
    randomize_bn(blk, gen)
    ops = K.prepare_operands(blk, 0, dtype)
    out = K.nb1d_infer(x, ops, d)
    out_s = torch.empty_like(out)
    for s in range(n_sp):
        lo, hi, top = slab_rows(s, n_sp, h, 1 + d)
        out_s[:, :, s * hs:(s + 1) * hs] = K.nb1d_infer(cl(x[:, :, lo:hi]), ops, d)[
            :, :, top:top + hs]
    sync(dev)
    return {
        "d": d, "shards": n_sp, "dtype": dt,
        "y": _rel_max(y_s, y), "y_bitwise": bool(torch.equal(y_s, y)),
        "stats": max(_rel_max(a, b) for a, b in zip(st_s, st)),
        "du": _rel_max(du_s.to(dtype), whole_bwd[0]),
        "wgrads": max(_rel_max(a, b) for a, b in zip(grads_s, whole_bwd[1:])),
        "k1": _rel_max(out_s, out), "k1_bitwise": bool(torch.equal(out_s, out)),
    }


def k2_whole_window(seed: int, dev: torch.device) -> list[dict]:
    """K2 fp32 and bf16 at each block shape of a 6x512x1024 forward with its
    stats window the whole height, against the call without one: y and the
    stats bitwise equal."""
    out = []
    for name, c, d, rap, h, w, _ in BLOCKS:
        for dt, dtype in DTYPES.items():
            gen = torch.Generator().manual_seed(seed + c + d)
            mk = lambda *s: (torch.randn(*s, generator=gen) * 0.2).to(dev)  # noqa: E731
            x = cl(torch.randn(TRAIN_BATCH, c, h, w, generator=gen).to(dev, dtype))
            args = (mk(c, c, 3, 1), mk(c), mk(c, c, 1, 3), mk(c, c) if rap else None,
                    ((1.0 + mk(c)).abs(), mk(c)))
            y, st = T.fwd_pair(x, *args, d)
            yw, stw = T.fwd_pair(x, *args, d, (0, h))
            out.append({"block": name, "dtype": dt,
                        "bitwise": bool(torch.equal(y, yw) and torch.equal(st, stw))})
    return out


def phase_spatial_kernels(seed: int, dev: torch.device) -> dict:
    """Phase 19 (a), one process: K2's whole stats window, and K1/K2/K3 on
    padded slabs against the whole calls."""
    rec = {"whole_window": k2_whole_window(seed + 900, dev), "slabs": []}
    bad = [r for r in rec["whole_window"] if not r["bitwise"]]
    print(f"[spatial] K2 with the whole stats window vs without one, {len(rec['whole_window'])} "
          f"calls (7 block shapes x fp32 / bf16): {len(bad)} not bitwise")
    check(not bad, f"K2's whole window is not the call without one: {bad[:3]}")
    for i, (dt, d, n_sp) in enumerate((dt, d, s) for dt in DTYPES for d in SP_DILATIONS
                                      for s in SP_SHARDS):
        r = padded_slab_case(seed + 910 + i, dev, dt, d, n_sp)
        rec["slabs"].append(r)
        j = 0 if dt == "f32" else 1
        print(f"[spatial] {dt} d={d} S={n_sp} ({SP_SLAB[2] // n_sp} rows a slab): y "
              f"{r['y']:.2e} (bitwise {r['y_bitwise']}), stats {r['stats']:.2e}, du "
              f"{r['du']:.2e}, weight gradients {r['wgrads']:.2e}; K1 {r['k1']:.2e} (bitwise "
              f"{r['k1_bitwise']})")
        for k, v in (("y", r["y"]), ("stats", r["stats"]), ("du", r["du"]),
                     ("wgrads", r["wgrads"]), ("k1", r["k1"])):
            tol = SP_TOL["sums" if k in ("stats", "wgrads") else k][j]
            check(v <= tol, f"padded slabs {dt} d={d} S={n_sp}: {k} {v:.3e} > {tol:.1e}")
    return rec


def sp_root() -> str:
    return os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "spatial")


def sp_spawn(mesh: str, seed: int) -> list[dict]:
    """Start the processes of `chip_smoke.py --sp-worker` for `mesh` on the
    one card (LOCAL_RANK 0 for all) and wait for them -> each rank's record;
    a rank that fails or outlasts SP_TIMEOUT fails the phase."""
    world = SP_MESHES[mesh]
    root = os.path.join(sp_root(), mesh)
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    env = {**os.environ, "MASTER_ADDR": "localhost", "MASTER_PORT": str(free_port()),
           "WORLD_SIZE": str(world), "LOCAL_RANK": "0"}
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--seed", str(seed),
                               "--sp-worker", mesh, "--out", root],
                              env={**env, "RANK": str(r)}, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    outs, deadline = [], time.monotonic() + SP_TIMEOUT
    try:
        for p in procs:
            try:
                outs.append(p.communicate(timeout=max(deadline - time.monotonic(), 1))[0])
            except subprocess.TimeoutExpired:
                p.kill()
                outs.append(p.communicate()[0] + f"\n(killed after {SP_TIMEOUT} s)")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    recs = []
    for r, (p, out) in enumerate(zip(procs, outs)):
        for line in out.strip().splitlines()[-30:]:
            print(f"[sp-{mesh} rank {r}] {line[:300]}")
        check(p.returncode == 0, f"--sp-worker {mesh} rank {r} exited {p.returncode}")
        with open(os.path.join(root, f"rank{r}.json")) as f:
            recs.append(json.load(f))
    return recs


def sp_worker(mesh_name: str, seed: int, root: str) -> int:
    """One rank of phase 19 (b), under the environment `sp_spawn` sets: joins
    the gloo group (`make_mesh(spatial=2, backend="gloo")`), takes its block
    of the 6 images (those of its data index, its 256 rows of them), dropout
    masks by data index, and the fp32 step-2 step through `make_step(mesh=)`
    with the launch and halo counts zeroed just before (its state saved for
    the parent); then 3 steps timed (wall ms, CUDA events) and one
    profiled."""
    import torch.distributed as dist

    from mdilss_tpu_torch.models.topology import shard_dropout_masks
    from mdilss_tpu_torch.parallel import halo as H
    from mdilss_tpu_torch.parallel import make_mesh, shard_height, shard_rows

    rank = int(os.environ["RANK"])
    dev = torch.device("cuda", 0)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    mesh = make_mesh(TRAIN_BATCH, spatial=2, device=dev, backend="gloo")
    want_data = SP_MESHES[mesh_name] // 2
    check(mesh.data == want_data and mesh.spatial == 2 and dist.get_backend() == "gloo",
          f"mesh {mesh}")
    student, teacher, images, labels, masks = train_setup(seed, dev, TRAIN_BATCH, HEIGHT, WIDTH)
    x = shard_height(shard_rows(images, mesh), mesh, 1).to(dev)
    y = shard_height(shard_rows(labels, mesh), mesh, 1).to(dev)
    masks = [shard_dropout_masks(m, mesh) for m in masks]
    _, step = make_step(student, mesh=mesh)
    ts = steps.init_train_state(student)
    sync(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    zero_launch_counts()
    H.CALLS = H.BYTES = 0
    ts, m = step(ts, teacher, x, y, masks, 1)
    sync(dev)
    rec = {"rank": rank, "data_index": mesh.data_index, "spatial_index": mesh.spatial_index,
           "shape": list(x.shape), "launches": launch_counts(),
           "halo_calls": H.CALLS, "halo_bytes": H.BYTES,
           "metrics": {k: float(v) for k, v in m.items()},
           "peak_memory_bytes": torch.cuda.max_memory_allocated(dev)}
    torch.save(dp_state(student, ts), os.path.join(root, f"rank{rank}.pt"))
    state = {"ts": ts}

    def one():
        state["ts"], _ = step(state["ts"], teacher, x, y, masks, 1)

    rec["wall_ms"] = time_ms(one, iters=3, warmup=0)
    rec["profile"] = profile_once(one, f"sp-{mesh_name}-rank{rank}", "one fp32 step-2 step")
    del state, one, ts, m
    dist.barrier()
    dist.destroy_process_group()
    with open(os.path.join(root, f"rank{rank}.json"), "w") as f:
        json.dump(rec, f, default=str)
    return 0


def sp_mesh_vs_one(mesh: str, ranks: list[dict], one: dict, params: list[str]) -> dict:
    """A mesh's ranks against the one-process step: the loss to 1e-5
    relative, every parameter within 1.1e-3 and at most 1% beyond 2e-5
    (tests/test_multichip.py:62-71), the running statistics to 1e-4, every
    rank bitwise rank 0, each rank's launches exactly a step's."""
    states = [torch.load(os.path.join(sp_root(), mesh, f"rank{r}.pt"))
              for r in range(len(ranks))]
    unequal = sorted({k for s in states[1:] for k in s if not torch.equal(s[k], states[0][k])})
    d = torch.cat([(states[0][k] - one[k]).abs().flatten() for k in params])
    running = max(float((states[0][k].double() - one[k].double()).norm()
                        / one[k].double().norm().clamp_min(1e-30)) for k in one if "running" in k)
    rec = {"max_abs_param_diff": float(d.max()), "frac_beyond_2e5": float((d > 2e-5).float().mean()),
           "max_running_rel": running, "ranks_unequal": unequal,
           "loss": ranks[0]["metrics"]["loss"]}
    return rec


def phase_spatial(seed: int, dev: torch.device) -> dict:
    """Phase 19: the spatial axis (ROADMAP A11; cuDNN deterministic). (a) one
    process: K2's whole stats window bitwise the call without one, and K1 /
    K2 / K3 on padded slabs of the encoder's 1/8 maps against the whole
    calls; (b) the fp32 step-2 step at 6x512x1024 on a 1x2 mesh (2
    processes) and a 2x2 mesh (4 processes), gloo, all on the one card,
    against this process's step."""
    t_phase = time.perf_counter()
    rec = {"kernels": phase_spatial_kernels(seed, dev)}
    rec["meshes"] = {m: sp_spawn(m, seed + 930) for m in SP_MESHES}
    student, teacher, images, labels, masks = train_setup(seed + 930, dev, TRAIN_BATCH, HEIGHT,
                                                          WIDTH)
    _, step = make_step(student)
    old = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        ts, m = step(steps.init_train_state(student), teacher, images.to(dev), labels.to(dev),
                     masks, 1)
        sync(dev)
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = old
    one, loss_one = dp_state(student, ts), float(m["loss"])
    params = [k for k, _ in student.named_parameters()]
    card = card_line()
    rec["vs_one"] = {}
    for mesh, ranks in rec["meshes"].items():
        v = rec["vs_one"][mesh] = sp_mesh_vs_one(mesh, ranks, one, params)
        rel_loss = abs(v["loss"] - loss_one) / abs(loss_one)
        print(f"[spatial] {mesh} (gloo, {len(ranks)} processes on this card) vs one process: "
              f"loss {v['loss']:.6f} vs {loss_one:.6f} (rel {rel_loss:.2e}); parameters max "
              f"|diff| {v['max_abs_param_diff']:.3e}, {100 * v['frac_beyond_2e5']:.3f}% beyond "
              f"2e-5; running statistics max rel {v['max_running_rel']:.2e}; ranks unequal "
              f"{len(v['ranks_unequal'])}")
        check(rel_loss <= 1e-5, f"{mesh} loss {v['loss']} vs {loss_one}")
        check(v["max_abs_param_diff"] <= 1.1e-3 and v["frac_beyond_2e5"] <= 0.01,
              f"{mesh} parameters: {v['max_abs_param_diff']}, {v['frac_beyond_2e5']}")
        check(v["max_running_rel"] <= 1e-4, f"{mesh} running statistics {v['max_running_rel']}")
        check(not v["ranks_unequal"], f"{mesh}: the ranks differ: {v['ranks_unequal'][:5]}")
        for r in ranks:
            p = r["profile"]
            print(f"[spatial] {card}: {mesh} rank {r['rank']} (data {r['data_index']}, spatial "
                  f"{r['spatial_index']}, block {r['shape']}): launches {r['launches']} "
                  f"(expected {STEP_LAUNCHES}); halo collectives {r['halo_calls']}, "
                  f"{r['halo_bytes'] / 2**20:.3f} MiB per step; step wall {r['wall_ms']:.3f} ms, "
                  f"busy {p['device_ms']:.3f} ms, idle share {p['idle_share']:.3f}; peak "
                  f"{r['peak_memory_bytes'] / 2**30:.3f} GiB")
            check(r["launches"] == STEP_LAUNCHES, f"{mesh} rank {r['rank']}: {r['launches']}")
    shutil.rmtree(sp_root(), ignore_errors=True)
    rec["seconds"] = time.perf_counter() - t_phase
    print(f"[spatial] phase 19 in {rec['seconds']:.1f} s")
    return rec


def sp_launches(rec: dict, k: str) -> dict:
    """The kernels-line keys of kernel `k` on phase 19's meshes, per rank."""
    return {f"launches_spatial_{mesh}_rank{r['rank']}": r["launches"][k]
            for mesh, ranks in rec["meshes"].items() for r in ranks}


def k3_kind_totals(blocks: list[dict]) -> dict:
    """K3's device ms per launch kind summed over the 34 pair calls of one
    student backward (None if a kind was not measured), with each kind's
    bound (k3_kind_bounds) where it has one."""
    out = {}
    for k in K3_KINDS:
        ms = [r[f"bwd_{k}_ms"] for r in blocks]
        rec = {"device_ms": None if any(v is None for v in ms)
               else sum(r["count"] * v for r, v in zip(blocks, ms))}
        if f"bwd_{k}_bound_ms" in blocks[0]:
            ops = sum(r["count"] * r[f"bwd_{k}_ops_ms"] for r in blocks)
            rec["bound_ms"] = sum(r["count"] * r[f"bwd_{k}_bound_ms"] for r in blocks)
            rec["bound_by"] = "operations" if ops >= rec["bound_ms"] - 1e-12 else "bytes"
        out[k] = rec
    return out


def bf16_entry(rec: dict, kind: str) -> dict:
    """The bf16 block of K2's ("fwd") or K3's ("bwd") kernels-line entry: its
    bf16 launches on each path phase 16 drives, and its times summed over the
    34 pair calls of one student forward (K2) or backward (K3) at 6x512x1024
    bf16."""
    blocks, k = rec["times"], "K2" if kind == "fwd" else "K3"
    t_ops = sum(r["count"] * r[f"{kind}_flops"] / PEAK_FLOPS["bf16"] for r in blocks)
    t_bytes = sum(r["count"] * r[f"{kind}_bytes"] / PEAK_BYTES for r in blocks)
    keys = ("y", "stats") if kind == "fwd" else ("du", "dw31", "db31", "dw13", "drap")
    cases = rec["kernel_cases"]
    total = lambda key: sum(r["count"] * r[f"{kind}_{key}"] for r in blocks)  # noqa: E731
    return {
        "kernels": list(PAIR_KINDS[kind, "bf16"].values()),
        "launches_step2": rec["step2"]["launches_bf16"][k],
        "launches_step3": rec["step3"]["launches_bf16"][k],
        "launches_cli_chain": rec["cli_chain"]["launches_bf16"][k],
        "max_rel_l2_vs_plain": max(c["rel_l2_vs_plain"][o] for c in cases for o in keys
                                   if o in c["rel_l2_vs_plain"]),
        "max_abs_err": max(c["max_abs_err_vs_plain"][o] for c in cases for o in keys
                           if o in c["max_abs_err_vs_plain"] and o != "stats"),
        "max_rel_l2_vs_f64": max(c["rel_l2_vs_f64"][o] for c in cases for o in keys
                                 if o in c["rel_l2_vs_f64"]),
        "ms": total("ms"), "plain_ms": total("plain_ms"), "bound_ms": total("bound_ms"),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": None,
        **({"wgrad_library_ms": total("wgrad_library_ms")} if kind == "bwd" else {}),
        "device_ms_by_kind": {
            kk: None if any(r[f"{kind}_{kk}_ms"] is None for r in blocks)
            else total(f"{kk}_ms") for kk in PAIR_KINDS[kind, "bf16"]},
        **({"bound_ms_by_kind": {kk: total(f"{kk}_bound_ms") for kk in K3_BOUND_KINDS},
            "ops_ms_by_kind": {kk: total(f"{kk}_ops_ms") for kk in K3_BOUND_KINDS}}
           if kind == "bwd" else {}),
        "at": f"sum over the 34 pair calls (17 blocks x 2) of one student "
              f"{'forward' if kind == 'fwd' else 'backward'} at 6x512x1024 bfloat16",
    }


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
        else sum(r["count"] * r[f"{kind}_{k}_ms"] for r in blocks) for k in PAIR_KINDS[kind, "f32"]}
    if kind == "bwd":
        extra["bound_ms_by_kind"] = {k: sum(r["count"] * r[f"bwd_{k}_bound_ms"] for r in blocks)
                                     for k in K3_BOUND_KINDS}
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
    ap.add_argument("--dp-worker", choices=("nccl", "step"), default=None,
                    help="(phase 18 starts these) one rank of the two on the card; --out is "
                         "its directory")
    ap.add_argument("--sp-worker", choices=tuple(SP_MESHES), default=None,
                    help="(phase 19 starts these) one rank of a spatial mesh on the card; "
                         "--out is its directory")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card", file=sys.stderr)
        return 2
    if args.dp_worker:
        return dp_worker(args.dp_worker, args.seed, args.out)
    if args.sp_worker:
        return sp_worker(args.sp_worker, args.seed, args.out)
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
    trainer = phase_trainer(args.seed, dev, train_times["img_per_s"])
    cli_chain = phase_cli_chain(args.seed, dev)
    chain_root = cli_chain.pop("root")
    slice10 = phase_slice10(args.seed, dev, chain_root)
    ablations = phase_ablations(args.seed, dev, chain_root)
    bf16 = phase_bf16(args.seed, dev)
    remat = phase_remat(args.seed, dev)
    dp = phase_data_parallel(args.seed, dev)
    sp = phase_spatial(args.seed, dev)
    glue = glue_bound()
    print(f"[glue-bound] K4 glue at {TRAIN_BATCH}x{HEIGHT}x{WIDTH} f32, bytes at "
          f"{PEAK_BYTES / 1e12} TB/s: {glue['fwd_bwd_ms']:.3f} ms per student forward and "
          f"backward, {glue['fwd_ms']:.3f} per forward alone; {glue['step2_ms']:.3f} ms per "
          f"step-2 step ({glue['blocks_step2']} blocks), {glue['step3_ms']:.3f} per step-3 batch "
          f"({glue['blocks_step3']} blocks, {glue['blocks_step3_with_backward']} with a backward)")
    card = card_line()

    kernels = {"kernels": [{
        "name": "nb1d_infer", "route": "cuda", "source": "mdilss_tpu_torch/csrc/nb1d_infer.cu",
        "replaces": "mdilss_tpu/ops/pallas/nb1d.py:94",
        "launches": main_path["launches"],
        "launches_train_path": train_path["launches"]["K1"],
        "launches_step3_path": step3_path["launches"]["K1"],
        "launches_eval_step": other_steps["eval"]["launches"]["K1"],
        "launches_trainer_path": trainer["launches"]["K1"],
        "launches_step3_trainer": trainer["step3"]["launches"]["K1"],
        "launches_evaluate_checkpoint": trainer["evaluate_checkpoint"]["launches"]["K1"],
        "launches_cli_chain": cli_chain["launches"]["K1"],
        "launches_cli_eval": sum(e["launches"]["K1"] for e in cli_chain["eval"].values()),
        "launches_export": slice10["export"]["launches"],
        "launches_parity_check": slice10["parity_check"]["launches"]["K1"],
        "launches_ablation_chain": ablations["chain_launches"]["K1"],
        "launches_ablation_eval": ablations["eval"]["launches"]["K1"],
        "launches_ablation_export": ablations["export"]["launches"],
        "launches_ablation_steps": ablations["step_launches"]["K1"],
        "launches_bf16_step2": bf16["step2"]["launches_bf16"]["K1"],
        "launches_bf16_step3": bf16["step3"]["launches_bf16"]["K1"],
        "launches_bf16_cli_chain": bf16["cli_chain"]["launches_bf16"]["K1"],
        **remat_launches(remat, "K1"),
        **dp_launches(dp, "K1"),
        **sp_launches(sp, "K1"),
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
                    launches_ce_step=other_steps["ce"]["launches"]["K2"],
                    launches_trainer_path=trainer["launches"]["K2"],
                    launches_step3_trainer=trainer["step3"]["launches"]["K2"],
                    launches_cli_chain=cli_chain["launches"]["K2"],
                    launches_ablation_chain=ablations["chain_launches"]["K2"],
                    launches_ablation_steps=ablations["step_launches"]["K2"],
                    **remat_launches(remat, "K2"),
                    **dp_launches(dp, "K2"),
                    **sp_launches(sp, "K2"),
                    bf16=bf16_entry(bf16, "fwd")),
        kernel_entry("nb1d_train_bwd", "mdilss_tpu/ops/pallas/nb1d_train.py:258",
                     train_path["launches"]["K3"], train_cases,
                     ("du", "dw31", "db31", "dw13", "drap"), train_times["blocks"], "bwd",
                     launches_step3_path=step3_path["launches"]["K3"],
                     launches_ce_step=other_steps["ce"]["launches"]["K3"],
                     launches_trainer_path=trainer["launches"]["K3"],
                     launches_step3_trainer=trainer["step3"]["launches"]["K3"],
                     launches_cli_chain=cli_chain["launches"]["K3"],
                     launches_ablation_chain=ablations["chain_launches"]["K3"],
                     launches_ablation_steps=ablations["step_launches"]["K3"],
                     **remat_launches(remat, "K3"),
                     **dp_launches(dp, "K3"),
                     **sp_launches(sp, "K3"),
                     bf16=bf16_entry(bf16, "bwd"))]}
    record = {"card": card, "device": torch.cuda.get_device_name(0), "seed": args.seed,
              "torch": torch.__version__, "cuda": torch.version.cuda, "build": build,
              "kernel_cases": cases, "main_path": main_path, "times": times,
              "train_kernel_cases": train_cases, "train_blocks": train_blocks,
              "train_path": train_path, "train_times": train_times, "step3_path": step3_path,
              "other_steps": other_steps, "trainer": trainer, "cli_chain": cli_chain,
              "slice10": slice10, "ablations": ablations, "bf16": bf16, "remat": remat,
              "data_parallel": dp, "spatial": sp,
              "glue_bound": glue,
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
