#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (mdilss_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py [--seed 0] [--out build/chip_smoke.json]

Phases, each fatal on failure (non-zero exit):
  1. build every CUDA source of the port with nvcc (sm_90a) and print what
     ptxas reports (registers, shared memory, spills);
  2. hold each kernel against its plain PyTorch version on the card at the
     serving path's real widths (batch 1 and 6, float32 with TF32 off and
     bfloat16, random weights and BN statistics, plus one ragged shape);
  3. drive the serving path of the 3-task ERFNet-RAP [20, 20, 27] at 512x1024
     from random weights made with --seed: every head, batch 1 and 6, bf16
     and fp32, logits and labels, and 8 uint8 images per head through
     serve_batches; the kernel launch counts are zeroed before this phase and
     must grow by 17 blocks x 2 launches per forward; the fp32 logits are
     compared with the same weights run on the CPU (plain versions) and the
     bf16 labels with the fp32 labels;
  4. time each nb1d block shape (kernel, plain version, bound) and the whole
     forward with CUDA events, then profile a few forwards (torch.profiler)
     for the device's busy share and its time by kernel.
It prints the card's name and power limit, one `kernels` JSON line and, as
the last line, {"ok": true, "device": {...}}. The full record goes to --out.
Without a CUDA card it exits 2 and prints no result.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from mdilss_tpu_torch import serving
from mdilss_tpu_torch.models import ERFNetRAP
from mdilss_tpu_torch.models.blocks import NonBottleneck1d, NonBottleneck1dRAP
from mdilss_tpu_torch.ops import _build
from mdilss_tpu_torch.ops import nb1d_infer as K

NUM_CLASSES = [20, 20, 27]
HEIGHT, WIDTH = 512, 1024
BATCHES = (1, 6)
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
# kernel vs plain, relative L2: fp32 sums in another order; in bf16 the plain
# version rounds every conv output while the kernel keeps c in fp32
TOL_REL_L2 = {"f32": 1e-5, "bf16": 2e-2}
TOL_CPU_REL_L2 = 1e-4  # fp32 forward on the card vs on the CPU, ~40 layers deep
MIN_LABEL_AGREEMENT = 0.995
# H100 SXM dense peaks (NVIDIA data sheet): fp32 on the CUDA cores (what the
# fp32 kernel and its plain version use), bf16 on the tensor cores; HBM3.
PEAK_FLOPS = {"f32": 67e12, "bf16": 989e12}
PEAK_BYTES = 3.35e12
LAUNCHES_PER_FORWARD = 17 * K.LAUNCHES_PER_BLOCK
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
    got, want = got.double(), want.double()
    return float((got - want).norm() / want.norm())


def block_bound(n: int, spec, dt: str) -> dict:
    """Least time for one block: each input byte read once and each output
    byte written once (x, weights, per-channel vectors; out), against the
    FLOPs of the two conv pairs, at the card's peak rates for the type."""
    _, c, _, rap, h, w, _ = spec
    px, item = n * h * w, torch.finfo(DTYPES[dt]).bits // 8
    flops = px * (28 if rap else 24) * c * c  # 2 x (3C^2 + 3C^2 [+ C^2]) MACs per pixel
    nbytes = item * (2 * px * c + 12 * c * c + (2 * c * c if rap else 0)) + 4 * 6 * c
    t_ops, t_bytes = flops / PEAK_FLOPS[dt], nbytes / PEAK_BYTES
    return {"flops": flops, "bytes": nbytes, "bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


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
                row = {"block": name, "count": count, "shape": [n, h, w, c], "dtype": dt,
                       "kernel_ms": time_ms(lambda: K.nb1d_infer(x, ops, d)),
                       "plain_ms": time_ms(lambda: K.nb1d_infer_plain(x, ops, d)),
                       **block_bound(n, spec, dt)}
                blocks.append(row)
                print(f"[time] {name} [{n},{h},{w},{c}] {dt}: kernel {row['kernel_ms']:.4f} ms, "
                      f"plain {row['plain_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
                      f"({row['bound_by']})")
    forward = []
    for dt, dtype in DTYPES.items():
        fn = serving.build_infer_fn(model, len(NUM_CLASSES) - 1, output="labels",
                                    compute_dtype=dtype)
        for n in BATCHES:
            x = imgs[n].to(dev)
            ms = time_ms(lambda: fn(x), iters=10, warmup=2)
            sums = {k: sum(r[k] * r["count"] for r in blocks if r["dtype"] == dt
                           and r["shape"][0] == n) for k in ("kernel_ms", "plain_ms", "bound_ms")}
            forward.append({"dtype": dt, "batch": n, "forward_ms": ms, "img_per_s": n * 1e3 / ms,
                            "nb1d_kernel_ms": sums["kernel_ms"],
                            "nb1d_plain_ms": sums["plain_ms"], "nb1d_bound_ms": sums["bound_ms"]})
            print(f"[time] forward {n}x{HEIGHT}x{WIDTH} {dt} (labels, head "
                  f"{len(NUM_CLASSES) - 1}): {ms:.3f} ms, {n * 1e3 / ms:.2f} img/s; 17 nb1d "
                  f"blocks: kernel {sums['kernel_ms']:.3f} ms, plain {sums['plain_ms']:.3f} ms, "
                  f"bound {sums['bound_ms']:.4f} ms")
    return {"blocks": blocks, "forward": forward}


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
            nb1d_ms = sum(v for k, v in by_name.items() if "nb1d_pair_kernel" in k)
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
    card = card_line()

    b1 = [r for r in times["blocks"] if r["dtype"] == "bf16" and r["shape"][0] == 1]
    t_ops = sum(r["count"] * r["flops"] / PEAK_FLOPS["bf16"] for r in b1)
    t_bytes = sum(r["count"] * r["bytes"] / PEAK_BYTES for r in b1)
    kernels = {"kernels": [{
        "name": "nb1d_infer", "route": "cuda", "source": "mdilss_tpu_torch/csrc/nb1d_infer.cu",
        "replaces": "mdilss_tpu/ops/pallas/nb1d.py:94",
        "launches": main_path["launches"],
        "max_abs_err": max(c["max_abs_err"] for c in cases),
        "max_rel_l2": {dt: max(c["rel_l2"] for c in cases if c["dtype"] == dt) for dt in DTYPES},
        "ms": sum(r["count"] * r["kernel_ms"] for r in b1),
        "plain_ms": sum(r["count"] * r["plain_ms"] for r in b1),
        "bound_ms": sum(r["count"] * r["bound_ms"] for r in b1),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": None,
        "at": "sum over the 17 nb1d blocks of one 1x512x1024 bf16 forward (2 launches each)",
    }]}
    record = {"card": card, "device": torch.cuda.get_device_name(0), "seed": args.seed,
              "torch": torch.__version__, "cuda": torch.version.cuda, "build": build,
              "kernel_cases": cases, "main_path": main_path, "times": times,
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
