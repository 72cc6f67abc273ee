#!/usr/bin/env python3
"""The eager serving forward of two checkouts of the port on one NVIDIA card:
its wall time, host CPU time, CUDA-event time and device busy time, and the
cost of one nb1d block call, to see what a change to the host side of the
forward costs.

    python3 tools_torch/serving_host.py ROOT_A ROOT_B [--rounds 2]
                                        [--out build/serving_host.json]

Each round measures ROOT_A, ROOT_B, ROOT_B, ROOT_A (so a drift of the card or
the host shows as a difference between the two runs of one root), each in a
fresh process that imports `mdilss_tpu_torch` from that root and builds its
kernels there. The forward is `serving.build_infer_fn(model, 2,
output="labels")` of a 3-task ERFNet-RAP [20, 20, 27] with random weights
from seed 0, bfloat16 (the serving default) at 1x512x1024 and 6x512x1024,
after 5 warm-up forwards:
  wall_ms       host clock per forward over a block of 10 back-to-back
                forwards and one synchronize, the median of 10 blocks;
  host_cpu_ms   the calling thread's CPU time (time.thread_time) per forward
                over the same blocks, the median: the host's own work, less
                moved by other processes than the wall clock;
  events_ms     CUDA events around all 100 forwards, per forward;
  device_ms     torch.profiler: the sum of the card's kernel, copy and fill
                times over 10 forwards, per forward;
  kernels       the card's kernels, copies and fills per forward;
  k1_launches   the nb1d kernel's launch count per forward.
And one nb1d block alone, `ops.nb1d_infer.nb1d_infer` on x [1, 16, 8, 8]
bf16 (a plain C = 16 block: the kernels take a few microseconds, so a call
costs what its host side costs): block_call_us and block_cpu_us, the median
per call of 10 blocks of 200 calls, host clock and thread CPU time.
`--measure ROOT` measures the package under ROOT alone and prints one JSON line.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

BATCHES = (1, 6)
WARMUP, BLOCKS, PER_BLOCK, PROFILED = 5, 10, 10, 10
CALL_BLOCKS, PER_CALL_BLOCK = 10, 200


def _timed_blocks(fn, blocks: int, per_block: int, sync) -> tuple[float, float]:
    """Median wall and thread-CPU seconds per call over `blocks` blocks of
    `per_block` calls, each block ended by `sync`."""
    wall, cpu = [], []
    for _ in range(blocks):
        t0, c0 = time.perf_counter(), time.thread_time()
        for _ in range(per_block):
            fn()
        sync()
        wall.append((time.perf_counter() - t0) / per_block)
        cpu.append((time.thread_time() - c0) / per_block)
    return statistics.median(wall), statistics.median(cpu)


def measure(root: str) -> dict:
    sys.path.insert(0, os.path.abspath(root))
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from mdilss_tpu_torch import serving
    from mdilss_tpu_torch.models import ERFNetRAP
    from mdilss_tpu_torch.models.blocks import NonBottleneck1d
    from mdilss_tpu_torch.ops import nb1d_infer as K

    dev = torch.device("cuda")
    torch.manual_seed(0)
    model = ERFNetRAP([20, 20, 27], 3, device=dev)
    fn = serving.build_infer_fn(model, 2, output="labels")
    rng = np.random.default_rng(0)
    out = {"root": os.path.abspath(root), "module": serving.__file__, "batches": {}}
    for n in BATCHES:
        x = torch.from_numpy(rng.random((n, 512, 1024, 3), dtype=np.float32)).to(dev)
        for _ in range(WARMUP):
            fn(x)
        torch.cuda.synchronize()
        before = K.LAUNCHES
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        wall, cpu = _timed_blocks(lambda: fn(x), BLOCKS, PER_BLOCK, torch.cuda.synchronize)
        end.record()
        torch.cuda.synchronize()
        launches = (K.LAUNCHES - before) / (BLOCKS * PER_BLOCK)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(PROFILED):
                fn(x)
            torch.cuda.synchronize()
        dev_events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        out["batches"][str(n)] = {
            "wall_ms": wall * 1e3, "host_cpu_ms": cpu * 1e3,
            "events_ms": start.elapsed_time(end) / (BLOCKS * PER_BLOCK),
            "device_ms": sum(e.time_range.elapsed_us() for e in dev_events) / 1e3 / PROFILED,
            "kernels": len(dev_events) / PROFILED, "k1_launches": launches}
    blk = NonBottleneck1d(16, 1).to(dev)
    ops = K.prepare_operands(blk, None, torch.bfloat16)
    xb = torch.randn(1, 16, 8, 8, device=dev).to(torch.bfloat16).contiguous(
        memory_format=torch.channels_last)
    for _ in range(WARMUP):
        K.nb1d_infer(xb, ops, 1)
    wall, cpu = _timed_blocks(lambda: K.nb1d_infer(xb, ops, 1), CALL_BLOCKS, PER_CALL_BLOCK,
                              torch.cuda.synchronize)
    out["block_call_us"], out["block_cpu_us"] = wall * 1e6, cpu * 1e6
    return out


def card_line() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60, check=True).stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("roots", nargs="*")
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--out", default="build/serving_host.json")
    ap.add_argument("--measure", default=None)
    args = ap.parse_args(argv)
    if args.measure:
        print(json.dumps(measure(args.measure)))
        return 0
    if len(args.roots) != 2:
        ap.error("give two roots: ROOT_A ROOT_B")
    a, b = args.roots
    card = card_line()
    runs = []
    for r in range(args.rounds):
        for root in (a, b, b, a):
            proc = subprocess.run([sys.executable, __file__, "--measure", root],
                                  capture_output=True, text=True, timeout=900)
            if proc.returncode != 0:
                print(proc.stdout + proc.stderr, file=sys.stderr)
                return proc.returncode
            row = json.loads(proc.stdout.strip().splitlines()[-1])
            row["round"] = r
            runs.append(row)
            print(f"[serving-host] round {r} {root}: " + "; ".join(
                f"{n}x512x1024 wall {v['wall_ms']:.3f} ms, host CPU {v['host_cpu_ms']:.3f} ms, "
                f"events {v['events_ms']:.3f} ms, device {v['device_ms']:.3f} ms, "
                f"{v['kernels']:.0f} kernels, {v['k1_launches']:.0f} K1"
                for n, v in row["batches"].items())
                + f"; one block call {row['block_call_us']:.2f} us (host CPU "
                f"{row['block_cpu_us']:.2f} us)", flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"card": card, "runs": runs}, f, indent=1)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
