#!/usr/bin/env python3
"""What the custom op `mdilss::nb1d_infer` costs the host, on one NVIDIA card,
measured in one process against two other routes to the same code.

    python3 tools_torch/op_dispatch.py [--rounds 5] [--out build/op_dispatch.json]

Three routes to one CUDA implementation (ops/nb1d_infer.py `_nb1d_infer_cuda`:
the operand checks and two launches of K1's pair kernel):
  custom_op  torch.ops.mdilss.nb1d_infer, registered with
             torch.library.custom_op: the package's route;
  library    the same function registered under another namespace with a
             torch.library.Library (the schema, an implementation for the
             CUDA key and a fake), without custom_op's Python layers;
  direct     the Python function called directly: the route before the op.
Per route, the routes interleaved in a rotating order over --rounds rounds:
  block_us    one nb1d block call on x [1, 16, 8, 8] bf16 (a plain C = 16
              block: its kernels take a few microseconds, so a call costs its
              host side), host clock, the median per call of 10 blocks of 200
              calls, each block ended by a synchronize;
  forward_ms  the 1x512x1024 and 6x512x1024 bf16 serving forward
              (`serving.build_infer_fn(model, 2, output="labels")` of a 3-task
              ERFNet-RAP [20, 20, 27], random weights from seed 0) with every
              nb1d block on the route (`models.blocks.nb1d_infer` replaced),
              host clock, the median per forward of 10 blocks of 10 forwards,
              each ended by a synchronize; 34 K1 launches per forward checked.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

ROUTES = ("custom_op", "library", "direct")


def _median_per_call(fn, blocks: int, per_block: int, sync) -> float:
    out = []
    for _ in range(blocks):
        t0 = time.perf_counter()
        for _ in range(per_block):
            fn()
        sync()
        out.append((time.perf_counter() - t0) / per_block)
    return statistics.median(out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--out", default="build/op_dispatch.json")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from mdilss_tpu_torch import serving
    from mdilss_tpu_torch.models import ERFNetRAP, blocks
    from mdilss_tpu_torch.models.blocks import NonBottleneck1d
    from mdilss_tpu_torch.ops import nb1d_infer as K

    if not torch.cuda.is_available():
        print("op_dispatch: no CUDA device", file=sys.stderr)
        return 2
    lib = torch.library.Library("mdilss_probe", "DEF")
    lib.define("nb1d_infer" + K._SCHEMA)
    lib.impl("nb1d_infer", K._nb1d_infer_cuda, "CUDA")
    torch.library.register_fake("mdilss_probe::nb1d_infer", K._nb1d_infer_fake, lib=lib)
    routes = {
        "custom_op": K.nb1d_infer,
        "library": lambda x, ops, d: torch.ops.mdilss_probe.nb1d_infer(x, *ops, d),
        "direct": lambda x, ops, d: K._nb1d_infer_cuda(x, *ops, d),
    }

    dev = torch.device("cuda")
    sync = torch.cuda.synchronize
    blk = NonBottleneck1d(16, 1).to(dev)
    ops = K.prepare_operands(blk, None, torch.bfloat16)
    xb = torch.randn(1, 16, 8, 8, device=dev).to(torch.bfloat16).contiguous(
        memory_format=torch.channels_last)
    torch.manual_seed(0)
    model = ERFNetRAP([20, 20, 27], 3, device=dev)
    fn = serving.build_infer_fn(model, 2, output="labels")
    rng = np.random.default_rng(0)
    xs = {n: torch.from_numpy(rng.random((n, 512, 1024, 3), dtype=np.float32)).to(dev)
          for n in (1, 6)}
    want = {n: fn(xs[n]) for n in xs}
    rows = []
    for r in range(args.rounds):
        order = ROUTES[r % 3:] + ROUTES[:r % 3]
        for name in order:
            route = routes[name]
            for _ in range(5):
                route(xb, ops, 1)
            row = {"round": r, "route": name,
                   "block_us": 1e6 * _median_per_call(lambda: route(xb, ops, 1), 10, 200, sync)}
            blocks.nb1d_infer = route
            try:
                for n, x in xs.items():
                    before = K.LAUNCHES
                    got = fn(x)
                    sync()
                    if K.LAUNCHES - before != 34 or not torch.equal(got, want[n]):
                        raise RuntimeError(f"route {name}: {K.LAUNCHES - before} launches, "
                                           f"labels equal {torch.equal(got, want[n])}")
                    for _ in range(3):
                        fn(x)
                    row[f"forward_ms_batch{n}"] = 1e3 * _median_per_call(lambda: fn(x), 10, 10,
                                                                         sync)
            finally:
                blocks.nb1d_infer = K.nb1d_infer
            rows.append(row)
            print(f"[op-dispatch] round {r} {name}: block call {row['block_us']:.2f} us; "
                  f"forward {row['forward_ms_batch1']:.3f} ms (batch 1), "
                  f"{row['forward_ms_batch6']:.3f} ms (batch 6)", flush=True)
    summary = {name: {k: statistics.median(row[k] for row in rows if row["route"] == name)
                      for k in ("block_us", "forward_ms_batch1", "forward_ms_batch6")}
               for name in ROUTES}
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60,
                          check=True).stdout.strip().splitlines()[0]
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"card": card, "rows": rows, "median": summary}, f, indent=1)
    for name, v in summary.items():
        print(f"[op-dispatch] median over {args.rounds} rounds, {name}: block call "
              f"{v['block_us']:.2f} us; forward {v['forward_ms_batch1']:.3f} ms (batch 1), "
              f"{v['forward_ms_batch6']:.3f} ms (batch 6)")
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
