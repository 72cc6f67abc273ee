#!/usr/bin/env python3
"""A bf16 step-2 step and a bf16 step-3 batch at 6x512x1024 of one or more
checkouts of the port, each in its own process, on one NVIDIA card.

    python3 tools_torch/bf16_steps.py ROOT [ROOT ...] [--out build/bf16_steps.json]

Each ROOT is a checkout (the repo, or a parent's `git archive` unpacked under
a git-ignored directory). For each, in the order given (list the parent first
and last, and this tree twice between, to read the spread), it runs its own
`chip_smoke.bf16_path` for both cells: the exact bf16 launches, the losses
against the fp32 step's, the frozen parameters and the teacher gated as in
phase 16, then ms (CUDA events), one profiled call (device busy ms, idle
share, kernels, device ms of K1 / K2 / K3 / the partial sums and K3 by launch
kind) and `ms_by_family`. Prints one line per checkout and cell; compare
device busy times, which the host does not move.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path


def measure(root: Path) -> dict:
    import os

    os.chdir(root)
    sys.path.insert(0, str(root))
    import torch

    import chip_smoke as cs

    dev = torch.device("cuda")
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    cs.phase_build()
    out = {"root": str(root), "card": cs.card_line()}
    for tag, setup, make, want, n, seed in (
            ("step2", cs.train_setup, cs.make_step, cs.STEP_LAUNCHES, 2, 500),
            ("step3", cs.step3_setup, cs.make_step3, cs.STEP3_LAUNCHES, 1, 510)):
        rec = cs.bf16_path(setup, make, want, n, tag, seed, dev)
        pr = rec["profile"]
        out[tag] = {"ms": rec["ms"], "busy_ms": pr["device_ms"], "idle_share": pr["idle_share"],
                    "kernels": pr["kernels_per_step"], "ms_by_group": pr["ms_by_group"],
                    "k3_ms_by_kind": pr["k3_ms_by_kind"], "ms_by_family": pr["ms_by_family"],
                    "peak_gib": rec["peak_memory_bytes"] / 2**30}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("roots", nargs="*", type=Path)
    ap.add_argument("--out", default="build/bf16_steps.json")
    ap.add_argument("--measure", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.measure:
        print(json.dumps(measure(args.measure.resolve())))
        return 0
    if not args.roots:
        ap.error("name at least one checkout")
    results = []
    for root in args.roots:
        proc = subprocess.run([sys.executable, __file__, "--measure", str(root.resolve())],
                              capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            print(proc.stdout[-2000:], proc.stderr[-4000:], file=sys.stderr)
            return proc.returncode
        rec = json.loads(proc.stdout.strip().splitlines()[-1])
        results.append(rec)
        for tag in ("step2", "step3"):
            r = rec[tag]
            print(f"{str(root):24s} bf16 {tag}: {r['ms']:.3f} ms, busy {r['busy_ms']:.3f} ms, "
                  f"idle share {r['idle_share']:.3f}, {r['kernels']} kernels, peak "
                  f"{r['peak_gib']:.2f} GiB; " + ", ".join(f"{k} {v:.3f}" for k, v in
                                                          r["ms_by_group"].items())
                  + "; families " + ", ".join(f"{k} {v:.2f}" for k, v in
                                              list(r["ms_by_family"].items())[:4]), flush=True)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(results, indent=1))
    print(results[0]["card"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
