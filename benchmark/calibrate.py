"""The readings that the limits of `correct` are set from, for one cell on
the card (or, with --device cpu and small sizes, for a rehearsal):

    python3 benchmark/calibrate.py --workload NAME --seeds 12 --controls 3 \
        --faults half_batch [--window 2] [--first-seed N] [--out FILE]

For each of `--seeds` seeds in one process: the cell's set-up and a window
of `--window` seconds (or `--batches` batches), the program's readings
against the plain reference; for the first `--controls` seeds
also the control, the reference with TF32 operands in the program's place;
and each fault of `--faults` (`faults.py`) planted under the timed path on
the first `--controls` seeds. Prints one JSON line per reading and, last,
per number the largest sound reading and the smallest of the control and of
each fault. Not part of a benchmark run.
"""
import argparse
import contextlib
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import torch  # noqa: E402

from benchmark import compare, faults, harness  # noqa: E402


def readings_of(cell, seed, device, window, fault=None):
    """A loop of `cell` set up and run for `window` seconds (or, an int,
    batches) with `fault` planted, or none, and its program readings (taken
    inside the fault, since the training readings drive batches after the
    window)."""
    with faults.planted(fault) if fault else contextlib.nullcontext():
        loop = cell.loop_class()(cell, seed, device)
        loop.setup()
        if isinstance(window, int):
            loop.run_batches(window)
        else:
            loop.window(window)
        prog = loop.program_readings()
    return loop, prog


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--first-seed", type=int, default=3_000_000_000)
    p.add_argument("--controls", type=int, default=3)
    p.add_argument("--faults", default="")
    p.add_argument("--window", type=float, default=2.0)
    p.add_argument("--batches", type=int, default=0,
                   help="run this many batches in place of the timed window (the same "
                        "batches again, for a look at one run's readings)")
    p.add_argument("--device", default="cuda")
    p.add_argument("--overrides", default="{}", help="JSON: traffic keys to replace")
    p.add_argument("--out")
    a = p.parse_args(argv)
    device = torch.device(a.device)
    cell = harness.Cell.load(ROOT, a.workload, json.loads(a.overrides))
    rows = []
    fault_names = [f for f in a.faults.split(",") if f]
    window = a.batches if a.batches else a.window
    for i in range(a.seeds):
        seed = a.first_seed + 7919 * i
        t0, first = time.perf_counter(), len(rows)
        loop, prog = readings_of(cell, seed, device, window)
        ref = loop.reference_readings(tf32=False)
        rows.append({"seed": seed, "who": "program", **loop.compare(prog, ref)})
        if loop.kind == "train":  # the look: which leaves the widest gaps come from
            for stage in ("setup", "window"):
                p, r = prog[stage], ref[stage]
                for key in ("moment", "change", "running"):
                    leaves = list(r["lrs"]) if key != "running" else list(r[key])
                    print(json.dumps({"seed": seed, "stage": stage, "worst": key,
                                      "leaves": compare.worst_leaves(p[key], r[key], leaves, 6)}),
                          file=sys.stderr, flush=True)
                for lr in sorted(set(r["lrs"].values())):
                    group = [k for k, v in r["lrs"].items() if v == lr]
                    print(json.dumps({"seed": seed, "stage": stage, "group_lr": lr,
                                      "leaves": len(group),
                                      "median_gap": compare.median_leaf_gap(p["change"],
                                                                            r["change"], group)}),
                          file=sys.stderr, flush=True)
        if i < a.controls:
            rows.append({"seed": seed, "who": "control",
                         **loop.compare(loop.reference_readings(tf32=True), ref)})
            for f in fault_names:
                # the reference follows the broken program's own batches and states
                bad, bprog = readings_of(cell, seed, device, window, f)
                rows.append({"seed": seed, "who": f,
                             **bad.compare(bprog, bad.reference_readings(tf32=False))})
                del bad, bprog
        del loop
        if device.type == "cuda":
            torch.cuda.empty_cache()
        for r in rows[first:]:
            print(json.dumps(r), flush=True)
        print(f"[calibrate] seed {seed}: {time.perf_counter() - t0:.1f} s", file=sys.stderr, flush=True)
    names = [k for k in rows[0] if k not in ("seed", "who")]
    summary = {"lower (largest sound)": {k: max(r[k] for r in rows if r["who"] == "program")
                                          for k in names}}
    for who in sorted({r["who"] for r in rows} - {"program"}):
        summary[f"{who} (smallest)"] = {k: min(r[k] for r in rows if r["who"] == who) for k in names}
    print(json.dumps({"workload": a.workload, "summary": summary}), flush=True)
    if a.out:
        os.makedirs(os.path.dirname(a.out) or ".", exist_ok=True)
        with open(a.out, "w") as f:
            json.dump({"workload": a.workload, "rows": rows, "summary": summary}, f, indent=1)


if __name__ == "__main__":
    main()
