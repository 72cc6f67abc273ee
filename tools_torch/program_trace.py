#!/usr/bin/env python3
"""The program's own spans and host syncs over a benchmark cell's batches,
on the device trace's clock, and what the program's tracing costs, on one
NVIDIA card.

    python3 tools_torch/program_trace.py --workload step2_fp32 --seed N \\
        [--warm 10] [--batches 8] [--cost 10] [--out build/program_trace]

From the root of a checkout. It sets up the cell's loop as
`benchmark/run.py` does (`benchmark.harness.Cell`), then:
  1. a window of `--warm` seconds with tracing off, as the benchmark's
     window comes before its traced batches;
  2. `--batches` batches under torch.profiler with the device's activity
     alone, between two marker operations, tracing off: the device's busy
     and window seconds as `device_idle.*` reads them;
  3. as many batches again, the same way, with the program's tracing on
     (`mdilss_tpu_torch.utils.profiling`: its spans and the host-sync
     counter): the record below, which `host_ms`, `host_syncs` and
     `idle_drain` read, and the 10 longest idle gaps, each named by the
     innermost program span open when it opened;
  4. windows of `--cost` seconds with tracing off, on, off, on: the
     cell's end-to-end rate with the program's tracing on beside off.
Prints one JSON line and writes it, with the stage's spans and syncs, to
OUT/<cell>_<seed>.json.

The record is {"kind", "trace": {"batches", "program": {"spans", "syncs",
"base_ns", "busy", "window"}}}: the program's spans and syncs
(`profiling.stop_tracing`), the chrome trace's `baseTimeNanoseconds`, the
union of the device's busy intervals and the span between the two markers,
all in ns on `time.time_ns()`'s clock.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
TOP = 10
OUTSIDE = "outside the program"


def _gaps(busy: list, window: list) -> list[tuple[int, int]]:
    """The stretches of `window` that no busy interval covers, [(start, end)]."""
    out, t = [], window[0]
    for a, b in busy:
        if a > t:
            out.append((t, min(a, window[1])))
        t = max(t, b)
    if t < window[1]:
        out.append((t, window[1]))
    return [(a, b) for a, b in out if b > a]


def _innermost(spans: list, t: int):
    """The innermost span open at time `t` (the latest started of those
    open), or None."""
    inner = None
    for s in spans:
        if s[4] <= t < s[5] and (inner is None or s[4] >= inner[4]):
            inner = s
    return inner


def _program(rec: dict, kind: str):
    p = rec.get("trace", {}).get("program")
    return p if rec.get("kind") == kind and p else None


def host_ms(rec: dict, kind: str):
    """The host's own ms a batch: the root program spans' durations less the
    `wait.*` spans' inside them (no `wait.*` span holds another)."""
    p = _program(rec, kind)
    if p is None:
        return None
    spans = p["spans"]
    roots = sum(s[5] - s[4] for s in spans if s[1] is None)
    waits = sum(s[5] - s[4] for s in spans if s[3].startswith("wait."))
    return (roots - waits) / 1e6 / rec["trace"]["batches"]


def host_syncs(rec: dict, kind: str):
    """Host <-> device synchronizations a batch inside program spans."""
    p = _program(rec, kind)
    if p is None:
        return None
    return sum(1 for s in p["syncs"] if s[1] is not None) / rec["trace"]["batches"]


def idle_drain(rec: dict, kind: str):
    """% of the device's idle time in gaps that open while a `wait.*` span
    is open: the queue drained by a blocking call."""
    p = _program(rec, kind)
    if p is None:
        return None
    gaps = _gaps(p["busy"], p["window"])
    idle = sum(b - a for a, b in gaps)
    if idle <= 0:
        return None
    waits = [s for s in p["spans"] if s[3].startswith("wait.")]
    drained = sum(b - a for a, b in gaps if any(s[4] <= a < s[5] for s in waits))
    return 100.0 * drained / idle


READERS = {"host_ms": host_ms, "host_syncs": host_syncs, "idle_drain": idle_drain}


def readings(rec: dict) -> dict:
    """{"<reader>.<kind>": value} of every reader that finds something."""
    out = {}
    for kind in ("train", "eval"):
        for name, read in READERS.items():
            v = read(rec, kind)
            if v is not None:
                out[f"{name}.{kind}"] = v
    return out


def gap_table(rec: dict) -> dict:
    """The 10 longest idle gaps [[span name, ms]], each named by the
    innermost program span open when it opened; the idle ms a batch by that
    name; and the syncs a batch by innermost span name and call site."""
    p = rec["trace"]["program"]
    n = rec["trace"]["batches"]
    spans = p["spans"]
    by_id = {s[0]: s for s in spans}
    named = []
    for a, b in _gaps(p["busy"], p["window"]):
        s = _innermost(spans, a)
        named.append((s[3] if s else OUTSIDE, (b - a) / 1e6))
    idle_by: dict[str, float] = {}
    for name, ms in named:
        idle_by[name] = idle_by.get(name, 0.0) + ms / n
    syncs: dict[str, float] = {}
    for _, sid, site in p["syncs"]:
        key = f"{by_id[sid][3] if sid in by_id else OUTSIDE} @ {site}"
        syncs[key] = syncs.get(key, 0.0) + 1 / n
    return {"longest_gaps": [[k, ms] for k, ms in sorted(named, key=lambda g: -g[1])[:TOP]],
            "idle_ms_by_span": dict(sorted(idle_by.items(), key=lambda kv: -kv[1])),
            "syncs_by_site": dict(sorted(syncs.items(), key=lambda kv: -kv[1]))}


def span_table(rec: dict) -> dict:
    """Per span name: how many a batch, and their ms and self ms a batch."""
    from mdilss_tpu_torch.utils.profiling import self_times

    spans, n = rec["trace"]["program"]["spans"], rec["trace"]["batches"]
    own = self_times(spans)
    out: dict[str, dict] = {}
    for s in spans:
        row = out.setdefault(s[3], {"count": 0.0, "ms": 0.0, "self_ms": 0.0})
        row["count"] += 1 / n
        row["ms"] += (s[5] - s[4]) / 1e6 / n
        row["self_ms"] += own[s[0]] / 1e6 / n
    return dict(sorted(out.items(), key=lambda kv: -kv[1]["self_ms"]))


def _trace(run, device) -> dict:
    """run() under torch.profiler with the device's activity alone, between
    two marker operations: the trace's base, the union of the device's busy
    intervals and the markers' span, in ns on the host clock."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from benchmark import trace as trace_mod

    marker = torch.zeros(1, device=device)
    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        marker.add_(1)  # opens the span on an idle device
        run()
        torch.cuda.synchronize(device)
        marker.add_(1)  # closes it
        torch.cuda.synchronize(device)
    fd, path = tempfile.mkstemp(prefix="program_trace_", suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            doc = json.load(f)
    finally:
        os.remove(path)
    base = int(doc["baseTimeNanoseconds"])
    ops = trace_mod._device_ops(doc["traceEvents"])
    if len(ops) < 2:
        raise RuntimeError("the device trace holds no markers around its span")
    ns = lambda us: base + round(us * 1000)  # noqa: E731
    w0, w1 = ns(ops[0]["ts"]), ns(ops[-1]["ts"])
    busy = trace_mod._union((ns(e["ts"]), min(ns(e["ts"] + e.get("dur", 0.0)), w1))
                            for e in ops[:-1])
    return {"base_ns": base, "busy": busy, "window": [w0, w1]}


def _card() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"


def measure(workload: str, seed: int, warm: float, batches: int, cost: float,
            device=None, overrides: dict | None = None) -> dict:
    """The four stages above over `workload` on `device` (default the
    first card); `overrides` replaces keys of its traffic mix (the CPU
    tests' small sizes, with `_trace` replaced)."""
    import torch

    from benchmark import harness
    from mdilss_tpu_torch.utils import profiling

    device = device or torch.device("cuda", 0)
    cell = harness.Cell.load(ROOT, workload, overrides)
    loop = cell.loop_class()(cell, seed, device)
    t0 = time.perf_counter()
    loop.setup()
    harness.sync(device)
    out = {"cell": workload, "seed": seed, "card": _card(), "kind": loop.kind,
           "setup_s": time.perf_counter() - t0, "batches": batches}
    out["warm"] = loop.window(warm)["end_to_end"]

    off = _trace(lambda: loop.run_batches(batches), device)
    idle_ns = sum(b - a for a, b in _gaps(off["busy"], off["window"]))
    out["device_idle_off"] = 100.0 * idle_ns / (off["window"][1] - off["window"][0])

    def traced():
        profiling.start_tracing(syncs=True)
        try:
            loop.run_batches(batches)
        finally:
            program.update(profiling.stop_tracing())

    program = {}
    program.update(_trace(traced, device))
    rec = {"kind": loop.kind, "trace": {"batches": batches, "program": program}}
    w = program["window"]
    out["device_idle_on"] = 100.0 * sum(b - a for a, b in _gaps(program["busy"], w)) / (w[1] - w[0])
    out["readings"] = readings(rec)
    out.update(gap_table(rec))
    out["spans"] = span_table(rec)
    out["syncs_outside"] = sum(1 for s in program["syncs"] if s[1] is None) / batches
    for name, ms in out["longest_gaps"]:
        print(f"[program_trace] idle gap {ms:.3f} ms opened in {name}", file=sys.stderr)

    rates = {"off": [], "on": []}
    for mode in ("off", "on", "off", "on"):
        if mode == "on":
            profiling.start_tracing(syncs=True)
        try:
            e2e = loop.window(cost)["end_to_end"]
        finally:
            if mode == "on":
                profiling.stop_tracing()
        rates[mode].append(e2e)
    out["cost"] = rates
    key = "train_img_s" if loop.kind == "train" else "eval_img_s"
    off_rate = statistics.mean(r[key] for r in rates["off"])
    out["cost_pct"] = 100.0 * (1.0 - statistics.mean(r[key] for r in rates["on"]) / off_rate)
    out["record"] = rec
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--warm", type=float, default=10.0)
    ap.add_argument("--batches", type=int, default=8)
    ap.add_argument("--cost", type=float, default=10.0)
    ap.add_argument("--out", default="build/program_trace")
    args = ap.parse_args(argv)
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("no CUDA card: the device trace exists only on the card", file=sys.stderr)
        return 2
    out = measure(args.workload, args.seed, args.warm, args.batches, args.cost)
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, f"{args.workload}_{args.seed}.json"), "w") as f:
        json.dump(out, f)
    del out["record"]
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
