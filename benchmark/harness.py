"""One run of one cell: set-up, the measured window, the traced sub-window,
the comparison that decides `correct`, and the result line.

Everything is found by name (`Cell.load`): the cell in `BENCHMARK.json`;
its configuration in the file that entry names; its traffic mix in
`benchmark/traffic/<traffic>.json`, which names its loop
(`benchmark/loops/<loop>.py`); the configuration's model in
`benchmark/models/<model>.py`; each per-layer metric's reader in
`benchmark/metrics/<metric>.py`; the limits of the comparison in
`benchmark/limits/<cell>.json`. A new cell, configuration, traffic mix or
metric is new files and entries; no file here changes.

A loop is a class `Loop(cell, seed, device)` with
  kind                "train" or "eval", which the metric readers read;
  launch_counters()   the port's kernel launch counters, {"K1", "K2", "K3"};
  setup()             everything before the first timed batch, the batches
                      whose outputs the comparison reads among them;
  window(seconds)     the measured window: {"batches", "seconds", "flops",
                      "attempted", "failed", "end_to_end": {metric: value}};
  run_batches(n)      n more batches as the window drives them;
  program_readings()  what the timed path produced, read once the window
                      has closed (a training loop drives its second
                      checked stretch there, on the window's objects);
                      frees the program's state;
  reference_readings(tf32)  the plain reference's, in float32 or (the
                      control) with TF32 operands;
  compare(prog, ref)  {number: reading}.
"""
from __future__ import annotations

import importlib.util
import json
import math
import os
import sys
import tempfile
import time
from dataclasses import dataclass, field
from pathlib import Path

import torch

from . import trace as trace_mod

FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "mdilss_tpu")
BENCHMARK_JSON = "BENCHMARK.json"


def load_file_module(path: Path, name: str):
    """The module in `path`, loaded under `name` (a file name may hold dots)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    """One entry of `workloads` with everything it names, read from `root`."""
    root: Path
    name: str
    chips: int
    config_name: str
    config: dict
    traffic_name: str
    traffic: dict
    limits: dict
    end_to_end: list = field(default_factory=list)  # the metric entries this cell reports
    per_layer: list = field(default_factory=list)

    @classmethod
    def load(cls, root, name: str, overrides: dict | None = None) -> "Cell":
        """The cell `name` of `root`/BENCHMARK.json; `overrides` replaces keys of
        its traffic mix (the tests' small sizes)."""
        root = Path(root)
        spec = json.loads((root / BENCHMARK_JSON).read_text())
        work = next((w for w in spec["workloads"] if w["name"] == name), None)
        if work is None:
            raise KeyError(f"no workload {name!r} in {root / BENCHMARK_JSON}: "
                           f"{[w['name'] for w in spec['workloads']]}")
        conf = next(c for c in spec["configs"] if c["name"] == work["config"])
        traffic = json.loads((root / "benchmark" / "traffic" / f"{work['traffic']}.json").read_text())
        traffic.update(overrides or {})
        limits_path = root / "benchmark" / "limits" / f"{name}.json"
        limits = json.loads(limits_path.read_text()) if limits_path.exists() else {}
        e2e = [m for m in spec["end_to_end"] if name in m.get("workloads", [name])]
        reported = {m["name"] for m in e2e}
        per_layer = [m for m in spec["per_layer"]
                     if (name in m["workloads"] if "workloads" in m else m["moves"] in reported)]
        return cls(root, name, work["chips"], conf["name"],
                   json.loads((root / conf["file"]).read_text()), work["traffic"], traffic,
                   limits, e2e, per_layer)

    def loop_class(self):
        path = self.root / "benchmark" / "loops" / f"{self.traffic['loop']}.py"
        return load_file_module(path, f"benchmark_loop_{self.traffic['loop']}").Loop

    def model_module(self):
        path = self.root / "benchmark" / "models" / f"{self.config['model']}.py"
        return load_file_module(path, f"benchmark_model_{self.config['model']}")

    def readers(self) -> list:
        """[(metric entry, read function)] of the cell's per-layer metrics."""
        out = []
        for m in self.per_layer:
            path = self.root / "benchmark" / "metrics" / f"{m['name']}.py"
            out.append((m, load_file_module(path, f"benchmark_metric_{m['name']}").read))
        return out


def list_cells(root) -> list[dict]:
    """Every cell of `root`/BENCHMARK.json with the files it was found by."""
    root = Path(root)
    spec = json.loads((root / BENCHMARK_JSON).read_text())
    out = []
    for w in spec["workloads"]:
        cell = Cell.load(root, w["name"])
        out.append({"name": cell.name, "config": cell.config_name, "traffic": cell.traffic_name,
                    "loop": cell.traffic["loop"], "model": cell.config["model"],
                    "end_to_end": [m["name"] for m in cell.end_to_end],
                    "per_layer": [m["name"] for m in cell.per_layer],
                    "limits": sorted(cell.limits)})
    return out


def forbidden_loaded() -> list[str]:
    """Loaded modules whose top-level name (before the first dot) is JAX's or
    the JAX package's, compared whole."""
    return sorted(n for n in sys.modules if n.split(".")[0] in FORBIDDEN_MODULES)


def judge(readings: dict, limits: dict) -> tuple[bool, dict]:
    """(every limited reading within its limit and finite, {name: {"value",
    "limit"}}) of the numbers that have a limit."""
    checks, ok = {}, True
    for name, limit in limits.items():
        value = readings.get(name)
        checks[name] = {"value": value, "limit": limit}
        ok = ok and value is not None and math.isfinite(value) and value <= limit
    return ok, checks


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def device_info(device: torch.device) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": 1,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}


def _chrome_events(prof) -> tuple[list, int]:
    """The profiler's chrome trace, written under TMPDIR, read and removed."""
    fd, path = tempfile.mkstemp(prefix="bench_trace_", suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        size = os.path.getsize(path)
        with open(path) as f:
            return json.load(f)["traceEvents"], size
    finally:
        os.remove(path)


def traced_batches(loop, n: int, device: torch.device) -> dict:
    """n batches under torch.profiler with Python stacks (the family table,
    the kernels' device ms and the breakdown), the program's launch counters
    around them; then, on a card, n more with the device's activity alone,
    between two marker operations, for the busy and window seconds: the
    stacks triple the host's share of a batch."""
    from torch.profiler import ProfilerActivity, profile, record_function

    counters = loop.launch_counters()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    sync(device)
    with profile(activities=acts, with_stack=True) as prof:
        with record_function(trace_mod.WINDOW_MARK):
            loop.run_batches(n)
            sync(device)
    after = loop.launch_counters()
    t0 = time.perf_counter()
    events, size = _chrome_events(prof)
    out = trace_mod.read(events)
    log(f"[bench] trace: {n} batches, {len(events)} events, {size / 2**20:.1f} MiB, "
        f"written and read in {time.perf_counter() - t0:.1f} s")
    out["batches"] = n
    out["launches"] = {k: after[k] - counters[k] for k in counters}
    per_batch = {**out["own_ms"], **out["families"]}
    log("[bench] device ms per batch: " + ", ".join(f"{k} {v / n:.3f}" for k, v in per_batch.items())
        + f"; launches per batch {({k: v / n for k, v in out['launches'].items()})}")
    out["stack_busy_s"], out["stack_window_s"] = out["busy_s"], out["window_s"]
    if device.type == "cuda":
        marker = torch.zeros(1, device=device)
        sync(device)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            marker.add_(1)  # opens the span on an idle device
            loop.run_batches(n)
            sync(device)
            marker.add_(1)  # closes it
            sync(device)
        events, _ = _chrome_events(prof)
        out.update(trace_mod.busy(events))
    log(f"[bench] device busy / window: {out['busy_s']:.4f} / {out['window_s']:.4f} s over "
        f"{n} batches with the device's activity alone; {out['stack_busy_s']:.4f} / "
        f"{out['stack_window_s']:.4f} s with host ops and stacks")
    return out


def run(cell: Cell, seed: int, seconds: float, traced: bool, device: torch.device,
        t0: float) -> dict:
    """One run of `cell`; returns the result object (the contract's keys, then
    "checks")."""
    loop = cell.loop_class()(cell, seed, device)
    if device.type == "cuda":
        torch.empty(0, device=device)  # the context and the allocator exist before the reset
        torch.cuda.reset_peak_memory_stats(device)
    log(f"[bench] imports and the device's context: {time.perf_counter() - t0:.2f} s")
    loop.setup()
    sync(device)
    setup_s = time.perf_counter() - t0
    log(f"[bench] {cell.name} seed {seed}: set-up {setup_s:.3f} s")
    win = loop.window(seconds)
    log(f"[bench] window: {win['batches']} batches in {win['seconds']:.3f} s")
    metrics, breakdown = {}, None
    if traced:
        tr = traced_batches(loop, int(cell.traffic["profile_batches"]), device)
        rec = {"cell": cell.name, "config": cell.config, "traffic": cell.traffic,
               "kind": loop.kind, "window": win, "trace": tr}
        for m, read in cell.readers():
            v = read(rec)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        breakdown = {"device_ops": tr["device_ops"], "idle_gaps": tr["idle_gaps"]}
    else:
        values = {"setup_s": setup_s, **win["end_to_end"]}
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    dev = device_info(device)  # the peak once the window and any traced batches are done
    if traced:
        dev["busy_s"], dev["window_s"] = tr["busy_s"], tr["window_s"]
    found = forbidden_loaded()
    if found:
        raise RuntimeError(f"modules of JAX or the JAX package are loaded: {found}")
    prog = loop.program_readings()  # frees the program's state
    ref = loop.reference_readings(tf32=False)
    readings = loop.compare(prog, ref)
    correct, checks = judge(readings, cell.limits)
    for k, v in readings.items():
        if k not in cell.limits:
            log(f"[bench] reading {k} = {v!r} (not compared)")
    result = {"correct": correct, "attempted": win["attempted"], "failed": win["failed"],
              "metrics": metrics, "device": dev}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    for k, c in checks.items():
        log(f"{k} {c['value']!r} limit {c['limit']!r}")
    return result
