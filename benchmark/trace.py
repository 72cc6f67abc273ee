"""Reading the profiler's chrome trace of the traced sub-window.

`read(events)` returns, over the span of the `WINDOW_MARK` annotation
(the sub-window's batches and the synchronize that ends them):

  busy_s, window_s  the union of device-operation intervals inside the
                    span and the span's length, in seconds;
  own_ms            device ms of the port's own kernels: K1, K2 and K3,
                    each fixed-order partial sum counted with the kernel
                    that launched just before it on its stream;
  kernel_ms         device ms by operation name;
  families          device ms outside K1/K2/K3 by the module that launched
                    it (`roofline.ms_by_family`);
  device_ops        the 10 operations that took most device time, [name, s];
  idle_gaps         the 10 longest stretches with no device operation,
                    named by the innermost host op or Python frame running
                    at their middle, [name, s].

`busy(events)` reads a trace of the device's activity alone (no host ops,
no stacks, so the profiler slows the host least): busy_s and window_s over
the span from its first device operation to the start of its last, the
markers that open and close it.
"""
from __future__ import annotations

from . import roofline

WINDOW_MARK = "benchmark.traced_window"
TOP = 10


def _own_group(name: str) -> str | None:
    for group, pats in (("K1", roofline.K1_KERNELS), ("K2", roofline.K2_KERNELS),
                        ("K3", roofline.K3_KERNELS)):
        if any(p in name for p in pats):
            return group
    return None


def _short(name: str) -> str:
    """A host span's name with the path before the repository's folders cut."""
    for root in ("mdilss_tpu_torch/", "benchmark/", "site-packages/", "lib/python"):
        i = name.find(root)
        if i >= 0:
            return name[i:][:160]
    return name[:160]


def _union(intervals) -> list[list[float]]:
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def _device_ops(events: list[dict]) -> list[dict]:
    return sorted((e for e in events if e.get("ph") == "X"
                   and e.get("cat") in roofline.DEVICE_CATS), key=lambda e: e["ts"])


def busy(events: list[dict]) -> dict:
    ops = _device_ops(events)
    if len(ops) < 2:
        raise RuntimeError("the device trace holds no markers around its span")
    w0, w1 = ops[0]["ts"], ops[-1]["ts"]
    merged = _union((e["ts"], min(e["ts"] + e.get("dur", 0.0), w1)) for e in ops[:-1])
    return {"busy_s": sum(b - a for a, b in merged) / 1e6, "window_s": (w1 - w0) / 1e6}


def read(events: list[dict]) -> dict:
    mark = next((e for e in events if e.get("ph") == "X" and e.get("name") == WINDOW_MARK
                 and e.get("cat") == "user_annotation"), None)
    if mark is None:
        raise RuntimeError(f"the trace holds no {WINDOW_MARK!r} annotation")
    w0, w1 = mark["ts"], mark["ts"] + mark["dur"]
    device = _device_ops(events)
    kernel_ms: dict[str, float] = {}
    own = {"K1": 0.0, "K2": 0.0, "K3": 0.0}
    last_by_stream: dict = {}
    intervals = []
    for e in device:
        a, b = max(e["ts"], w0), min(e["ts"] + e.get("dur", 0.0), w1)
        if b > a:
            intervals.append((a, b))
        ms = e.get("dur", 0.0) / 1e3
        name = e["name"]
        kernel_ms[name] = kernel_ms.get(name, 0.0) + ms
        stream = (e.get("pid"), e.get("tid"))
        group = _own_group(name)
        if group is None and roofline.PARTIAL_SUM_KERNEL in name:
            group = last_by_stream.get(stream)
        if group is not None:
            own[group] += ms
            last_by_stream[stream] = group
    merged = _union(intervals)
    busy_us = sum(b - a for a, b in merged)
    edges = [w0] + [x for ab in merged for x in ab] + [w1]
    gaps = sorted(((edges[i + 1] - edges[i], edges[i]) for i in range(0, len(edges), 2)
                   if edges[i + 1] > edges[i]), reverse=True)[:TOP]
    host = [e for e in events if e.get("ph") == "X"
            and e.get("cat") in ("cpu_op", "python_function") and e.get("tid") == mark.get("tid")]
    idle_gaps = []
    for dur, start in gaps:
        mid = start + dur / 2
        around = [e for e in host if e["ts"] <= mid <= e["ts"] + e.get("dur", 0.0)]
        inner = min(around, key=lambda e: e.get("dur", 0.0), default=None)
        idle_gaps.append([_short(inner["name"]) if inner else "no host op", dur / 1e6])
    families, _, _ = roofline.ms_by_family(events)
    top = sorted(kernel_ms.items(), key=lambda kv: -kv[1])[:TOP]
    return {"busy_s": busy_us / 1e6, "window_s": (w1 - w0) / 1e6, "own_ms": own,
            "kernel_ms": kernel_ms, "families": families,
            "device_ops": [[k[:160], v / 1e3] for k, v in top], "idle_gaps": idle_gaps}
