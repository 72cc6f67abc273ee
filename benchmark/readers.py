"""What the per-layer metrics' readers (`benchmark/metrics/<name>.py`) share.
Each takes the traced run's record:

  rec["kind"]     "train" or "eval": the loop's kind;
  rec["config"], rec["traffic"]  the cell's files;
  rec["window"]   the window with the profiler off: "batches", "seconds",
                  "flops" (the model FLOPs of its batches);
  rec["trace"]    the profiled sub-window (`trace.read`): "batches",
                  "own_ms" (K1 / K2 / K3), "families", "launches" (the
                  port's counters over it); "busy_s", "window_s" from as
                  many batches traced with the device's activity alone
                  (`trace.busy`; on the CPU, those of the sub-window).

A reader returns None where its cell has nothing to read, and the harness
leaves the metric out.
"""
from __future__ import annotations

from benchmark import roofline

PASS_LAUNCHES = 34  # K1, K2 or K3 launches of one forward or backward: 17 blocks x 2 pairs


def _shape(rec):
    tr = rec["traffic"]
    return tr["batch"], tr["height"], tr["width"], rec["config"]["dtype"]


def mfu(rec, kind: str):
    """% of the card's peak for the dtype: the model FLOPs of the window's
    batches over their wall time."""
    w = rec["window"]
    if rec["kind"] != kind or not w["batches"]:
        return None
    peak = roofline.effective_peak_flops(rec["config"]["dtype"])
    return 100.0 * w["flops"] / (w["seconds"] * peak)


def device_idle(rec, kind: str):
    """% of the batches traced with the device's activity alone in which
    no device operation ran."""
    t = rec["trace"]
    if rec["kind"] != kind or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])


def per_batch_ms(rec, ms: float) -> float:
    return ms / rec["trace"]["batches"]


def k1_roofline(rec, kind: str):
    """K1's bound for the eval forwards it ran over its device time."""
    t = rec["trace"]
    if rec["kind"] != kind or not t["launches"]["K1"]:
        return None
    n, h, w, dt = _shape(rec)
    forwards = t["launches"]["K1"] / PASS_LAUNCHES
    return roofline.share(forwards * roofline.k1_forward_bound_ms(n, h, w, dt), t["own_ms"]["K1"])


def pair_roofline(rec, group: str, kind: str):
    """K2's ("fwd") or K3's ("bwd") bound for the passes it ran over its
    device time, its fixed-order sums included."""
    t = rec["trace"]
    if rec["kind"] != "train" or not t["launches"][group]:
        return None
    n, h, w, dt = _shape(rec)
    passes = t["launches"][group] / PASS_LAUNCHES
    return roofline.share(passes * roofline.student_pass_bound(n, h, w, kind, dt),
                          t["own_ms"][group])


def glue_roofline(rec):
    """The training glue's byte bound for the forwards and backwards the
    counters saw (K2 launches / 34 forwards, K3 launches / 34 of them with
    a backward) over its family's device time."""
    t = rec["trace"]
    if rec["kind"] != "train" or not t["launches"]["K3"]:
        return None
    n, h, w, dt = _shape(rec)
    g = roofline.glue_bound(n, h, w, dt)
    fwd, bwd = t["launches"]["K2"] / PASS_LAUNCHES, t["launches"]["K3"] / PASS_LAUNCHES
    bound = bwd * g["fwd_bwd_ms"] + (fwd - bwd) * g["fwd_ms"]
    return roofline.share(bound, t["families"].get(roofline.GLUE_FAMILY))


def family_ms(rec, family: str, kind: str):
    """Device ms per batch of one family of `roofline.FAMILIES`."""
    t = rec["trace"]
    if rec["kind"] != kind or family not in t["families"]:
        return None
    return per_batch_ms(rec, t["families"][family])
