"""Completion times of the batches of a window without a host sync: a CUDA
event recorded on the stream after each batch's last launch, read once the
window has closed. On the CPU (the tests) work is synchronous and the host
clock stands in."""
from __future__ import annotations

import statistics
import time

import torch


class Clock:
    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"

    def mark(self):
        if self.cuda:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            return e
        return time.perf_counter()

    def intervals_ms(self, start, marks: list) -> list[float]:
        """ms from `start` to the first mark and between consecutive marks."""
        pts = [start] + marks
        if self.cuda:
            return [a.elapsed_time(b) for a, b in zip(pts, pts[1:])]
        return [(b - a) * 1e3 for a, b in zip(pts, pts[1:])]


class Phases:
    """Where set-up goes: `phases("name")` closes the part that ran since the
    last call (the device synchronized first); `str(phases)` lists them."""

    def __init__(self, device: torch.device):
        self.device, self.t, self.parts = device, time.perf_counter(), []

    def __call__(self, name: str) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        self.parts.append((name, now - self.t))
        self.t = now

    def __str__(self) -> str:
        return ", ".join(f"{n} {s:.2f} s" for n, s in self.parts)


def p90(values: list[float]) -> float:
    """The 90th percentile (Python's `statistics.quantiles`, exclusive)."""
    if len(values) < 2:
        return values[0]
    return statistics.quantiles(values, n=10)[-1]
