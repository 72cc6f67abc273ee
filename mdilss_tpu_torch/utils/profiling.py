"""Profiler tracing of training steps on torch.profiler (port of
mdilss_tpu/utils/profiling.py).

The reference's only observability was wall-clock time printed every 50
batches (train_RAPFT_step1.py:295-317). Here a window of train steps is
captured by torch.profiler (CPU ops and, on the card, CUDA kernels) and
written as a chrome trace (chrome://tracing, Perfetto).
"""
from __future__ import annotations

import os


class StepTracer:
    """Traces steps [start, start + n) of the first epoch it sees and writes
    `<logdir>/trace.json`. `sync` (optional; the trainer passes a CUDA
    synchronize on the card) is called before the profiler stops, so the
    traced steps' device work has finished."""

    def __init__(self, logdir: str | None, *, start: int = 2, n: int = 8, sync=None):
        self.logdir = logdir
        self.start = start
        self.n = n
        self.sync = sync
        self._step = 0
        self._prof = None
        self._done = logdir is None

    def tick(self) -> None:
        """Call once per train step, before launching it."""
        if self._done:
            return
        if self._step == self.start:
            import torch
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(ProfilerActivity.CUDA)
            self._prof = profile(activities=acts)
            self._prof.__enter__()
        elif self._step == self.start + self.n:
            self.stop()
        self._step += 1

    def stop(self) -> None:
        if self._prof is not None:
            if self.sync is not None:
                self.sync()
            self._prof.__exit__(None, None, None)
            os.makedirs(self.logdir, exist_ok=True)
            path = os.path.join(self.logdir, "trace.json")
            self._prof.export_chrome_trace(path)
            self._prof = None
            print(f"profiler trace written to {path}")
        self._done = True
