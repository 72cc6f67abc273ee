"""The port's tracer: spans and a host-sync counter inside the program, and
torch.profiler windows of training steps (port of
mdilss_tpu/utils/profiling.py, which had the windows only).

Spans. `with span(name, **attrs):` marks one phase of the program at a layer
boundary (the step, its forwards, backward, optimizer, mode switches and
losses; the data transforms; the blocking host <-> device calls, `wait.*`);
`@spanned(name, **attrs)` marks a whole function. With tracing off, `span`
reads one module-level flag and returns a shared no-op, and a `spanned`
function reads the flag and calls through: nothing is recorded and
`record_function` is called nowhere. With tracing on
(`start_tracing` ... `stop_tracing`), each span appends

    (id, parent id, batch id, name, start_ns, end_ns, attrs or None)

to a list in memory; nothing is written during the run. The parent is the
innermost span open on the thread. The batch id advances at the first root
span (one with no parent) that opens after the last `batch` or `step` root
closed: a Trainer batch, or a step with the data spans its caller opened
before it, keeps one id. Times are `time.time_ns()`, the clock of
torch.profiler's chrome trace, whose `ts` counts microseconds after its
`baseTimeNanoseconds`, so the spans lie on the device trace's clock.
`start_tracing(annotate=True)` also enters `torch.profiler.record_function`
for each span, so a profiler's trace shows the program's phases over the
kernels (`StepTracer` does that for its window). `self_times` gives each
span's duration less its children's.

Host syncs (`start_tracing(syncs=True)`, the default with a CUDA card): the
tracer sets `torch.cuda.set_sync_debug_mode("warn")`, under which every
blocking host <-> device call (a pageable copy, `.item()`, an output whose
size the device decides) warns, shows each such warning every time
(Python's default shows a repeated warning once), and records for each its
time, the innermost span open on the thread and the warning's Python
file:line; `stop_tracing` restores both settings. A warning raised inside a
backward is handed to the calling thread when `torch.autograd.grad`
returns, so it lands in the backward's span, stamped at its end.

`StepTracer` traces a window of train steps with torch.profiler and writes
it as a chrome trace (chrome://tracing, Perfetto), with the program's spans
over it; the reference's only observability was wall-clock time printed
every 50 batches (train_RAPFT_step1.py:295-317).
"""
from __future__ import annotations

import functools
import itertools
import os
import re
import threading
import time
import warnings

BATCH_ROOTS = ("batch", "step")  # root spans that close a batch
SYNC_WARNING = "called a synchronizing CUDA operation"  # c10's text in "warn" mode

_on = False  # the flag every span reads
_rec = None  # the _Recorder while tracing is on


class _Off:
    """The shared no-op `span` returns while tracing is off."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Recorder:
    """What one tracing session records, and the settings it changed."""

    def __init__(self, annotate: bool):
        self.spans: list[tuple] = []
        self.syncs: list[tuple] = []
        self.ids = itertools.count(1)
        self.batch = 0
        self.batch_closed = True  # the next root span opens a batch
        self.local = threading.local()
        self.record_function = None
        if annotate:
            from torch.profiler import record_function

            self.record_function = record_function
            with record_function("start_tracing"):  # a process's first one costs ~1 ms
                pass
        self.catcher = None
        self.debug_mode = None

    def stack(self) -> list:
        s = getattr(self.local, "stack", None)
        if s is None:
            s = self.local.stack = []
        return s

    def show(self, previous):
        """A `warnings.showwarning` that records the sync warnings and hands
        every other warning to `previous`."""
        def show(message, category, filename, lineno, file=None, line=None):
            if SYNC_WARNING in str(message):
                stack = self.stack()
                self.syncs.append((time.time_ns(), stack[-1].id if stack else None,
                                   f"{filename}:{lineno}"))
            else:
                previous(message, category, filename, lineno, file, line)
        return show


class _Span:
    __slots__ = ("rec", "name", "attrs", "id", "parent", "batch", "start", "annotation")

    def __init__(self, rec: _Recorder, name: str, attrs: dict):
        self.rec, self.name, self.attrs = rec, name, attrs

    def __enter__(self):
        rec = self.rec
        stack = rec.stack()
        if stack:
            self.parent, self.batch = stack[-1].id, stack[-1].batch
        else:
            if rec.batch_closed:
                rec.batch += 1
                rec.batch_closed = False
            self.parent, self.batch = None, rec.batch
        self.id = next(rec.ids)
        stack.append(self)
        self.start = time.time_ns()
        self.annotation = None
        if rec.record_function is not None:
            self.annotation = rec.record_function(self.name)
            self.annotation.__enter__()
        return self

    def __exit__(self, *exc):
        rec = self.rec
        if self.annotation is not None:
            self.annotation.__exit__(*exc)
        end = time.time_ns()
        rec.stack().pop()
        if self.parent is None and self.name in BATCH_ROOTS:
            rec.batch_closed = True
        rec.spans.append((self.id, self.parent, self.batch, self.name, self.start, end,
                          self.attrs or None))
        return False


def span(name: str, **attrs):
    """A context manager that records one span while tracing is on; while it
    is off, the shared no-op."""
    if not _on:
        return _OFF
    return _Span(_rec, name, attrs)


def spanned(name: str, **attrs):
    """Decorator: every call of the function is one span while tracing is
    on (the flag is read at each call, not when decorating)."""
    def wrap(fn):
        @functools.wraps(fn)
        def traced(*args, **kwargs):
            if not _on:
                return fn(*args, **kwargs)
            with _Span(_rec, name, attrs):
                return fn(*args, **kwargs)
        return traced
    return wrap


def start_tracing(*, annotate: bool = False, syncs: bool | None = None) -> None:
    """Turn tracing on. `annotate`: each span also enters
    `torch.profiler.record_function`. `syncs` (default: a CUDA card is
    present): count host syncs. Raises RuntimeError if tracing is on."""
    global _on, _rec
    if _on:
        raise RuntimeError("tracing is already on")
    import torch

    rec = _Recorder(annotate)
    if syncs is None:
        syncs = torch.cuda.is_available()
    if syncs:
        rec.catcher = warnings.catch_warnings()
        rec.catcher.__enter__()
        warnings.filterwarnings("always", message=".*" + re.escape(SYNC_WARNING))
        warnings.showwarning = rec.show(warnings.showwarning)
        rec.debug_mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("warn")
    _rec, _on = rec, True


def stop_tracing() -> dict:
    """Turn tracing off and restore what `start_tracing` set. Returns
    {"spans": [(id, parent, batch, name, start_ns, end_ns, attrs)] in order
    of start, "syncs": [(time_ns, innermost span id or None, "file:line")]};
    empty lists if tracing was off."""
    global _on, _rec
    rec, _on, _rec = _rec, False, None
    if rec is None:
        return {"spans": [], "syncs": []}
    if rec.debug_mode is not None:
        import torch

        torch.cuda.set_sync_debug_mode(rec.debug_mode)
    if rec.catcher is not None:
        rec.catcher.__exit__(None, None, None)
    return {"spans": sorted(rec.spans, key=lambda s: s[4]), "syncs": rec.syncs}


def self_times(spans) -> dict:
    """{span id: its duration in ns less the durations of its child spans}
    (a thread's spans nest, so its children never overlap)."""
    own = {s[0]: s[5] - s[4] for s in spans}
    for s in spans:
        if s[1] in own:
            own[s[1]] -= s[5] - s[4]
    return own


class StepTracer:
    """Traces steps [start, start + n) of the first epoch it sees and writes
    `<logdir>/trace.json`, with the program's spans as user annotations
    (tracing on for the window, unless it already was). `sync` (optional;
    the trainer passes a CUDA synchronize on the card) is called before the
    profiler stops, so the traced steps' device work has finished."""

    def __init__(self, logdir: str | None, *, start: int = 2, n: int = 8, sync=None):
        self.logdir = logdir
        self.start = start
        self.n = n
        self.sync = sync
        self._step = 0
        self._prof = None
        self._spans = False
        self._done = logdir is None

    def tick(self) -> None:
        """Call once per train step, before launching it."""
        if self._done:
            return
        if self._step == self.start:
            import torch
            from torch.profiler import ProfilerActivity, profile

            if not _on:
                start_tracing(annotate=True, syncs=False)
                self._spans = True
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
            if self._spans:
                stop_tracing()
                self._spans = False
            self._prof.__exit__(None, None, None)
            os.makedirs(self.logdir, exist_ok=True)
            path = os.path.join(self.logdir, "trace.json")
            self._prof.export_chrome_trace(path)
            self._prof = None
            print(f"profiler trace written to {path}")
        self._done = True
