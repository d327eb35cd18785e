"""Tracing and profiling utilities.

Counterpart of ``utils/profiling.py`` in the JAX package, on
``torch.profiler``:

  * ``trace(logdir, device=...)``: a context manager that records host
    activity, and the card's kernels and copies when ``device`` is a CUDA
    device, and writes a Chrome trace (``trace_<pid>_<ns>.json``, viewable
    in Perfetto or ``chrome://tracing``) and the counters it recorded
    (``counters_<pid>_<ns>.json``) under ``logdir``;
  * ``annotate(name)``: a named span inside a trace, on the profiler's own
    clock (a ``record_function`` user annotation beside the card's
    records), and a shared no-op while no profiler records;
  * ``count(name, n)``, ``counters()``, ``reset_counters()``: process-wide
    counters that add up only while a profiler records;
  * ``StepTimer``: wall-clock per-step timing with warm-up skip and a
    percentile summary (the train loop's heartbeat), as in the JAX package.

The port's spans (``port.*``) and counters mark its layer boundaries:
staging, the transform, the extractor, the pool, the copies home and the
training window (PERF.md names each and the metric that reads it).
"""

import contextlib
import json
import os
import threading
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile, record_function

_NO_SPAN = contextlib.nullcontext()
_COUNTS = {}
_COUNTS_LOCK = threading.Lock()


@contextlib.contextmanager
def trace(logdir: str, *, device=None):
    """Profile the block and write its Chrome trace under ``logdir``: host
    activity always, the card's activity too when ``device`` (a
    ``torch.device`` or its name) is a CUDA device. The counters start at
    zero and are written beside the trace on exit."""
    activities = [ProfilerActivity.CPU]
    if device is not None and torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    reset_counters()
    with profile(activities=activities) as prof:
        yield logdir
    stamp = f"{os.getpid()}_{time.time_ns()}"
    prof.export_chrome_trace(os.path.join(logdir, f"trace_{stamp}.json"))
    with open(os.path.join(logdir, f"counters_{stamp}.json"), "w") as f:
        json.dump(counters(), f, indent=1, sort_keys=True)


def annotate(name: str):
    """Named span inside a trace (``torch.profiler.record_function``) while
    a profiler records on this thread; otherwise one shared no-op context,
    so that a span on the hot path costs one check."""
    if not torch.autograd._profiler_enabled():
        return _NO_SPAN
    return record_function(name)


def count(name: str, n: int = 1):
    """Add ``n`` to the counter ``name`` while a profiler records on this
    thread; otherwise nothing."""
    if torch.autograd._profiler_enabled():
        with _COUNTS_LOCK:
            _COUNTS[name] = _COUNTS.get(name, 0) + int(n)


def counters() -> dict:
    """A copy of the counters' totals."""
    with _COUNTS_LOCK:
        return dict(_COUNTS)


def reset_counters():
    with _COUNTS_LOCK:
        _COUNTS.clear()


class StepTimer:
    """Wall-clock step timing: ``with timer.step(): ...`` then
    ``timer.summary()`` -> dict of mean/p50/p90 seconds (after warmup)."""

    def __init__(self, warmup: int = 1):
        self.warmup = warmup
        self.times = []
        self._n = 0

    @contextlib.contextmanager
    def step(self):
        t0 = time.perf_counter()
        yield
        dt = time.perf_counter() - t0
        self._n += 1
        if self._n > self.warmup:
            self.times.append(dt)

    def summary(self) -> dict:
        if not self.times:
            return {"steps": 0}
        arr = np.asarray(self.times)
        return {
            "steps": int(arr.size),
            "mean_s": float(arr.mean()),
            "p50_s": float(np.percentile(arr, 50)),
            "p90_s": float(np.percentile(arr, 90)),
            "total_s": float(arr.sum()),
        }

