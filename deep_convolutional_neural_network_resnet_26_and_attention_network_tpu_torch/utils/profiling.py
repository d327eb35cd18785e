"""Tracing and profiling utilities.

Counterpart of ``utils/profiling.py`` in the JAX package, on
``torch.profiler``:

  * ``trace(logdir, device=...)``: a context manager that records host
    activity, and the card's kernels and copies when ``device`` is a CUDA
    device, and writes a Chrome trace (``trace_<pid>_<ns>.json``, viewable
    in Perfetto or ``chrome://tracing``) under ``logdir``;
  * ``annotate(name)``: a named span inside a trace;
  * ``StepTimer``: wall-clock per-step timing with warm-up skip and a
    percentile summary (the train loop's heartbeat), as in the JAX package;
  * ``memory_stats()``: each card's allocator counters in bytes.
"""

import contextlib
import os
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile, record_function


@contextlib.contextmanager
def trace(logdir: str, *, device=None):
    """Profile the block and write its Chrome trace under ``logdir``: host
    activity always, the card's activity too when ``device`` (a
    ``torch.device`` or its name) is a CUDA device."""
    activities = [ProfilerActivity.CPU]
    if device is not None and torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield logdir
    prof.export_chrome_trace(os.path.join(
        logdir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


def annotate(name: str):
    """Named span inside a trace (``torch.profiler.record_function``)."""
    return record_function(name)


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


def memory_stats() -> dict:
    """Per card, the caching allocator's counters whose name holds
    ``bytes`` (``torch.cuda.memory_stats``); empty without a card."""
    if not torch.cuda.is_available():
        return {}
    return {f"cuda:{i}": {k: int(v)
                          for k, v in torch.cuda.memory_stats(i).items()
                          if "bytes" in k}
            for i in range(torch.cuda.device_count())}
