"""The traced run's device trace: ``torch.profiler`` over the measured
window, reduced to what the per-layer readers need.

The benchmark marks its own spans (``span``) around its calls into the
port; the profiler records them with the host's operators and the card's
kernels, copies and sets. The Chrome trace is written to a temporary file,
read back and deleted. Device intervals are clipped to the window span.
"""

import contextlib
import json
import os
import tempfile

import torch
from torch.profiler import ProfilerActivity, profile, record_function

WINDOW = "bench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def span(name):
    """A named span of the benchmark's own (``bench.<name>``)."""
    return record_function("bench." + name)


class DeviceTrace:
    """The reduced trace of one window: ``ops`` the device intervals
    ``(start_us, end_us, name, cat)`` inside the window, ``host`` the main
    thread's operators and spans ``(start_us, end_us, name)``."""

    def __init__(self, events):
        win = [e for e in events if e.get("name") == WINDOW
               and e.get("cat") == "user_annotation"]
        if not win:
            raise RuntimeError("the trace holds no window span")
        w = win[0]
        self.t0, self.t1 = float(w["ts"]), float(w["ts"]) + float(w["dur"])
        self.window_s = (self.t1 - self.t0) * 1e-6
        self.ops = []
        self.host = []
        for e in events:
            if e.get("ph") != "X" or "dur" not in e:
                continue
            a, b = float(e["ts"]), float(e["ts"]) + float(e["dur"])
            if e.get("cat") in DEVICE_CATS:
                a, b = max(a, self.t0), min(b, self.t1)
                if b > a:
                    self.ops.append((a, b, e["name"], e["cat"]))
            elif e.get("cat") in ("cpu_op", "user_annotation") \
                    and e.get("tid") == w.get("tid"):
                self.host.append((a, b, e["name"]))
        self.ops.sort()
        self.busy = _union([(a, b) for a, b, _, _ in self.ops])
        self.busy_s = sum(b - a for a, b in self.busy) * 1e-6

    def durations(self, match):
        """The seconds of each device op whose name holds ``match``."""
        return [(b - a) * 1e-6 for a, b, n, _ in self.ops if match in n]

    def cat_seconds(self, cat, match=""):
        return sum((b - a) * 1e-6 for a, b, n, c in self.ops
                   if c == cat and match in n)

    def device_ops(self, top=10):
        """The device ops that took most time: ``[[name, seconds]]``."""
        total = {}
        for a, b, n, _ in self.ops:
            total[n] = total.get(n, 0.0) + (b - a) * 1e-6
        return [[n, s] for n, s in
                sorted(total.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top=10):
        """The longest stretches of the window with nothing on the card,
        each named by what the host's main thread was doing at its middle:
        the benchmark's innermost span, then the innermost operator."""
        gaps, t = [], self.t0
        for a, b in self.busy:
            if a > t:
                gaps.append((t, a))
            t = max(t, b)
        if self.t1 > t:
            gaps.append((t, self.t1))
        gaps.sort(key=lambda g: g[0] - g[1])
        out = []
        for a, b in gaps[:top]:
            mid = 0.5 * (a + b)
            around = sorted((e for e in self.host if e[0] <= mid <= e[1]),
                            key=lambda e: e[1] - e[0])
            spans = [n for _, _, n in around if n.startswith("bench.")
                     and n != WINDOW]
            ops = [n for _, _, n in around if not n.startswith("bench.")]
            name = " > ".join(x for x in (spans[:1] + ops[:1])) or "host"
            out.append([name, (b - a) * 1e-6])
        return out


def _union(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


@contextlib.contextmanager
def traced(device, result):
    """Profile the block, the host's operators and, on the card, its
    activity; on exit ``result["trace"]`` is the block's
    :class:`DeviceTrace`. The block must open the window span
    (``span("window")``)."""
    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    result["trace"] = DeviceTrace(events)
