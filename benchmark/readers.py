"""What several per-layer readers (``metrics/<name>.py``) compute alike.
Each takes the traced run (``run.trace`` a ``tracing.DeviceTrace``,
``run.window_s`` the window's host seconds, ``run.counts`` the work the
benchmark counted in it, ``run.cfg`` the configuration) and returns a
number, or None where it finds nothing to read."""

from . import flops, peaks


def idle_percent(run):
    tr = run.trace
    if tr.window_s <= 0 or not tr.ops:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)


def mfu_percent(run):
    """The analytic FLOPs of the work completed in the window over the
    window's seconds at the peak of the configuration's precision."""
    if run.counts["flops"] <= 0 or run.window_s <= 0:
        return None
    peak = peaks.FLOPS[run.cfg["precision"]]
    return 100.0 * run.counts["flops"] / (run.window_s * peak)


def h2d_ms_per_ktile(run):
    s = run.trace.cat_seconds("gpu_memcpy", "HtoD")
    if s <= 0 or run.counts["tiles"] <= 0:
        return None
    return s * 1e3 / (run.counts["tiles"] / 1000.0)


def pool_roofline_percent(run, kernel, cost, key):
    """The mean least time of a launch of ``kernel`` in the window (its
    operations at the float32 peak or its bytes at the memory's, the
    larger, for the tile count the benchmark gave each launch) over the
    mean device time of a launch the trace recorded. The profiler can lose
    a share of a window's records (PERF.md), so the two means are
    taken apart; where none is lost they are the sums' ratio."""
    secs = run.trace.durations(kernel)
    tiles = run.counts[key]
    if not secs or not tiles:
        return None
    K, O = run.cfg["K"], run.cfg["O"]
    least = sum(peaks.roofline_s(*cost(t, K, O), "f32") for t in tiles)
    return 100.0 * (least / len(tiles)) / (sum(secs) / len(secs))


def pool_fwd_roofline(run):
    return pool_roofline_percent(run, "gated_pool_fwd_kernel",
                                 flops.pool_fwd_cost, "pool_fwd_T")


def pool_bwd_roofline(run):
    return pool_roofline_percent(run, "gated_pool_bwd_kernel",
                                 flops.pool_bwd_cost, "pool_bwd_T")


# kernels that only move data between layouts: cuDNN's channel padding
# and its NCHW <-> NHWC conversions
LAYOUT_KERNELS = ("nhwcAddPaddingKernel", "nchwToNhwcKernel",
                  "nhwcToNchwKernel", "nchwAddPaddingKernel")


def layout_percent(run):
    tr = run.trace
    if tr.busy_s <= 0:
        return None
    s = sum(sum(tr.durations(k)) for k in LAYOUT_KERNELS)
    return 100.0 * s / tr.busy_s
