"""Utilities: weight, optimizer-state and int8-qparams carry-over from the
JAX layouts and back, epoch stats and summaries, the classification
report, the ``.dla`` heatmap writer, the predictions artifact, the
profiler trace and step timer, and TensorBoard epoch logging."""

from . import helpers, interop, plots, profiling, tb  # noqa: F401
