"""Utilities: weight and optimizer-state carry-over from the JAX layouts
and back, epoch stats and summaries, the classification report, the
``.dla`` heatmap writer and the predictions artifact."""

from . import helpers, interop, plots  # noqa: F401
