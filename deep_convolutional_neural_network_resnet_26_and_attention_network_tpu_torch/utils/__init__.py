"""Utilities: weight carry-over from the JAX parameter tree and back, and
the ``.dla`` heatmap writer."""

from . import helpers, interop  # noqa: F401
