"""Utilities: weight carry-over from the JAX parameter tree."""

from . import interop  # noqa: F401
