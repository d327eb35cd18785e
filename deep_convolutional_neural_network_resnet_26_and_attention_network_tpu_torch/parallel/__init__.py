"""Serving entry points: one-pass and streaming slide classification."""

from . import inference  # noqa: F401
