"""Serving entry points (one-pass and streaming slide classification) and
the single-device train and eval steps."""

from . import inference, steps  # noqa: F401
