"""Primitives, initializers, losses and the hand-written CUDA kernels.

``gated_pool`` and ``u8_stem`` build their kernels on first launch, never
at import."""

from . import gated_pool, init, loss, nn, u8_stem  # noqa: F401
