"""Primitives, initializers, losses, the W8A8 int8 extractor and the
hand-written CUDA kernels.

``gated_pool`` and ``u8_stem`` build their kernels on first launch, never
at import."""

from . import gated_pool, init, loss, nn, quant, u8_stem  # noqa: F401
