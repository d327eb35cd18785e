"""Primitives, initializers, losses and the hand-written CUDA kernels.

``gated_pool`` builds its kernel on first launch, never at import."""

from . import gated_pool, init, loss, nn  # noqa: F401
