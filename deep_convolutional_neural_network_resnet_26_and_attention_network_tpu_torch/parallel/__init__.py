"""Serving entry points (one-pass, streaming and batched slide
classification), the train and eval steps, and the (slides, tiles) mesh of
ranks with the explicit tile-sharded pool (``mesh``, ``shard_pool``)."""

from . import inference, steps  # noqa: F401
