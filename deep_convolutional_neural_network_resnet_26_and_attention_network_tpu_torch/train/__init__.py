"""Entry points: checkpoints, the classifier CLI's configuration and the
serving daemon (``python -m <port>.train.serve``). Training comes with its
own slice."""

from . import checkpoint, classify  # noqa: F401
