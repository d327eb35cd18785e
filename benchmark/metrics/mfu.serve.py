"""The forward FLOPs of every tile served in the window (the embedder's,
counted analytically by ``flops.py``) over the window's seconds at the
card's peak in the configuration's precision."""

from benchmark.readers import mfu_percent as read  # noqa: F401
