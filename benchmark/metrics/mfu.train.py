"""The FLOPs of the window's training work (the embedder's forward and the
backward that is needed, on each bag's 20 % subsample, counted
analytically by ``flops.py``) over the window's seconds at the card's peak
in the configuration's precision."""

from benchmark.readers import mfu_percent as read  # noqa: F401
