"""Milliseconds a slide in which nothing ran on the card while the host
was inside a streamed slide's (``port.slide``) pool (``port.pool``) or
copies home (``port.home``), the innermost span, over the slides streamed
(the counter ``stream.slides``), from the traced run."""

from benchmark.spans import tail_idle_ms_per_slide as read  # noqa: F401
