"""Share of the window in which nothing ran on the card while the host
was inside one of the port's staging spans (``port.stage.pin``, ``.wait``,
``.fill``, the innermost span), from the traced run."""

from benchmark.spans import stage_idle_percent as read  # noqa: F401
