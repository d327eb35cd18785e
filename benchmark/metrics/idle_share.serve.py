"""Share of the measured window in which nothing ran on the card (no
kernel, copy or set): one less the union of the device intervals over the
window, from the device trace."""

from benchmark.readers import idle_percent as read  # noqa: F401
