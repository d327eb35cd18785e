"""Share of the window in which nothing ran on the card while the host
was inside a window step's bag forward (``port.bag``), backward
(``port.backward``), Adam step (``port.adam``) or copy home (``port.home``),
from the traced run."""

from benchmark.spans import step_idle_percent as read  # noqa: F401
