"""Host milliseconds the port spends in ``port.stage.fill`` (the copy of a
chunk into its pinned buffer and the enqueue of its copy to the card) per
1000 tiles it staged (its counter ``stage.tiles``), from the traced run."""

from benchmark.spans import stage_fill_ms_per_ktile as read  # noqa: F401
