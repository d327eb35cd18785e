"""Data layer: whole-slide IO, tiling + tissue filtering, the tile cache,
on-device tile transforms and bag bucketing."""

from . import loader, roibuilder, slide_io, tissue, transforms  # noqa: F401
