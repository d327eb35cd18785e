"""Data layer: whole-slide IO, tiling + tissue filtering (native C++ or
torch), the tile cache, on-device tile transforms, bag bucketing and a
background prefetcher."""

from . import loader, native, roibuilder, slide_io, tissue, transforms  # noqa: F401
