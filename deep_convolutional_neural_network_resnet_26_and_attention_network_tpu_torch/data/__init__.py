"""Data layer: whole-slide IO, tiling + tissue filtering (native C++ or
torch), the tile cache, on-device tile transforms, bag bucketing, the
training bag loader and prefetcher, label sheets and the slide dataset."""

from . import (  # noqa: F401
    accessors,
    dataset,
    loader,
    native,
    roibuilder,
    slide_io,
    tissue,
    transforms,
)
