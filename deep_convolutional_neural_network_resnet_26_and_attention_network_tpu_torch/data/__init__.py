"""Data layer: whole-slide IO, tiling + tissue filtering (native C++ or
torch), the tile cache, on-device tile transforms, bag bucketing, the
training bag loader and prefetcher, label sheets, the slide dataset, the
GAN's image folder and resolution-keyed store, stain deconvolution and the
cell / IHC datasets."""

from . import (  # noqa: F401
    accessors,
    cell_datasets,
    dataset,
    gan_dataset,
    loader,
    native,
    roibuilder,
    slide_io,
    stain,
    tissue,
    transforms,
)
