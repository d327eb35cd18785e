"""Bag bucketing: pad each bag to a size on a fixed ladder, with a mask.

Counterpart of the bucketing half of ``data/loader.py`` in the JAX package
(``BagPrefetcher`` and ``prefetch_iter`` come with the training slice).
The model threads the mask through every tile reduction, so padded
execution is numerically the ragged original. The JAX package pads to keep
its compiled-program cache small; PyTorch runs eagerly, so the serving path
here runs each bag at its exact size and does not pad. The ladder stays the
JAX one, for the training slice's bag batching.
"""

import torch

DEFAULT_BUCKETS = (32, 64, 128, 256, 512, 1024, 2048, 2560)


def bucket_for(n: int, buckets=DEFAULT_BUCKETS) -> int:
    """Smallest bucket >= n. Above the top bucket, sizes round up to a
    1024-tile granule instead of the exact count, so bags of any size land
    on few shapes; the waste is bounded at 1023 tiles."""
    for b in buckets:
        if b >= n:
            return b
    return max(buckets[-1], ((n + 1023) // 1024) * 1024)


def pad_bag(tiles, n_tiles: int | None = None, *, buckets=DEFAULT_BUCKETS):
    """Pad a [T, ...] tensor with zeros to its bucket; returns (padded,
    mask [T_b] float32), both on the tiles' device."""
    t = tiles.shape[0]
    target = bucket_for(t, buckets) if n_tiles is None else n_tiles
    if target < t:
        raise ValueError(f"bag of {t} tiles cannot pad to n_tiles={target}")
    mask = torch.zeros(target, dtype=torch.float32, device=tiles.device)
    mask[:t] = 1.0
    if target > t:
        pad = tiles.new_zeros((target - t,) + tuple(tiles.shape[1:]))
        tiles = torch.cat([tiles, pad], dim=0)
    return tiles, mask
