"""Raster-scan tiling and tissue (foreground) detection.

Counterpart of ``data/tissue.py`` in the JAX package, after the
reference's ROI rule (reference: RoiBuilder.py:104-114 and :156-167): a
tile is tissue when

  * the population stddev of its red channel exceeds 5 (contrast check,
    PIL ``ImageStat.Stat(roi).stddev[0]``), AND
  * more than 1000 pixels pass the HSV mask h > 120 AND 50 < v < 210,
    where h/v follow PIL's 0..255 'HSV' convention.

Two implementations of one rule: ``is_tissue`` in numpy for one tile on
the host, and ``tissue_mask_batch`` in torch for a stack of tiles on any
device, which ``extract_tissue_tiles`` runs on the builder's device. They
give the same keep flags (the tests compare them with the JAX package's
filter on the same slide).
"""

import numpy as np
import torch

STDDEV_MIN = 5.0
HUE_MIN = 120.0
VAL_MIN = 50.0
VAL_MAX = 210.0
MIN_TISSUE_PIXELS = 1000


def sliding_window(dimensions, step_size: int, padding: int = 0):
    """Raster coordinates over an image of ``dimensions`` (rows, cols, ...).

    Coordinate tuples are (row, col); iteration order and bounds match the
    reference exactly (reference: RoiBuilder.py:104-114) so cached raster
    files are interchangeable.
    """
    return [
        (x, y)
        for y in range(padding, dimensions[1] - step_size - padding - 1, step_size)
        for x in range(padding, dimensions[0] - step_size - padding - 1, step_size)
    ]


def _rgb_to_hv_np(r, g, b):
    """Hue and value in PIL's 0..255 'HSV' convention (numpy, float32).

    Mirrors PIL's C converter: v = max(r,g,b); h = 255 * hue_fraction.
    Saturation is not needed by the filter."""
    maxc = np.maximum(np.maximum(r, g), b)
    minc = np.minimum(np.minimum(r, g), b)
    delta = maxc - minc
    safe = np.where(delta == 0, 1.0, delta)
    rc = (maxc - r) / safe
    gc = (maxc - g) / safe
    bc = (maxc - b) / safe
    h = np.where(r == maxc, bc - gc,
                 np.where(g == maxc, 2.0 + rc - bc, 4.0 + gc - rc))
    h = (h / 6.0) % 1.0
    h = np.where(delta == 0, 0.0, h)
    return np.floor(h * 255.0), maxc


def _rgb_to_hv_torch(r, g, b):
    """:func:`_rgb_to_hv_np` in torch, the same float32 operations."""
    maxc = torch.maximum(torch.maximum(r, g), b)
    minc = torch.minimum(torch.minimum(r, g), b)
    delta = maxc - minc
    safe = torch.where(delta == 0, torch.ones_like(delta), delta)
    rc = (maxc - r) / safe
    gc = (maxc - g) / safe
    bc = (maxc - b) / safe
    h = torch.where(r == maxc, bc - gc,
                    torch.where(g == maxc, 2.0 + rc - bc, 4.0 + gc - rc))
    h = torch.remainder(h / 6.0, 1.0)
    h = torch.where(delta == 0, torch.zeros_like(h), h)
    return torch.floor(h * 255.0), maxc


def is_tissue(tile_u8: np.ndarray) -> bool:
    """Host-side single-tile filter. tile_u8: [H, W, 3] uint8."""
    t = tile_u8.astype(np.float32)
    r = t[..., 0]
    n = r.size
    var = (r * r).sum() / n - (r.sum() / n) ** 2
    if np.sqrt(max(var, 0.0)) <= STDDEV_MIN:
        return False
    h, v = _rgb_to_hv_np(r, t[..., 1], t[..., 2])
    mask = (h > HUE_MIN) & (v > VAL_MIN) & (v < VAL_MAX)
    return int(mask.sum()) > MIN_TISSUE_PIXELS


def tissue_mask_batch(tiles_u8: torch.Tensor) -> torch.Tensor:
    """Batched filter on the tiles' device. [N, H, W, 3] uint8 -> [N] bool."""
    t = tiles_u8.float()
    r = t[..., 0]
    n = r.shape[1] * r.shape[2]
    mean = r.sum(dim=(1, 2)) / n
    var = (r * r).sum(dim=(1, 2)) / n - mean ** 2
    contrast = torch.sqrt(torch.clamp_min(var, 0.0)) > STDDEV_MIN
    h, v = _rgb_to_hv_torch(r, t[..., 1], t[..., 2])
    mask = (h > HUE_MIN) & (v > VAL_MIN) & (v < VAL_MAX)
    return contrast & (mask.sum(dim=(1, 2)) > MIN_TISSUE_PIXELS)


def extract_tissue_tiles(img: np.ndarray, roi_size: int, padding: int = 0,
                         *, device, batch: int = 64):
    """img [H, W, 3] uint8 -> (tiles [T, roi, roi, 3] uint8, coords [T, 2]).

    Scans the raster and filters the candidates in batches on ``device``."""
    raster = sliding_window(img.shape, roi_size, padding)
    tiles, coords = [], []
    for start in range(0, len(raster), batch):
        chunk = raster[start:start + batch]
        stack = np.stack([img[x:x + roi_size, y:y + roi_size, :]
                          for (x, y) in chunk])
        keep = tissue_mask_batch(
            torch.from_numpy(stack).to(device)).cpu().numpy()
        for tile, coord, k in zip(stack, chunk, keep):
            if k:
                tiles.append(tile)
                coords.append(coord)
    if tiles:
        return np.stack(tiles), np.asarray(coords)
    return (np.zeros((0, roi_size, roi_size, 3), np.uint8),
            np.zeros((0, 2), np.int64))
