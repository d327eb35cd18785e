"""Batched tile transforms on the device.

Counterpart of ``data/transforms.py`` in the JAX package. The reference
transforms tiles one by one with torchvision (reference:
RoiBuilder.py:193-210):

  train: ToPILImage -> Pad(100) -> RandomCrop(roi) -> Resize(res)
         -> RandomHFlip(.5) -> RandomVFlip(.5) -> ToTensor -> Normalize(.5,.5)
  eval:  ToPILImage -> Resize(res) -> ToTensor -> Normalize(.5,.5)

Here a whole stack of uint8 NHWC tiles transforms at once on the tensor's
device. The resize is ``F.interpolate(mode="bilinear", antialias=True)``
(anti-aliased like PIL and like ``jax.image.resize(..., antialias=True)``),
run on the ``channels_last`` view of the NHWC stack. ``train_transform``
takes its crop offsets and flips as tensors (the JAX package draws them
from a key inside), so the tests give both packages the same ones; the
pad, crop and both flips are one gather.
"""

import numpy as np
import torch
import torch.nn.functional as F

from . import loader

MEAN = 0.5
STD = 0.5


def _normalize(x_f32_01):
    return (x_f32_01 - MEAN) / STD


def _resize_bilinear(x, resolution: int):
    """[N, H, W, C] float -> [N, res, res, C], anti-aliased like PIL."""
    n, h, w, c = x.shape
    if h == resolution and w == resolution:
        return x
    y = F.interpolate(x.permute(0, 3, 1, 2), size=(resolution, resolution),
                      mode="bilinear", align_corners=False, antialias=True)
    return y.permute(0, 2, 3, 1)


def resize_u8(tiles_u8, *, resolution: int):
    """[N, H, W, 3] uint8 -> [N, res, res, 3] uint8, same anti-aliased
    bilinear as the eval transform."""
    x = _resize_bilinear(tiles_u8.float(), resolution)
    return torch.clamp(torch.round(x), 0, 255).to(torch.uint8)


def normalize_u8(tiles_u8):
    """[N, H, W, 3] uint8 -> float32 in [-1, 1] (no resize)."""
    return _normalize(tiles_u8.float() / 255.0)


def eval_transform(tiles_u8, *, resolution: int):
    """[N, H, W, 3] uint8 -> [N, res, res, 3] float32 in [-1, 1]."""
    x = tiles_u8.float() / 255.0
    return _normalize(_resize_bilinear(x, resolution)).contiguous()


def train_transform(tiles_u8, offsets, flip_h, flip_v, *, roi_size: int,
                    resolution: int, pad: int = 100):
    """[N, roi, roi, 3] uint8 -> [N, res, res, 3] float32 in [-1, 1].

    Zero-pad by ``pad``, crop ``roi_size`` at ``offsets`` [N, 2] (row,
    column, each in ``[0, 2 * pad]``), flip left-right where ``flip_h`` [N]
    and upside-down where ``flip_v`` [N] (in that order), then resize and
    normalize like :func:`eval_transform`. The noise lies on any device."""
    n = tiles_u8.shape[0]
    dev = tiles_u8.device
    padded = F.pad(tiles_u8, (0, 0, pad, pad, pad, pad))
    ar = torch.arange(roi_size, device=dev)
    flip_h = flip_h.to(dev, torch.bool)[:, None]
    flip_v = flip_v.to(dev, torch.bool)[:, None]
    offsets = offsets.to(dev, torch.int64)
    # a flip after the crop reads the crop's pixels in reverse order
    rows = offsets[:, :1] + torch.where(flip_v, roi_size - 1 - ar, ar)
    cols = offsets[:, 1:] + torch.where(flip_h, roi_size - 1 - ar, ar)
    idx = torch.arange(n, device=dev)[:, None, None]
    cropped = padded[idx, rows[:, :, None], cols[:, None, :]]
    x = cropped.float() / 255.0
    return _normalize(_resize_bilinear(x, resolution)).contiguous()


def apply_chunked(fn, tiles_u8: np.ndarray, *, device, chunk: int = 64,
                  per_tile=None, **kwargs) -> torch.Tensor:
    """Run a transform over a large host stack (an array or a memory map)
    in chunks of ``chunk`` tiles: each chunk goes to ``device`` as uint8 (a
    quarter of the f32 bytes) through reused pinned staging
    (``loader.staged_chunks``), transforms there, and the results are
    concatenated on the device. Peak memory for the transform's
    intermediates stays at one chunk. ``per_tile`` is a tuple of tensors
    with one row a tile (a train transform's offsets and flips); each
    chunk's rows of them go to ``fn`` as positional arguments."""
    if tiles_u8.shape[0] == 0:
        raise ValueError("empty tile stack")
    outs = []
    for start, part in loader.staged_chunks(tiles_u8, chunk,
                                            torch.device(device)):
        rows = [x[start:start + part.shape[0]] for x in per_tile or ()]
        outs.append(fn(part, *rows, **kwargs))
    return torch.cat(outs, dim=0) if len(outs) > 1 else outs[0]
