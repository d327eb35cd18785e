"""Batched tile transforms on the device.

Counterpart of ``data/transforms.py`` in the JAX package. The reference
transforms tiles one by one with torchvision (reference:
RoiBuilder.py:193-210):

  eval:  ToPILImage -> Resize(res) -> ToTensor -> Normalize(.5,.5)

Here a whole stack of uint8 NHWC tiles transforms at once on the tensor's
device. The resize is ``F.interpolate(mode="bilinear", antialias=True)``
(anti-aliased like PIL and like ``jax.image.resize(..., antialias=True)``),
run on the ``channels_last`` view of the NHWC stack. ``train_transform``
comes with the training slice.
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


def apply_chunked(fn, tiles_u8: np.ndarray, *, device, chunk: int = 64,
                  **kwargs) -> torch.Tensor:
    """Run a transform over a large host stack (an array or a memory map)
    in chunks of ``chunk`` tiles: each chunk goes to ``device`` as uint8 (a
    quarter of the f32 bytes) through reused pinned staging
    (``loader.staged_chunks``), transforms there, and the results are
    concatenated on the device. Peak memory for the transform's
    intermediates stays at one chunk."""
    if tiles_u8.shape[0] == 0:
        raise ValueError("empty tile stack")
    outs = [fn(part, **kwargs) for _, part in
            loader.staged_chunks(tiles_u8, chunk, torch.device(device))]
    return torch.cat(outs, dim=0) if len(outs) > 1 else outs[0]
