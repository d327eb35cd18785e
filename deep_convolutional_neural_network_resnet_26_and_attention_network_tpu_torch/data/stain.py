"""H&E / DAB stain-space color deconvolution (Ruifrok & Johnston): the
port's own numpy copy of ``data/stain.py`` in the JAX package.

The reference uses ``skimage.color.rgb2hed`` + ``rescale_intensity`` to
extract the DAB channel from IHC images (reference: Datasets.py:128-134).
skimage is optional here, so the same math is implemented directly:

  stains = (ln(max(rgb, 1e-6)) / ln(1e-6)) @ inv(rgb_from_hed)

with the standard H&E-DAB stain matrix (modern skimage semantics for the
public rgb2hed/hed2rgb pair; the DAB extraction uses the 2019-era math the
reference actually ran; see _rgb2hed_2019). The RBGtoHEres layer
(reference: nnBlocks.py:281-293) hardcodes its own different fixed matrix;
see models/blocks.py.
"""

import numpy as np

# Ruifrok & Johnston H&E-DAB stain vectors (rows: H, E, DAB in RGB space)
RGB_FROM_HED = np.array([
    [0.65, 0.70, 0.29],
    [0.07, 0.99, 0.11],
    [0.27, 0.57, 0.78]], np.float64)
HED_FROM_RGB = np.linalg.inv(RGB_FROM_HED)

_LOG_ADJUST = np.log(1e-6)


def img_as_float(img_u8):
    """uint8 [0,255] -> float64 [0,1] (skimage.img_as_float semantics)."""
    if img_u8.dtype == np.uint8:
        return img_u8.astype(np.float64) / 255.0
    return img_u8.astype(np.float64)


def rgb2hed(rgb):
    """RGB float [0,1] HWC -> HED stain concentrations (skimage parity)."""
    rgb = np.maximum(np.asarray(rgb, np.float64), 1e-6)
    return (np.log(rgb) / _LOG_ADJUST) @ HED_FROM_RGB


def hed2rgb(hed):
    """Inverse transform back to RGB [0,1]."""
    log_rgb = np.asarray(hed, np.float64) @ RGB_FROM_HED * _LOG_ADJUST
    return np.clip(np.exp(log_rgb), 0.0, 1.0)


def rescale_intensity(img, in_range, out_range=(0.0, 1.0)):
    """Clip to in_range and map linearly onto out_range
    (skimage.exposure.rescale_intensity semantics)."""
    lo, hi = in_range
    olo, ohi = out_range
    x = np.clip(np.asarray(img, np.float64), lo, hi)
    return (x - lo) / (hi - lo) * (ohi - olo) + olo


def _rgb2hed_2019(rgb):
    """The skimage-of-2019 separate_stains math the reference ran:
    ``-log10(rgb + 2) @ hed_from_rgb`` (no 1/log(1e-6) normalization).
    Outputs are NEGATIVE, in roughly [-0.48, -0.30] — exactly the window
    the reference's rescale_intensity in_range=(-0.45, -0.3) targets.
    The modern :func:`rgb2hed` returns non-negative stains; feeding those
    through the legacy window saturates the plane to a constant 1.0."""
    rgb = np.asarray(rgb, np.float64) + 2.0
    return (-np.log10(rgb)) @ HED_FROM_RGB


def dab_channel(img_u8, in_range=(-0.45, -0.3)):
    """uint8 RGB image -> float32 DAB-density plane in [0, 1] — the exact
    extraction the IHC datasets perform (reference: Datasets.py:122-134),
    using the 2019-era stain math its in_range was calibrated for."""
    hed = _rgb2hed_2019(img_as_float(img_u8))
    return rescale_intensity(np.float32(hed)[..., 2], in_range).astype(
        np.float32)
