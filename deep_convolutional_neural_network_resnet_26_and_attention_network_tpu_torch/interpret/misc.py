"""Shared interpretability helpers on numpy arrays: the port's own copy
of ``interpret/misc.py`` in the JAX package (reference:
pytorch-cnn-visualizations-master/src/misc_functions.py:17-240).

matplotlib (for the colormaps) and Pillow (to write images) are imported
only inside the functions that need them, behind a guard:
:func:`apply_colormap_on_image` raises naming matplotlib where it is not
installed (the card's machine), :func:`save_image` names Pillow."""

import os

import numpy as np

from ..utils import helpers


def normalize_01(x):
    x = np.asarray(x, np.float64)
    x = x - x.min()
    denom = x.max()
    return x / denom if denom > 0 else x


def convert_to_grayscale(im_as_arr):
    """[H, W, C] or [C, H, W] gradients -> [H, W] grayscale saliency
    (max over channels, 1-99 percentile clip; reference:
    misc_functions.py convert_to_grayscale)."""
    arr = np.asarray(im_as_arr)
    axis = -1 if arr.shape[-1] in (1, 3) else 0
    gray = np.max(np.abs(arr), axis=axis)
    vmax = np.percentile(gray, 99)
    vmin = np.min(gray)
    return np.clip((gray - vmin) / (vmax - vmin + 1e-12), 0, 1)


def get_positive_negative_saliency(gradient):
    """(pos, neg) maps normalized by their own extrema (reference:
    misc_functions.py get_positive_negative_saliency)."""
    gradient = np.asarray(gradient)
    pos = np.maximum(0, gradient) / (gradient.max() + 1e-12)
    neg = np.maximum(0, -gradient) / (-gradient.min() + 1e-12)
    return pos, neg


def apply_colormap_on_image(org_im_u8, activation, colormap_name="hsv",
                            alpha=0.4):
    """(heatmap, overlay) uint8 images (reference: misc_functions.py
    apply_colormap_on_image). Needs matplotlib."""
    plt = helpers.require_pyplot("apply_colormap_on_image")
    heatmap = plt.colormaps[colormap_name](normalize_01(activation))
    org = np.asarray(org_im_u8, np.float64) / 255.0
    blended = (1 - alpha) * org + alpha * heatmap[..., :3]
    return ((heatmap * 255).astype(np.uint8),
            (np.clip(blended, 0, 1) * 255).astype(np.uint8))


def format_np_output(np_arr):
    """-> [H, W, 3] uint8 (reference: misc_functions.py format_np_output)."""
    arr = np.asarray(np_arr)
    if arr.ndim == 2:
        arr = arr[..., None]
    if arr.shape[0] in (1, 3) and arr.ndim == 3 and arr.shape[-1] not in (1, 3):
        arr = arr.transpose(1, 2, 0)
    if arr.shape[-1] == 1:
        arr = np.repeat(arr, 3, axis=-1)
    if arr.max() <= 1.0:
        arr = arr * 255
    return np.clip(arr, 0, 255).astype(np.uint8)


def save_image(im, path):
    """Write a numpy image (through :func:`format_np_output`) or a PIL
    image to ``path``. Needs Pillow."""
    try:
        from PIL import Image
    except ImportError:
        raise RuntimeError("save_image needs Pillow, which is not "
                           "installed") from None

    if isinstance(im, np.ndarray):
        im = Image.fromarray(format_np_output(im))
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    im.save(path)
    return path


def save_gradient_images(gradient, path):
    """Normalize to [0,1] and save (reference: misc_functions.py
    save_gradient_images)."""
    return save_image(normalize_01(gradient), path)


def preprocess_image(img_u8):
    """uint8 HWC -> normalized float32 [1, H, W, C] in [-1, 1] (the
    pipeline's Normalize(0.5, 0.5))."""
    x = np.asarray(img_u8, np.float32) / 255.0
    return ((x - 0.5) / 0.5)[None]


def recreate_image(x):
    """Inverse of preprocess_image -> uint8 HWC."""
    arr = np.asarray(x)
    if arr.ndim == 4:
        arr = arr[0]
    img = (arr * 0.5 + 0.5) * 255.0
    return np.clip(img, 0, 255).astype(np.uint8)
