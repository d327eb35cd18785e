"""Whole-slide image readers behind one interface (numpy, PIL, optional
tifffile and openslide).

Counterpart of ``data/slide_io.py`` in the JAX package, which it copies.
The reference reads WSIs with ``tifffile`` (the largest TIFF series, taken
as the 40x level; reference: RoiBuilder.py:139-147) and probes
``openslide`` for viewer eligibility (reference: RoiBuilder.py:76-84). Both
libraries are optional: ``read_slide`` tries tifffile, then openslide, then
PIL, and reads ``.npy`` arrays directly; it returns the highest-resolution
plane as an HWC uint8 numpy array.
"""

import os

import numpy as np

try:  # optional
    import tifffile as _tifffile
except ImportError:  # pragma: no cover - environment without tifffile
    _tifffile = None

try:  # optional
    import openslide as _openslide
except ImportError:  # pragma: no cover - environment without openslide
    _openslide = None


def openslide_eligible(path: str) -> bool:
    """Can this file be opened by openslide (caMicroscope eligibility probe,
    reference: RoiBuilder.py:76-84)?"""
    if _openslide is None:
        return False
    try:
        _openslide.OpenSlide(path).close()
        return True
    except Exception:  # openslide raises several unrelated types
        return False


def _read_tifffile(path: str) -> np.ndarray:
    """Largest-series TIFF read (reference: RoiBuilder.py:139-147), with the
    file handle closed before returning."""
    with _tifffile.TiffFile(path) as tf:
        biggest, target = 0, 0
        for i in range(len(tf.series)):
            size = int(np.prod(tf.series[i].shape))
            if size > biggest:
                biggest, target = size, i
        return np.asarray(tf.series[target].asarray())


def _read_pil(path: str) -> np.ndarray:
    from PIL import Image

    Image.MAX_IMAGE_PIXELS = None  # WSIs exceed the decompression-bomb limit
    with Image.open(path) as im:
        # multi-page TIFF: pick the largest frame
        best, best_size = None, -1
        n = getattr(im, "n_frames", 1)
        for i in range(n):
            im.seek(i)
            size = im.size[0] * im.size[1]
            if size > best_size:
                best_size, best = size, i
        im.seek(best or 0)
        return np.asarray(im.convert("RGB"))


def read_slide(path: str) -> np.ndarray:
    """Read the highest-resolution plane of a slide as HWC uint8 RGB."""
    if path.endswith(".npy"):
        return np.asarray(np.load(path, mmap_mode="r"))
    if _tifffile is not None:
        try:
            arr = _read_tifffile(path)
            if arr.ndim == 2:
                arr = np.stack([arr] * 3, axis=-1)
            return arr
        except Exception:  # not a TIFF tifffile can parse: try the others
            pass
    if _openslide is not None:
        try:
            sl = _openslide.OpenSlide(path)
            try:
                w, h = sl.level_dimensions[0]
                img = sl.read_region((0, 0), 0, (w, h)).convert("RGB")
                return np.asarray(img)
            finally:
                sl.close()
        except Exception:  # not an openslide format: fall through to PIL
            pass
    return _read_pil(path)


def write_synthetic_slide(path: str, array: np.ndarray) -> str:
    """Persist an HWC uint8 array as a readable 'slide' (tests, fixtures).

    Writes TIFF when a TIFF writer is available, else ``.npy``; returns the
    path written."""
    array = np.ascontiguousarray(array.astype(np.uint8))
    if _tifffile is not None and not path.endswith(".npy"):
        _tifffile.imwrite(path, array)
        return path
    if path.endswith((".tif", ".tiff")):
        from PIL import Image

        Image.fromarray(array).save(path)
        return path
    if not path.endswith(".npy"):
        path = os.path.splitext(path)[0] + ".npy"
    np.save(path, array)
    return path
