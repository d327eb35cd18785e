"""ctypes bindings for the native (C++) tissue filter and tile gather.

Counterpart of ``data/native.py`` in the JAX package. The source is the
port's own copy, ``native/tissue_filter.cpp``; ``g++`` builds it on first
use into the package's ``_build/`` directory (gitignored), under a name
that carries a hash of the source and flags, so an edit rebuilds and
nothing is written beside the JAX package's source. Exposes:

  tissue_mask_native(img, coords, roi)   -> bool[n] keep flags
  gather_tiles_native(img, coords, roi)  -> uint8 [n, roi, roi, 3]

Both follow the rule of ``data/tissue.py`` exactly (the tests compare them
with the torch filter and with the JAX package's native filter).
``available()`` is False where no C++ toolchain builds the library; the
RoiBuilder then filters with torch on its device. This is host data-path
code, not a device kernel.
"""

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

from ..ops import _build
from . import tissue

_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "native", "tissue_filter.cpp")
# worker threads are std::thread, joined inside each call (no OpenMP)
_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-pthread")
_LOCK = threading.Lock()
_LIB = None
_TRIED = False


def _library_path() -> str:
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(_FLAGS).encode())
    return os.path.join(_build.BUILD_DIR,
                        f"libtissue_filter_{digest.hexdigest()[:16]}.so")


def _build_and_load():
    so_path = _library_path()
    if not os.path.isfile(so_path):
        os.makedirs(_build.BUILD_DIR, exist_ok=True)
        tmp = f"{so_path}.{os.getpid()}.tmp"
        proc = subprocess.run(["g++", *_FLAGS, _SRC, "-o", tmp],
                              capture_output=True, text=True, check=False)
        if proc.returncode != 0:
            if os.path.isfile(tmp):
                os.unlink(tmp)
            raise RuntimeError(
                f"g++ failed for tissue_filter.cpp:\n{proc.stderr}")
        os.replace(tmp, so_path)  # atomic: another process may build too
    lib = ctypes.CDLL(so_path)
    i64p = ctypes.POINTER(ctypes.c_int64)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.tissue_mask.argtypes = [
        u8p, ctypes.c_int64, ctypes.c_int64, i64p, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_double, ctypes.c_double, ctypes.c_double,
        ctypes.c_double, ctypes.c_int64, u8p]
    lib.tissue_mask.restype = None
    lib.gather_tiles.argtypes = [
        u8p, ctypes.c_int64, ctypes.c_int64, i64p, ctypes.c_int64,
        ctypes.c_int64, u8p]
    lib.gather_tiles.restype = None
    return lib


def _get_lib():
    global _LIB, _TRIED
    with _LOCK:
        if _LIB is None and not _TRIED:
            _TRIED = True
            try:
                _LIB = _build_and_load()
            except (OSError, RuntimeError):  # no g++, or it failed
                _LIB = None
    return _LIB


def available() -> bool:
    return _get_lib() is not None


def _as_c(img, coords):
    return (np.ascontiguousarray(img, np.uint8),
            np.ascontiguousarray(coords, np.int64))


def _u8(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def tissue_mask_native(img: np.ndarray, coords: np.ndarray,
                       roi: int) -> np.ndarray:
    """Keep flags for roi-sized tiles at (row, col) coords of img [H,W,3]."""
    lib = _get_lib()
    if lib is None:
        raise RuntimeError("native tissue filter unavailable (no g++?)")
    img, coords = _as_c(img, coords)
    n = coords.shape[0]
    keep = np.zeros((n,), np.uint8)
    lib.tissue_mask(
        _u8(img), img.shape[0], img.shape[1],
        coords.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), n, roi,
        tissue.STDDEV_MIN, tissue.HUE_MIN, tissue.VAL_MIN, tissue.VAL_MAX,
        tissue.MIN_TISSUE_PIXELS, _u8(keep))
    return keep.astype(bool)


def gather_tiles_native(img: np.ndarray, coords: np.ndarray,
                        roi: int) -> np.ndarray:
    """Contiguous [n, roi, roi, 3] gather of tiles at (row, col) coords."""
    lib = _get_lib()
    if lib is None:
        raise RuntimeError("native tile gather unavailable (no g++?)")
    img, coords = _as_c(img, coords)
    n = coords.shape[0]
    out = np.empty((n, roi, roi, 3), np.uint8)
    lib.gather_tiles(
        _u8(img), img.shape[0], img.shape[1],
        coords.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), n, roi,
        _u8(out))
    return out


def extract_tissue_tiles_native(img: np.ndarray, roi_size: int,
                                padding: int = 0):
    """Native raster scan: filter, then gather the survivors. The same
    result as ``data.tissue.extract_tissue_tiles``."""
    raster = np.asarray(tissue.sliding_window(img.shape, roi_size, padding),
                        np.int64).reshape(-1, 2)
    if raster.size == 0:
        return (np.zeros((0, roi_size, roi_size, 3), np.uint8),
                np.zeros((0, 2), np.int64))
    keep = tissue_mask_native(img, raster, roi_size)
    coords = raster[keep]
    return gather_tiles_native(img, coords, roi_size), coords
