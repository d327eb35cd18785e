"""RoiBuilder: whole-slide image -> filtered tile cache -> eval bags.

Counterpart of ``data/roibuilder.py`` in the JAX package, after the
reference class (reference: RoiBuilder.py:24-284): the same constructor
``RoiBuilder(path, params)``, the same status machine INIT -> CACHE
MISSING -> VALID -> VALID-READY, the same cache files
``$CACHE_DIR/{data,coor}_<basename>_rois_size<roi>_hsvcut_v3.npy`` and
``$CACHE_DIR/eval_<basename>_rois_size<roi>_hsvcut_v3_res<res>_v1.npy``
(so caches written by either package serve the other), written atomically.

Tiles are HWC uint8 in the cache; bags come back as [T, res, res, 3]
float32 NHWC tensors in [-1, 1] on the builder's device. The tissue filter
of ``build`` is the native C++ one on the host (``data.native``) where
``g++`` builds it, as in the JAX package, and otherwise the torch filter
batched on the builder's device (``data.tissue``); both keep the same
tiles. ``get_train_data`` draws its augmentation from two streams that
``reseed_augment`` pins: a numpy generator for the 2500-tile cap, the JAX
package's own, so both packages pick the same tiles, and a CPU
``torch.Generator`` for the crop offsets and flips.
"""

import os

import numpy as np
import torch

from .._device import resolve_device
from . import native, slide_io, tissue, transforms

ROI_SIZE = 1200          # reference: RoiBuilder.py:51
TRAIN_TILE_CAP = 2500    # reference: RoiBuilder.py:230
# zeros fallback for tile-less slides: the reference returns a fixed
# zeros(20, 3, 128, 128) (RoiBuilder.py:236); here the spatial size follows
# the ARMED resolution, as in the JAX package (PARITY.md)
EMPTY_BAG_TILES = 20
EMPTY_BAG_FALLBACK_RES = 128  # when no resolution armed yet


class RoiBuilder:
    """Tile extraction, caching, and eval-bag generation for one slide.

    Arguments:
        path: full WSI path.
        params: dict of user parameters (caMicroscope ids, outcome labels,
            ...); enriched in place with cache/status metadata exactly like
            the reference so downstream manifest writers keep working.
        device: where bags are built and the tissue filter runs (the card
            unless ``"cpu"`` is asked for).

    The training streams start unseeded; ``reseed_augment`` pins them.
    """

    def __init__(self, path: str, params: dict, *, loud: bool = False,
                 device=None):
        self.device = resolve_device(device)
        self._rng = np.random.default_rng()
        self._train_gen = torch.Generator().manual_seed(
            int(self._rng.integers(0, 2**31 - 1)))
        self.params = params
        self.params["fullpath"] = path
        self.params["basename"] = os.path.split(path)[1].split(".")[0]
        self.params["root_cache_dir"] = os.path.expandvars("$CACHE_DIR")
        # 1200 like the reference; a pre-set params['roi_size'] wins so small
        # fixtures can use tiny tiles (cache filenames encode the size)
        self.params["roi_size"] = params.get("roi_size", ROI_SIZE)
        self.params["padding"] = 0
        self.params["ntiles"] = -1
        self.params["status"] = "INIT"
        self.params["coor_cache"] = "{0}/coor_{1}_rois_size{2}_hsvcut_v3.npy".format(
            self.params["root_cache_dir"], self.params["basename"],
            self.params["roi_size"])
        self.params["data_cache"] = "{0}/data_{1}_rois_size{2}_hsvcut_v3.npy".format(
            self.params["root_cache_dir"], self.params["basename"],
            self.params["roi_size"])
        self.loud = loud
        self._resolution = None

        if os.path.isfile(self.params["data_cache"]):
            raster = np.load(self.params["coor_cache"])
            self.params["ntiles"] = len(raster)
            self.params["status"] = "VALID"
        else:
            self.params["status"] = "CACHE MISSING"

        self.params["caMIC_eligable"] = slide_io.openslide_eligible(path)
        if self.loud:
            print(f"RoiBuilder[{self.params['basename']}] "
                  f"status={self.params['status']} ntiles={self.params['ntiles']}")

    def reseed_augment(self, *entropy: int):
        """Pin both training streams (the tile cap's and the crop/flip
        augmentation's) to ``entropy``. The trainer calls this per (seed,
        epoch, builder) so a run resumed from a checkpoint replays the
        uninterrupted run's augmentation exactly."""
        ss = np.random.SeedSequence(list(entropy))
        self._rng = np.random.default_rng(ss)
        self._train_gen = torch.Generator().manual_seed(
            int(ss.generate_state(1)[0] & 0x7FFFFFFF))

    # ------------------------------------------------------------------
    # Generic accessors (reference: RoiBuilder.py:89-102)
    def getsize(self) -> int:
        return self.params["ntiles"]

    def getname(self) -> str:
        return self.params["basename"]

    def getmeta(self) -> dict:
        return self.params

    sliding_window = staticmethod(tissue.sliding_window)

    # ------------------------------------------------------------------
    def build(self) -> bool:
        """Raster-scan the slide, keep tissue tiles, persist the cache
        (reference: RoiBuilder.py:128-177)."""
        if "VALID" in self.params["status"]:
            return True
        if os.path.isfile(self.params["data_cache"]):
            self.params["ntiles"] = len(np.load(self.params["coor_cache"]))
            self.params["status"] = "VALID"
            return True

        img = slide_io.read_slide(self.params["fullpath"])
        if native.available():
            # the C++ filter and gather (threads over tiles) on the host, as
            # in the JAX package; the same keep flags as the torch filter
            tiles, coords = native.extract_tissue_tiles_native(
                img, self.params["roi_size"], self.params["padding"])
        else:
            tiles, coords = tissue.extract_tissue_tiles(
                img, self.params["roi_size"], self.params["padding"],
                device=self.device)
        # atomic (tmp + os.replace), COOR before DATA: __init__ treats the
        # data cache as the cache-hit marker and immediately reads the
        # coor cache, so a kill between the two writes must leave either
        # nothing or a complete pair — never data-without-coor
        for path, arr in ((self.params["coor_cache"], coords),
                          (self.params["data_cache"], tiles)):
            _save_atomic(path, arr)
        self.params["ntiles"] = len(coords)
        self.params["status"] = "VALID"
        return True

    # ------------------------------------------------------------------
    def update_resolution_and_buffer(self, resolution: int):
        """Set the network input resolution; arms the transforms
        (reference: RoiBuilder.py:182-212)."""
        if "VALID" not in self.params["status"]:
            raise RuntimeError(
                "updating transforms for an uncached slide; call build() first")
        self._resolution = int(resolution)
        self.params["resolution"] = self._resolution
        self.params["status"] = "VALID-READY"

    def _load_cache(self, with_coords: bool = False, mmap: bool = False):
        """``mmap=True`` memory-maps the tile stack, so a pass over it
        reads one chunk's pages at a time into reused staging buffers."""
        if not os.path.isfile(self.params["data_cache"]):
            raise RuntimeError(
                f"RoiBuilder has no cache: {self.params['data_cache']}")
        data = np.load(self.params["data_cache"],
                       mmap_mode="r" if mmap else None)
        if with_coords:
            return data, np.load(self.params["coor_cache"])
        return data

    def readahead(self):
        """Ask the kernel to prefetch the raw tile cache's pages.

        The serving daemon's I/O pipeline (``train/serve.py --io_depth``)
        calls this on its producer thread, so the next slide's disk reads
        overlap the current slide's device work. POSIX_FADV_WILLNEED is
        asynchronous and bounded by the kernel's readahead budget. Best
        effort: does nothing off Linux or on a missing file."""
        if not hasattr(os, "posix_fadvise"):  # pragma: no cover
            return
        try:
            fd = os.open(self.params["data_cache"], os.O_RDONLY)
            try:
                os.posix_fadvise(fd, 0, 0, os.POSIX_FADV_WILLNEED)
            finally:
                os.close(fd)
        except OSError:
            pass

    def _empty_bag(self):
        res = self._resolution or EMPTY_BAG_FALLBACK_RES
        return torch.zeros((EMPTY_BAG_TILES, res, res, 3), dtype=torch.float32,
                           device=self.device)

    def _require_ready(self):
        if "VALID-READY" not in self.params["status"]:
            raise RuntimeError(
                "transform not armed (status=[{0}]); call "
                "update_resolution_and_buffer() first".format(
                    self.params["status"]))

    def train_pad(self) -> int:
        """The crop jitter's zero pad: ``params['train_pad']`` when set (0
        turns the pad and crop off; the flips stay), else the reference's
        100 px at roi 1200 (RoiBuilder.py:195), scaled to the tile size."""
        pad = self.params.get("train_pad")
        if pad is None:
            pad = max(1, round(self.params["roi_size"] * 100 / 1200))
        return int(pad)

    def get_train_data(self, *, deferred: bool = False):
        """Augmented bag [T <= 2500, res, res, 3] float32 in [-1, 1] on the
        builder's device (reference: RoiBuilder.py:215-238): a random
        2500 of the cached tiles when there are more (a sorted gather off
        the memory map, which reads only their pages), then pad, random
        crop, random flips, resize and normalize on the device.
        ``deferred`` returns a :class:`DeferredTrainBag` instead, which
        draws the same noise now and transforms only the rows it is asked
        for (a mesh rank's share of the bag's subsample)."""
        self._require_ready()
        data = self._load_cache(mmap=True)
        rows = None
        if data.shape[0] > TRAIN_TILE_CAP:
            rows = np.sort(self._rng.choice(data.shape[0], TRAIN_TILE_CAP,
                                            replace=False))
        n = data.shape[0] if rows is None else len(rows)
        if n == 0:
            return self._empty_bag()
        pad = self.train_pad()
        offsets = torch.randint(0, 2 * pad + 1, (n, 2),
                                generator=self._train_gen)
        flip_h = torch.rand(n, generator=self._train_gen) < 0.5
        flip_v = torch.rand(n, generator=self._train_gen) < 0.5
        kwargs = dict(roi_size=self.params["roi_size"],
                      resolution=self._resolution, pad=pad)
        if deferred:
            return DeferredTrainBag(data, rows, (offsets, flip_h, flip_v),
                                    self.device, kwargs)
        if rows is not None:
            data = np.asarray(data[rows])
        return transforms.apply_chunked(
            transforms.train_transform, data, device=self.device,
            per_tile=(offsets, flip_h, flip_v), **kwargs)

    # resolution-keyed eval-tile cache: the eval transform is deterministic,
    # so its f32 output is cached per (slide, roi_size, resolution), and the
    # cached and uncached paths give the same tensor. Only engaged when
    # downsizing (at roi_size == resolution the f32 copy would be 4x
    # LARGER than the raw uint8 cache).
    def _eval_cache_path(self) -> str:
        # derived from the RAW cache's filename so the tissue-filter
        # version tag (hsvcut_v3) invalidates this cache along with it
        raw = os.path.splitext(
            os.path.basename(self.params["data_cache"]))[0]
        return "{0}/eval_{1}_res{2}_v1.npy".format(
            self.params["root_cache_dir"], raw[len("data_"):],
            self._resolution)

    def _raw_cache_fingerprint(self) -> str:
        """Content identity of the raw tile cache: size + mtime_ns."""
        st = os.stat(self.params["data_cache"])
        return "{0}:{1}".format(st.st_size, st.st_mtime_ns)

    def _eval_tiles(self, data):
        """Transformed eval bag for the raw stack, via the f32 cache.

        The cache is stale unless its stored fingerprint of the raw tile
        cache matches exactly; writes are tmp-file + os.replace, the
        fingerprint after the data (a kill between the two leaves a
        fingerprint-less cache, which reads as stale)."""
        use_cache = self.params["roi_size"] > self._resolution
        path = self._eval_cache_path() if use_cache else None
        fp_path = path + ".fp" if path else None
        if path and os.path.isfile(path):
            try:
                with open(fp_path) as f:
                    fresh = f.read() == self._raw_cache_fingerprint()
                cached = np.load(path, mmap_mode="r") if fresh else None
                if cached is not None and cached.shape[0] == len(data):
                    return torch.from_numpy(np.array(cached)).to(self.device)
            except (OSError, ValueError):
                pass  # unreadable/corrupt cache: fall through and rewrite
        out = transforms.apply_chunked(
            transforms.eval_transform, data, device=self.device,
            resolution=self._resolution)
        if path:
            try:
                _save_atomic(path, out.cpu().numpy())
                tmp_fp = "{0}.{1}.tmp".format(fp_path, os.getpid())
                try:
                    with open(tmp_fp, "w") as f:
                        f.write(self._raw_cache_fingerprint())
                    os.replace(tmp_fp, fp_path)
                finally:
                    if os.path.isfile(tmp_fp):
                        os.unlink(tmp_fp)
            except OSError:
                pass  # a cache that cannot be written only costs time
        return out

    def get_validation_data(self):
        """Deterministic bag [T, res, res, 3] (reference: RoiBuilder.py:240-259)."""
        self._require_ready()
        data = self._load_cache(mmap=True)
        if len(data) == 0:
            return self._empty_bag()
        return self._eval_tiles(data)

    def get_inference_data(self):
        """(tiles [T, res, res, 3], coords [T, 2], raw uint8 tiles) — no
        randomization or capping (reference: RoiBuilder.py:261-284). The
        raw tiles are the cache's read-only memory map: the transform
        copies them to the device chunk by chunk (``loader.staged_chunks``)
        instead of reading the whole cache into a fresh host array."""
        self._require_ready()
        img_data, coords = self._load_cache(with_coords=True, mmap=True)
        if len(img_data) == 0:
            # same zeros fallback as the other getters — one degenerate
            # slide must not sink an interface/heatmap sweep
            return self._empty_bag(), np.zeros((0, 2), np.int64), img_data
        return self._eval_tiles(img_data), coords, img_data


class DeferredTrainBag:
    """A training bag whose train transform has not run: ``bag[idx]`` is
    ``get_train_data()[idx]`` for the same noise, computed for those rows
    only (their tiles read off the memory-mapped cache, copied to the
    device and transformed there; the transform is per tile). ``shape`` and
    ``device`` are the bag's, so the loader hands it on like a tensor."""

    def __init__(self, data, rows, noise, device, kwargs):
        self._data, self._rows = data, rows
        self._noise, self._kwargs = noise, kwargs
        n = data.shape[0] if rows is None else len(rows)
        res = kwargs["resolution"]
        self.shape = (n, res, res, 3)
        self.device = device

    def __getitem__(self, idx):
        idx = torch.as_tensor(idx).cpu()
        take = idx.numpy() if self._rows is None else self._rows[idx.numpy()]
        tiles = torch.from_numpy(np.asarray(self._data[take])).to(self.device)
        return transforms.train_transform(tiles, *(x[idx] for x in self._noise),
                                          **self._kwargs)


def _save_atomic(path: str, arr: np.ndarray):
    """np.save to a temporary name, then os.replace onto ``path``."""
    tmp = "{0}.{1}.tmp.npy".format(path, os.getpid())
    try:
        np.save(tmp, arr)
        os.replace(tmp, path)
    finally:
        if os.path.isfile(tmp):
            os.unlink(tmp)
