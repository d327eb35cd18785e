"""Image datasets for GAN training.

Counterpart of ``data/gan_dataset.py`` in the JAX package, which replaces
the reference's LMDB ``MultiResolutionDataset`` (reference:
style-based-gan-pytorch-master-512/dataset.py:8-40): images or tile-cache
``.npy`` stacks under a directory (:class:`ImageFolderDataset`), or a
prebuilt resolution-keyed store (:class:`MultiResolutionStore`), iterated
as ``[B, s, s, 3]`` float32 batches in [-1, 1] on the dataset's device
(the card unless ``device="cpu"``), behind the reference trainer's
``NewResolution(size, batch)`` surface (train.py:37). Shuffles draw from
numpy's ``default_rng`` seeded as the JAX package seeds them, so both
packages read the same batches.

``.npy`` stacks and the store need nothing beyond numpy. Image files
(png, jpg, tif) are decoded with Pillow, imported only where one is read:
where Pillow is missing, :class:`ImageFolderDataset` refuses a folder that
holds image files, naming them.

    python -m deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.data.gan_dataset --src <folder> --out <store>
"""

import glob
import json
import os

import numpy as np
import torch

from .._device import resolve_device
from . import transforms


def _is_image_array(path: str) -> bool:
    """True unless ``path`` is a .npy that is not image-shaped (RoiBuilder
    caches sit beside their ``coor_*.npy`` [T, 2] coordinates); the shape
    comes from the npy header."""
    if not path.lower().endswith(".npy"):
        return True
    try:
        shape = np.load(path, mmap_mode="r").shape
    except Exception:
        return False
    return (len(shape) in (3, 4)) and shape[-1] in (1, 3, 4)


def _pil_image():
    """Pillow's ``Image`` module, or None where Pillow is not installed."""
    try:
        from PIL import Image
    except ImportError:
        return None
    return Image


class ImageFolderDataset:
    """All images under root (png/jpg/tif) and/or tile stacks (*.npy)."""

    EXTS = (".png", ".jpg", ".jpeg", ".tif", ".tiff")

    def __init__(self, root: str, *, seed: int | None = None,
                 max_items: int | None = None, device=None):
        self.root = root
        self.device = resolve_device(device)
        self._rng = np.random.default_rng(seed)
        self.files = sorted(
            f for f in glob.glob(os.path.join(root, "**", "*"), recursive=True)
            if f.lower().endswith(self.EXTS + (".npy",))
            and _is_image_array(f))
        if max_items:
            self.files = self.files[:max_items]
        if not self.files:
            raise FileNotFoundError(f"no images under {root}")
        images = [f for f in self.files if not f.lower().endswith(".npy")]
        if images and _pil_image() is None:
            raise RuntimeError(
                f"{len(images)} image files under {root} (e.g. "
                f"{os.path.basename(images[0])}) need Pillow to decode, "
                "which is not installed; convert them to .npy tile stacks "
                "or a MultiResolutionStore")
        self.resolution = None
        self.batch_size = 4

    def NewResolution(self, image_size: int, batch_size: int = 4):
        self.resolution = int(image_size)
        self.batch_size = int(batch_size)

    def reseed(self, *entropy: int):
        """Pin the shuffle/sampling rng to (entropy...): the trainer calls
        this per (seed, epoch), so a resumed run replays the batch order."""
        self._rng = np.random.default_rng(np.random.SeedSequence(
            list(entropy)))

    def _load(self, path: str) -> np.ndarray:
        if path.lower().endswith(".npy"):
            arr = np.load(path, mmap_mode="r")
            if arr.ndim == 4:  # tile stack: a random tile
                arr = arr[int(self._rng.integers(0, arr.shape[0]))]
            return np.asarray(arr, np.uint8)
        with _pil_image().open(path) as im:
            return np.asarray(im.convert("RGB"), np.uint8)

    def __len__(self):
        return len(self.files)

    def batches(self, *, shuffle: bool = True, drop_last: bool = True):
        """Yield [B, res, res, 3] float32 batches in [-1, 1]."""
        if self.resolution is None:
            raise RuntimeError("call NewResolution(size, batch) first")
        order = np.arange(len(self.files))
        if shuffle:
            self._rng.shuffle(order)
        batch = []
        for idx in order:
            batch.append(self._load(self.files[int(idx)]))
            if len(batch) == self.batch_size:
                yield self._finalize(batch)
                batch = []
        if batch and not drop_last:
            yield self._finalize(batch)

    def _finalize(self, batch):
        def tf(arr):
            return transforms.eval_transform(
                torch.from_numpy(arr).to(self.device),
                resolution=self.resolution)

        if len({b.shape for b in batch}) == 1:
            return tf(np.stack(batch))  # uniform sizes: one batched resize
        # mixed sizes: resize each full frame on its own (padding into a
        # larger canvas would leave black borders)
        return torch.cat([tf(b[None]) for b in batch], dim=0)


class MultiResolutionStore:
    """Prebuilt per-resolution tile store, the reference's LMDB
    ``MultiResolutionDataset`` (keys ``{resolution}-{index:05d}``): one
    memory-mapped ``res_{s:04d}.npy`` uint8 array [N, s, s, 3] a resolution
    plus ``meta.json``; the same ``NewResolution`` / ``batches`` surface as
    :class:`ImageFolderDataset`. The files are the JAX package's."""

    META = "meta.json"

    def __init__(self, path: str, *, seed: int | None = None, device=None):
        self.root = path
        self.device = resolve_device(device)
        with open(os.path.join(path, self.META)) as f:
            meta = json.load(f)
        self.length = int(meta["length"])
        self.resolutions = sorted(int(r) for r in meta["resolutions"])
        self._rng = np.random.default_rng(seed)
        self._maps = {}
        self.resolution = None
        self.batch_size = 4

    @classmethod
    def build(cls, src_root: str, out_dir: str, *,
              resolutions=(4, 8, 16, 32, 64, 128, 256, 512),
              seed: int | None = None, max_items: int | None = None,
              chunk: int = 64, device=None) -> "MultiResolutionStore":
        """Prebuild the store from a folder of images / ``.npy`` tile
        stacks: every image, and every tile of every stack, resized to
        every resolution (the eval transform's anti-aliased bilinear, on
        ``device``) and stored as uint8. Resolutions start at 4, where
        progressive training begins."""
        device = resolve_device(device)
        src = ImageFolderDataset(src_root, seed=seed, device=device)

        def iter_items():
            count = 0
            for path in src.files:
                if path.lower().endswith(".npy"):
                    arr = np.load(path, mmap_mode="r")
                    stack = arr if arr.ndim == 4 else arr[None]
                    for i in range(stack.shape[0]):
                        if max_items and count >= max_items:
                            return
                        yield np.asarray(stack[i], np.uint8)
                        count += 1
                else:
                    if max_items and count >= max_items:
                        return
                    yield src._load(path)
                    count += 1

        # count from the npy headers (+1 an image file): a counting pass
        # through iter_items would decode every image twice
        n = 0
        for path in src.files:
            if path.lower().endswith(".npy"):
                arr = np.load(path, mmap_mode="r")
                n += int(arr.shape[0]) if arr.ndim == 4 else 1
            else:
                n += 1
        if max_items:
            n = min(n, max_items)
        if n == 0:
            raise FileNotFoundError(f"no images under {src_root}")
        os.makedirs(out_dir, exist_ok=True)
        outs = {
            r: np.lib.format.open_memmap(
                os.path.join(out_dir, f"res_{r:04d}.npy"), mode="w+",
                dtype=np.uint8, shape=(n, r, r, 3))
            for r in resolutions}

        def resize(imgs, r):
            return transforms.resize_u8(torch.from_numpy(imgs).to(device),
                                        resolution=r).cpu().numpy()

        def flush(start, imgs):
            uniform = len({im.shape for im in imgs}) == 1
            for r in resolutions:
                batch = (resize(np.stack(imgs), r) if uniform else
                         np.concatenate([resize(im[None], r) for im in imgs]))
                outs[r][start:start + len(imgs)] = batch

        start, imgs = 0, []
        for img in iter_items():
            imgs.append(img)
            if len(imgs) == chunk:
                flush(start, imgs)
                start, imgs = start + len(imgs), []
        if imgs:
            flush(start, imgs)
        for mm in outs.values():
            mm.flush()
        with open(os.path.join(out_dir, cls.META), "w") as f:
            json.dump({"length": n,
                       "resolutions": sorted(int(r) for r in resolutions)}, f)
        return cls(out_dir, seed=seed, device=device)

    def NewResolution(self, image_size: int, batch_size: int = 4):
        image_size = int(image_size)
        if image_size not in self.resolutions:
            raise KeyError(
                f"resolution {image_size} not in store {self.resolutions}; "
                "rebuild with MultiResolutionStore.build(...)")
        self.resolution = image_size
        self.batch_size = int(batch_size)

    def reseed(self, *entropy: int):
        """As :meth:`ImageFolderDataset.reseed`."""
        self._rng = np.random.default_rng(np.random.SeedSequence(
            list(entropy)))

    def _memmap(self, res: int):
        if res not in self._maps:
            self._maps[res] = np.load(
                os.path.join(self.root, f"res_{res:04d}.npy"), mmap_mode="r")
        return self._maps[res]

    def __len__(self):
        return self.length

    def batches(self, *, shuffle: bool = True, drop_last: bool = True):
        """Yield [B, res, res, 3] float32 batches in [-1, 1], pre-resized:
        the only device work is the uint8 -> [-1, 1] normalize."""
        if self.resolution is None:
            raise RuntimeError("call NewResolution(size, batch) first")
        mm = self._memmap(self.resolution)
        order = np.arange(self.length)
        if shuffle:
            self._rng.shuffle(order)
        B = self.batch_size
        for start in range(0, self.length, B):
            idx = np.sort(order[start:start + B])  # sorted: faster memmap IO
            if len(idx) < B and drop_last:
                return
            raw = torch.from_numpy(np.ascontiguousarray(mm[idx]))
            yield transforms.normalize_u8(raw.to(self.device))


# the name the reference's GAN trainers import for their (missing) bag
# streamer (reference: style-based-gan-pytorch-master-512/train.py:18,306)
BCSingleBagDatasetSimple = ImageFolderDataset


def build_argparser():
    import argparse

    ap = argparse.ArgumentParser(
        description="Prebuild a resolution-keyed GAN tile store "
                    "(the reference's LMDB prepare step).")
    ap.add_argument("--src", required=True, help="image / tile-stack folder")
    ap.add_argument("--out", required=True, help="store output directory")
    ap.add_argument("--max-size", type=int, default=512)
    ap.add_argument("--min-size", type=int, default=4,
                    help="progressive training starts at 4x4; keep 4 "
                         "unless --init_size is raised to match")
    ap.add_argument("--max-items", type=int, default=None)
    ap.add_argument("--seed", type=int, default=None)
    return ap


def _main(argv=None, *, device=None):
    args = build_argparser().parse_args(argv)
    res = []
    r = args.min_size
    while r <= args.max_size:
        res.append(r)
        r *= 2
    store = MultiResolutionStore.build(
        args.src, args.out, resolutions=tuple(res), seed=args.seed,
        max_items=args.max_items, device=device)
    print(f"built {args.out}: {len(store)} items @ {store.resolutions}")
    return 0


if __name__ == "__main__":
    _main()
