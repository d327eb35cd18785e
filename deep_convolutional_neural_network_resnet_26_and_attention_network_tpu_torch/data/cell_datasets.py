"""Cell-crop and IHC bag datasets (aux experiments).

Counterpart of ``data/cell_datasets.py`` in the JAX package (reference:
Datasets.py:24-347):

  CellImageDataset           masked whole-cell crops (raw & nucleus masks)
  CellImageDatasetHE         DAB-channel extraction + filename coord parse
  CellImageDatasetRandomSpot random 512px crops with contrast rejection
  IHCMixedBagDataset         128-tile paired RGB/DAB bags from a driver CSV

All items come back as float32 numpy arrays normalized with
(mean 0.5, std 0.6) like the reference's ``finalize`` transform
(reference: Datasets.py:37-40). Channel order is HWC.

The JAX package reads images with cv2 and the driver CSV with pandas,
which the card's machine does not have. Here images are read with Pillow
(imported only inside :func:`_imread`, behind a guard): RGB images as
RGB, masks as 8-bit grey, and ``cv2.bitwise_and(img, img, mask=m)`` is
``where(m != 0, img, 0)``. The CSV is read with the ``csv`` module: its
first column is the index (``index_col=0``), and pandas'
``sample(frac=1, random_state=seed)`` is the row order
``np.random.RandomState(seed).permutation(n)``. Crops go through
``utils/helpers.RandomCrop2X`` seeded as in the JAX package, so the items
equal the JAX package's bit for bit.
"""

import csv
import glob
import os
import random
import re

import numpy as np

from ..utils.helpers import RandomCrop2X
from . import stain

MEAN, STD = 0.5, 0.6


def _finalize(img):
    """ToTensor + Normalize(0.5, 0.6): [0,1] float or uint8 HWC -> HWC f32."""
    arr = np.asarray(img)
    if arr.dtype == np.uint8:
        arr = arr.astype(np.float32) / 255.0
    else:
        arr = arr.astype(np.float32)
    if arr.ndim == 2:
        arr = arr[..., None]
    return (arr - MEAN) / STD


def _stddev_r(img) -> float:
    """Population stddev of channel 0 (PIL ImageStat parity)."""
    arr = np.asarray(img, np.float64)
    ch = arr[..., 0] if arr.ndim == 3 else arr
    return float(ch.std())


def _imread(path, mode):
    """An image file as a uint8 array, in PIL ``mode`` ("RGB" or "L")."""
    try:
        from PIL import Image
    except ImportError:
        raise RuntimeError("the cell datasets need Pillow to read images, "
                           "which is not installed") from None
    with Image.open(path) as im:
        return np.asarray(im.convert(mode))


def _imread_rgb(path):
    return _imread(path, "RGB")


def _mask_and(img, mask):
    """``cv2.bitwise_and(img, img, mask=mask)``."""
    return np.where((mask != 0)[..., None], img, 0).astype(img.dtype)


class CellImageDataset:
    """Masked cell crops: raw image AND cell mask AND NOT nucleus mask
    (reference: Datasets.py:24-83)."""

    def __init__(self, root_dir, transform=None, max_size=128 * 128):
        self.transform = transform
        self.max_size = max_size
        self.data_store = []
        for img_name in glob.glob(root_dir + "*wholecell-raw.png.jpg"):
            raw = _imread_rgb(img_name)
            cell = _imread(img_name.replace("wholecell-raw.png.jpg",
                                            "wholecell-mask.png"), "L")
            nucl = 255 - _imread(img_name.replace("wholecell-raw.png.jpg",
                                                  "nucleus-mask.png"), "L")
            self.data_store.append(_mask_and(_mask_and(raw, cell), nucl))
            if len(self.data_store) >= self.max_size:
                break

    def __len__(self):
        return len(self.data_store)

    def __getitem__(self, idx):
        image = self.data_store[idx]
        if self.transform:
            image = self.transform(image)
        return {"image": _finalize(image)}


def parse_coords_from_name(img_name: str):
    """Center coordinates from 'x_y_w_h'-style filename digits
    (reference: Datasets.py:113-120). The regex is the reference's own,
    with its quirk: each number needs >= 2 digits, so a single-digit field
    drops a match and the function returns (0, 0)."""
    nums = re.findall(r"(\d+[.]?\d+)", img_name.split(os.sep)[-1])
    if len(nums) == 5:
        x = int(float(nums[1])) + 0.5 * int(float(nums[3]))
        y = int(float(nums[2])) + 0.5 * int(float(nums[4]))
        return np.asarray([x, y], np.float32)
    return np.zeros((2,), np.float32)


class CellImageDatasetHE:
    """IHC crops: paired (DAB plane, raw RGB, coords), random 64px crop
    (reference: Datasets.py:86-180)."""

    def __init__(self, root_dir, transform=None, max_size=64 * 256,
                 seed=None):
        self.transform = transform
        self.data_store, self.data_raw, self.coord_store = [], [], []
        self._rng = random.Random(seed)
        for img_name in glob.glob(root_dir + "*wholecell-raw.png*"):
            if len(self.data_store) >= max_size:
                break
            raw = _imread_rgb(img_name)
            self.data_raw.append(raw)
            self.data_store.append(stain.dab_channel(raw))
            self.coord_store.append(parse_coords_from_name(img_name))

    def __len__(self):
        return len(self.data_store)

    def __getitem__(self, idx):
        image, raw = self.data_store[idx], self.data_raw[idx]
        # a fresh seed each call: a fixed seed would freeze the crop
        crop_i, crop_r, _ = RandomCrop2X(
            64, pad_if_needed=True,
            seed=self._rng.randint(0, 2**31 - 1)).Execute(image, raw)
        if self.transform:
            crop_i, crop_r = self.transform(crop_i), self.transform(crop_r)
        return {"image": _finalize(crop_i), "raw": _finalize(crop_r),
                "xy": self.coord_store[idx]}


class CellImageDatasetRandomSpot:
    """Random 512px spots with contrast rejection (stddev_R >= 5)
    (reference: Datasets.py:185-250)."""

    def __init__(self, root_glob, transform=None, size=1024, seed=None):
        self.n_randomsamples = size
        self.transform = transform
        self.data_store, self.data_raw = [], []
        self._rng = random.Random(seed)
        for img_name in glob.glob(root_glob):
            raw = _imread_rgb(img_name)
            self.data_raw.append(raw)
            self.data_store.append(stain.dab_channel(raw))
        if not self.data_raw:
            raise FileNotFoundError(f"no images match {root_glob}")

    def __len__(self):
        return self.n_randomsamples

    def __getitem__(self, idx):
        spot = self._rng.randint(0, len(self.data_raw) - 1)
        image_full, raw_full = self.data_store[spot], self.data_raw[spot]
        cropper = RandomCrop2X(512, pad_if_needed=True,
                               seed=self._rng.randint(0, 2**31 - 1))
        image, raw, coord = cropper.Execute(image_full, raw_full)
        tries = 0
        while _stddev_r(raw) < 5 and tries < 100:
            image, raw, coord = cropper.Execute(image_full, raw_full)
            tries += 1
        if self.transform:
            image, raw = self.transform(image), self.transform(raw)
        return _finalize(raw), _finalize(image), np.asarray(coord, np.float32)


def read_driver_csv(path, seed):
    """The driver CSV's rows (dicts by header, the index column dropped)
    in the order of pandas' ``read_csv(index_col=0).sample(frac=1,
    random_state=seed)``."""
    with open(path, newline="") as f:
        reader = csv.reader(f)
        header = next(reader)[1:]
        rows = [dict(zip(header, r[1:])) for r in reader if r]
    order = np.random.RandomState(seed).permutation(len(rows))
    return [rows[i] for i in order]


class IHCMixedBagDataset:
    """128-tile paired RGB/DAB bags from a driver CSV with columns
    image_path,label (reference: Datasets.py:258-347; the reference caps
    each class at 2 cores and shuffles with seed 42)."""

    def __init__(self, driver_csv, transform=None, size=1024,
                 mini_batch_size=128, per_class_cap=2, seed=42):
        self.mini_batch_size = mini_batch_size
        self.transform = transform
        self._rng = random.Random(seed)
        self.data_raw_rgb, self.data_raw_dab, self.data_raw_out = [], [], []

        counts = {0: 0, 1: 0}
        for row in read_driver_csv(driver_csv, seed):
            outcome = int(float(row["label"]))
            counts[outcome] = counts.get(outcome, 0) + 1
            if counts[outcome] > per_class_cap:
                continue
            raw = _imread_rgb(row["image_path"])
            self.data_raw_rgb.append(raw)
            self.data_raw_dab.append(stain.dab_channel(raw))
            self.data_raw_out.append(np.asarray([outcome], np.float32))

    def __len__(self):
        return len(self.data_raw_rgb)

    def __getitem__(self, idx):
        rgb_full = self.data_raw_rgb[idx]
        dab_full = self.data_raw_dab[idx]
        label = self.data_raw_out[idx]
        rgb_tiles, dab_tiles, coords, labels = [], [], [], []
        while len(rgb_tiles) < self.mini_batch_size:
            cropper = RandomCrop2X(256, pad_if_needed=True,
                                   seed=self._rng.randint(0, 2**31 - 1))
            dab, rgb, coord = cropper.Execute(dab_full, rgb_full)
            tries = 0
            while _stddev_r(rgb) < 2 and tries < 100:
                dab, rgb, coord = cropper.Execute(dab_full, rgb_full)
                tries += 1
            if self.transform:
                dab, rgb = self.transform(dab), self.transform(rgb)
            rgb_tiles.append(_finalize(rgb))
            dab_tiles.append(_finalize(dab))
            coords.append(np.asarray(coord, np.float32))
            labels.append(label)
        return (np.stack(rgb_tiles), np.stack(dab_tiles),
                np.stack(coords), np.stack(labels))
