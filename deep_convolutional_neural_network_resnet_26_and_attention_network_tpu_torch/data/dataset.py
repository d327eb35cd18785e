"""Slide-level bag dataset for the glioblastoma 3-class task.

Counterpart of ``data/dataset.py`` in the JAX package, after the
reference's GHPSingleBagDatasetSimple (reference:
gbm/GlioblastomaDS.py:34-281): glob ``*H&E.scn`` slides labeled A/B/C=0/1/2
through the k-means cluster spreadsheet, plus ``*.svs`` "super normals"
forced to label 1; drop slides with fewer than 20 cached tiles; 6-fold
KFold split with a randomized fold pick; persist the split as
``training_validation_testing_data<timestamp>.json`` (same schema, so old
split checkpoints restore here and vice versa).

Differences from the reference (config, not behavior): the dataset roots,
glob patterns, and spreadsheet path are constructor arguments instead of
hardcoded ``/raid/...`` constants (reference: gbm/GlioblastomaDS.py:52-54),
and bags come back as NHWC float32 tensors on the dataset's device (the
card unless ``device="cpu"``). The fold split is the port's own
:class:`KFold`, equal to scikit-learn's, which the machines the port runs
on need not have. Label sheets are read as csv (``data/accessors``): the
default .xlsx name stops with a message to convert it.
"""

import glob
import json
import os
import random as pyrandom
from datetime import datetime

import numpy as np

from .._device import resolve_device
from . import accessors
from .roibuilder import RoiBuilder

CLUSTER_TO_OUTCOME = {"A": 0, "B": 1, "C": 2}
MIN_TILES = 20  # reference: gbm/GlioblastomaDS.py:170,194


class KFold:
    """scikit-learn's ``KFold(n_splits, shuffle, random_state)``: with
    ``shuffle`` the sample indices are permuted by
    ``np.random.RandomState(random_state).shuffle``; the first
    ``n % n_splits`` folds hold one sample more than ``n // n_splits``;
    ``split`` yields (train, test) index arrays, each in ascending order."""

    def __init__(self, n_splits: int = 5, *, shuffle: bool = False,
                 random_state=None):
        if n_splits < 2:
            raise ValueError(f"n_splits={n_splits}: need at least 2 folds")
        self.n_splits = n_splits
        self.shuffle = shuffle
        self.random_state = random_state

    def split(self, X):
        n = len(X)
        if self.n_splits > n:
            raise ValueError(f"cannot make {self.n_splits} folds of {n} "
                             "samples")
        indices = np.arange(n)
        if self.shuffle:
            np.random.RandomState(self.random_state).shuffle(indices)
        sizes = np.full(self.n_splits, n // self.n_splits, dtype=int)
        sizes[:n % self.n_splits] += 1
        start = 0
        for size in sizes:
            test = np.zeros(n, bool)
            test[indices[start:start + size]] = True
            start += size
            yield np.flatnonzero(~test), np.flatnonzero(test)


def _base_idx(file: str) -> str:
    """Slide-id stem from a filename: text before the first space/dash
    (the GHP_<n>_<biopsy> convention; reference:
    gbm/GlioblastomaDS.py:137-144). One definition — labels, caMicroscope
    ids, and split restores must parse identically."""
    return os.path.split(file)[1].split(" ")[0].split("-")[0]


class GHPSingleBagDatasetSimple:
    """One item = one whole-slide bag of tiles + its slide-level label."""

    def __init__(self, bag: bool = True, output_dir: str = ".",
                 split: float = 0.90, *,
                 root_dir: str = "/raid/GHP Immunohistochemistry/",
                 image_dir: str = "All_HE_scans_GBM_AN",
                 label_sheet: str | None = None,
                 scn_glob: str = "*H&E.scn",
                 svs_glob: str = "*.svs",
                 ylabel: str = "Actual Cluster Designation",
                 roi_size: int | None = None,
                 seed: int | None = None,
                 train_pad: int | None = None,
                 device=None):
        self.train_slide_builders, self.train_slide_outcomes = [], []
        self.train_slide_path, self.train_slide_record = [], []
        self.test_slide_builders, self.test_slide_outcomes = [], []
        self.test_slide_path, self.test_slide_record = [], []
        self.all_builders, self.all_slide_outcomes = [], []
        self.all_slide_path, self.all_slide_record = [], []

        self.ROOT_DIR = root_dir
        self.PATH_IMG = image_dir
        self.scn_glob = scn_glob
        self.svs_glob = svs_glob
        self.label_sheet = label_sheet or os.path.join(
            root_dir, "PCA Clustering designation and thresholds.xlsx")
        self.device = resolve_device(device)
        # accepted for call-signature parity with the reference
        # (gbm/GlioblastomaDS.py:34); the split is governed by KFold, and
        # bags are the only mode here — neither knob alters behavior
        self.bagmode = bag
        self.ylabel = ylabel
        self.roi_size = roi_size  # None -> RoiBuilder default (1200)
        self.train_pad = train_pad  # None -> scaled reference pad
        self.split = split
        self.output_dir = output_dir
        self.studyid = "gmb-id-nn"
        self.mode = "train"
        # train bags as DeferredTrainBag (a mesh rank transforms only its
        # share of each bag's subsample)
        self.defer_train = False
        self._py_rng = pyrandom.Random(seed)
        self._np_rng = np.random.default_rng(seed)

    def _builder(self, file: str, params: dict) -> RoiBuilder:
        if self.roi_size is not None:
            params.setdefault("roi_size", self.roi_size)
        if self.train_pad is not None:
            params.setdefault("train_pad", self.train_pad)
        return RoiBuilder(file, params=params, device=self.device)

    # ------------------------------------------------------------------
    def _save_split(self):
        d = {
            "train_paths": self.train_slide_path,
            "train_outcomes": self.train_slide_record,
            "validation_paths": self.test_slide_path,
            "validation_outcomes": self.test_slide_record,
        }
        stamp = datetime.now().strftime("%d-%b-%Y-%H-%M-%S")
        path = os.path.join(
            self.output_dir, f"training_validation_testing_data{stamp}.json")
        with open(path, "w") as f:
            json.dump(d, f, indent=4, sort_keys=True)
        return path

    def load_from_checkpoint(self, split_data_path: str, *,
                             save: bool = True):
        """Restore a saved train/validation split
        (reference: gbm/GlioblastomaDS.py:61-117) and, with ``save``,
        write it again to the output directory."""
        with open(split_data_path) as f:
            d = json.load(f)
        for file, out in zip(d["train_paths"], d["train_outcomes"]):
            params = {
                "caMIC_eligable": -1, "camic_id": "000",
                "studyid": "checkpoint-training",
                "pxname": _base_idx(file),
                "outcome_item": out, "outcome_tensor": np.asarray([out]),
            }
            b = self._builder(file, params)
            self.train_slide_builders.append(b)
            self.train_slide_outcomes.append(np.asarray([out]))
            self.train_slide_path.append(file)
            self.train_slide_record.append(out)
        for file, out in zip(d["validation_paths"], d["validation_outcomes"]):
            params = {
                "caMIC_eligable": -1, "camic_id": "000",
                "studyid": "checkpoint-validation",
                "pxname": _base_idx(file),
                "outcome_item": out, "outcome_tensor": np.asarray([out]),
            }
            b = self._builder(file, params)
            self.test_slide_builders.append(b)
            self.test_slide_outcomes.append(np.asarray([out]))
            self.test_slide_path.append(file)
            self.test_slide_record.append(out)
        if save:
            self._save_split()

    def GetClassWeights(self):
        """'balanced' class weights over the training labels, always
        length n_classes=3 (reference: gbm/GlioblastomaDS.py:119-120 via
        sklearn). The sklearn call returns weights only for PRESENT
        classes — a fold missing one class would hand the fixed 3-class
        loss a length-2 vector; absent classes get weight 0 instead
        (they cannot appear in training loss anyway)."""
        y = np.asarray(self.train_slide_record)
        counts = np.asarray([(y == c).sum() for c in range(3)], np.float32)
        present = counts > 0
        weights = np.zeros(3, np.float32)
        # sklearn 'balanced': n_samples / (n_present_classes * count_c)
        weights[present] = len(y) / (present.sum() * counts[present])
        return weights

    # ------------------------------------------------------------------
    def _label_for_scn(self, file: str) -> int:
        base_idx = _base_idx(file)
        identifiers = accessors.split_GHP_convention(
            base_idx, dtypes=[str, int, str])
        outcome = -9
        if "Cluster" in self.ylabel:
            clus = accessors.getClusterIndex(
                identifiers, self.ylabel, filename=self.label_sheet,
                dtypes=[str, int, str])
            outcome = CLUSTER_TO_OUTCOME.get(clus, -9)
        return outcome

    def _add_builder(self, file: str, outcome: int, pxname: str):
        base_idx = _base_idx(file)
        params = {
            "caMIC_eligable": -1,
            "caMIC_image_name": base_idx.replace("_H&E", "_HandE"),
            "caMIC_base_name": base_idx.replace("_H&E", "_HandE").split(".")[0],
            "caMIC_id_name": base_idx.replace("_H&E", "").split(".")[0],
            "caMIC_study": "gbm-classif-nn",
            "caMIC_pxname": pxname,
            "outcome_item": outcome,
            "outcome_tensor": np.asarray([outcome]),
        }
        builder = self._builder(file, params)
        if builder.getsize() < MIN_TILES:
            return
        self.all_builders.append(builder)
        self.all_slide_outcomes.append(np.asarray([outcome]))
        self.all_slide_path.append(file)
        self.all_slide_record.append(outcome)

    def load_new(self, n_folds: int = 6, n_fold_selection: int = 0, *,
                 save: bool = True):
        """Discover slides, label them, and make a randomized KFold split
        (reference: gbm/GlioblastomaDS.py:123-238). ``save`` writes the
        split JSON (returning its path); a mesh rank other than 0 passes
        False, since rank 0 writes it."""
        for file in sorted(glob.glob(
                os.path.join(self.ROOT_DIR, self.PATH_IMG, self.scn_glob))):
            outcome = self._label_for_scn(file)
            if outcome not in (0, 1, 2):
                continue
            base_idx = _base_idx(file)
            ids = accessors.split_GHP_convention(base_idx, dtypes=[str, int, str])
            self._add_builder(file, outcome, f"{ids[0]}_{ids[1]}_{ids[2]}")

        for file in sorted(glob.glob(
                os.path.join(self.ROOT_DIR, self.PATH_IMG, self.svs_glob))):
            base_idx = _base_idx(file)
            name = base_idx.replace("_H&E", "_HandE").split(".")[0]
            self._add_builder(file, 1, f"SN_{name}")  # super-normals -> 1

        if len(self.all_builders) < n_folds:
            raise RuntimeError(
                f"found {len(self.all_builders)} usable slides under "
                f"{os.path.join(self.ROOT_DIR, self.PATH_IMG)} (need >= "
                f"{n_folds} for {n_folds}-fold split). Check --data_root/"
                "--image_dir, the label sheet, the tile cache in $CACHE_DIR, "
                "and --roi_size (cache filenames encode the tile size); "
                f"slides with < {MIN_TILES} cached tiles are dropped.")
        folds = list(KFold(n_folds, shuffle=True,
                           random_state=self._np_rng.integers(0, 2**31 - 1))
                     .split(self.all_builders))
        if 0 <= n_fold_selection < n_folds:
            # an explicit fold REALLY selects that fold — the reference
            # accepted n_fold_selection but then drew a random middle fold
            # regardless (gbm/GlioblastomaDS.py:202-205), making
            # CLI-driven cross-validation impossible; --fold N here means
            # folds[N] (PARITY.md deviation)
            train, test = folds[n_fold_selection]
        elif n_fold_selection < 0:
            # reference behavior: seeded-random pick among the middle folds
            n_split = max(n_folds - 2, 1)
            n_select = min(self._py_rng.randrange(n_split) + 1, n_folds - 1)
            train, test = folds[n_select]
        else:
            train = test = range(len(self.all_builders))

        for idx in train:
            self.train_slide_builders.append(self.all_builders[idx])
            self.train_slide_outcomes.append(self.all_slide_outcomes[idx])
            self.train_slide_path.append(self.all_slide_path[idx])
            self.train_slide_record.append(self.all_slide_record[idx])
        for idx in test:
            self.test_slide_builders.append(self.all_builders[idx])
            self.test_slide_outcomes.append(self.all_slide_outcomes[idx])
            self.test_slide_path.append(self.all_slide_path[idx])
            self.test_slide_record.append(self.all_slide_record[idx])
        return self._save_split() if save else None

    # ------------------------------------------------------------------
    def NewResolution(self, image_size: int):
        """Dispatch a new output resolution to every builder
        (reference: gbm/GlioblastomaDS.py:240-246)."""
        for roi in self.train_slide_builders:
            roi.update_resolution_and_buffer(image_size)
        for roi in self.test_slide_builders:
            roi.update_resolution_and_buffer(image_size)
        for roi in self.all_builders:
            if "VALID" in roi.params["status"]:
                roi.update_resolution_and_buffer(image_size)

    def train(self):
        self.mode = "train"

    def reseed_augment(self, *entropy: int):
        """Pin every train builder's augmentation streams to
        (entropy..., builder_index) — with the driver passing
        (seed, epoch), a resumed run replays the exact augmentation of
        the uninterrupted run (bit-exact elastic resume)."""
        for i, b in enumerate(self.train_slide_builders):
            b.reseed_augment(*entropy, i)

    def build(self):
        self.mode = "build"

    def eval(self):
        self.mode = "eval"

    def interface(self):
        self.mode = "interface"

    def __len__(self):
        if self.mode == "train":
            return len(self.train_slide_builders)
        if self.mode == "build":
            return len(self.all_builders)
        if self.mode == "eval":
            return len(self.test_slide_builders)
        if self.mode == "interface":
            return len(self.all_builders)
        raise ValueError(f"unknown mode {self.mode!r}")

    def __getitem__(self, idx):
        if self.mode == "train":
            b = self.train_slide_builders[idx]
            return (b.get_train_data(deferred=self.defer_train),
                    b.params["outcome_tensor"])
        if self.mode == "build":
            return self.all_builders[idx].build(), 0
        if self.mode == "eval":
            b = self.test_slide_builders[idx]
            return b.get_validation_data(), b.params["outcome_tensor"]
        if self.mode == "interface":
            b = self.all_builders[idx]
            stack, coords, img_data = b.get_inference_data()
            return stack, b.params["outcome_tensor"], coords, b.params
        raise ValueError(f"unknown mode {self.mode!r}")
