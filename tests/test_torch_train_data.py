"""The port's training data path against the JAX package: train_transform
with injected crop offsets and flips (to 1e-6, the port's eval_transform
tolerance), the RoiBuilder's tile cap and augmentation streams, the bag
loader, the fold split (against scikit-learn's KFold and the JAX
dataset) and the label sheet reader."""

import csv
import os

import numpy as np
import pytest
import torch

import conftest  # noqa: F401
import jax
import jax.numpy as jnp
from sklearn.model_selection import KFold as SkKFold

from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu.data import (
    dataset as jdataset,
    roibuilder as jroibuilder,
    transforms as jtransforms,
)
from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.data import (
    accessors,
    dataset as tdataset,
    loader,
    roibuilder as troibuilder,
    transforms as ttransforms,
)


def _tiles(n, roi, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, (n, roi, roi, 3)).astype(np.uint8)


def _jax_train_transform(tiles, offsets, flip_h, flip_v, monkeypatch, **kw):
    """The JAX transform's own body, with its random draws patched to the
    given offsets and flips."""
    flips = [flip_h, flip_v]
    monkeypatch.setattr(jax.random, "randint",
                        lambda key, shape, lo, hi: jnp.asarray(offsets))
    monkeypatch.setattr(
        jax.random, "bernoulli",
        lambda key, p, shape: jnp.asarray(flips.pop(0)).reshape(shape))
    fn = jtransforms.train_transform.__wrapped__
    return np.asarray(fn(jnp.asarray(tiles), jax.random.PRNGKey(0), **kw))


@pytest.mark.parametrize("roi,res,pad", [(32, 16, 3), (20, 20, 2),
                                         (24, 16, 0)])
def test_train_transform_matches_jax(roi, res, pad, monkeypatch):
    n = 12
    tiles = _tiles(n, roi)
    rng = np.random.default_rng(1)
    offsets = rng.integers(0, 2 * pad + 1, (n, 2))
    flip_h, flip_v = rng.random(n) < 0.5, rng.random(n) < 0.5
    want = _jax_train_transform(tiles, offsets, flip_h, flip_v, monkeypatch,
                                roi_size=roi, resolution=res, pad=pad)
    got = ttransforms.train_transform(
        torch.from_numpy(tiles), torch.from_numpy(offsets),
        torch.from_numpy(flip_h), torch.from_numpy(flip_v), roi_size=roi,
        resolution=res, pad=pad)
    assert got.shape == want.shape == (n, res, res, 3)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)


def test_apply_chunked_hands_each_chunk_its_noise(monkeypatch):
    """Chunked over 5-tile chunks, the train transform equals one call."""
    tiles = _tiles(13, 16, seed=2)
    rng = np.random.default_rng(3)
    noise = (torch.from_numpy(rng.integers(0, 5, (13, 2))),
             torch.from_numpy(rng.random(13) < 0.5),
             torch.from_numpy(rng.random(13) < 0.5))
    kw = dict(roi_size=16, resolution=8, pad=2)
    whole = ttransforms.train_transform(torch.from_numpy(tiles), *noise, **kw)
    chunked = ttransforms.apply_chunked(
        ttransforms.train_transform, tiles, device="cpu", chunk=5,
        per_tile=noise, **kw)
    np.testing.assert_array_equal(chunked.numpy(), whole.numpy())


def _cache_slide(cache, name, n, roi, seed=0):
    base = f"{name}_H&E"
    np.save(os.path.join(cache, f"data_{base}_rois_size{roi}_hsvcut_v3.npy"),
            _tiles(n, roi, seed))
    np.save(os.path.join(cache, f"coor_{base}_rois_size{roi}_hsvcut_v3.npy"),
            np.stack([[i * roi, 0] for i in range(n)]))
    return f"/slides/{base}.scn"


def test_train_data_cap_picks_the_jax_tiles(tmp_path, monkeypatch):
    """Above 2500 tiles both packages draw the same 2500 from the same
    reseeded numpy stream (compared by each tile's mean, which the flips
    do not change; the crop jitter is off)."""
    monkeypatch.setenv("CACHE_DIR", str(tmp_path))
    path = _cache_slide(str(tmp_path), "GHP_1_A", 2600, 4)
    params = {"roi_size": 4, "train_pad": 0}
    port = troibuilder.RoiBuilder(path, dict(params), device="cpu")
    ref = jroibuilder.RoiBuilder(path, dict(params))
    for b in (port, ref):
        b.update_resolution_and_buffer(4)
        b.reseed_augment(0, 3, 1)
    got = port.get_train_data().numpy()
    want = np.asarray(ref.get_train_data())
    assert got.shape == want.shape == (troibuilder.TRAIN_TILE_CAP, 4, 4, 3)
    np.testing.assert_allclose(np.sort(got.mean(axis=(1, 2, 3))),
                               np.sort(want.mean(axis=(1, 2, 3))), atol=1e-6)


def test_train_data_streams_are_pinned_by_reseed(tmp_path, monkeypatch):
    monkeypatch.setenv("CACHE_DIR", str(tmp_path))
    path = _cache_slide(str(tmp_path), "GHP_2_B", 30, 16)
    b = troibuilder.RoiBuilder(path, {"roi_size": 16}, device="cpu")
    b.update_resolution_and_buffer(8)
    assert b.train_pad() == 1  # 100 px at roi 1200, scaled
    bags = []
    for entropy in ((0, 1, 2), (0, 1, 2), (0, 2, 2)):
        b.reseed_augment(*entropy)
        bags.append(b.get_train_data())
    assert bags[0].shape == (30, 8, 8, 3)
    assert torch.equal(bags[0], bags[1])
    assert not torch.equal(bags[0], bags[2])
    # train_pad 0 and no flips is the eval transform
    b.params["train_pad"] = 0
    monkeypatch.setattr(torch, "rand",
                        lambda n, generator=None: torch.ones(n))
    monkeypatch.setattr(torch, "randint",
                        lambda lo, hi, shape, generator=None:
                        torch.zeros(shape, dtype=torch.int64))
    np.testing.assert_allclose(b.get_train_data().numpy(),
                               b.get_validation_data().numpy(), atol=1e-6)


class _Bags:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return torch.full((i + 1, 2), float(i)), np.asarray([i % 3])


@pytest.mark.parametrize("workers", [1, 3])
def test_bag_prefetcher_order_masks_and_stats(workers):
    data = _Bags(7)
    pf = loader.BagPrefetcher(data, shuffle=True, seed=11, workers=workers)
    got = list(pf)
    order = np.arange(7)
    np.random.default_rng(11).shuffle(order)
    seen = [int(t[0, 0]) for t, _, _ in got]
    if workers == 1:
        assert seen == list(order)
    assert sorted(seen) == list(range(7))
    for tiles, mask, label in got:
        i = int(tiles[0, 0])
        assert mask.shape == (i + 1,) and bool(torch.all(mask == 1.0))
        assert label == i % 3
    assert pf.stats["bags"] == 7 and pf.stats["produce_s"] > 0.0
    assert 0.0 <= pf.stall_fraction() <= 1.0
    with pytest.raises(ValueError, match="shuffle"):
        loader.BagPrefetcher(data, shuffle=False, workers=2)


def test_epoch_loader_seed_is_the_jax_one():
    from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu.data import (
        loader as jloader,
    )

    for seed, epoch in ((0, 0), (3, 7), (12, 340)):
        assert loader.epoch_loader_seed(seed, epoch) == \
            jloader.epoch_loader_seed(seed, epoch)


@pytest.mark.parametrize("n,k,state", [(6, 6, 5), (13, 6, 123),
                                       (40, 5, 2**31 - 2), (7, 3, 0)])
def test_kfold_equals_sklearn(n, k, state):
    got = list(tdataset.KFold(k, shuffle=True, random_state=state)
               .split(list(range(n))))
    want = list(SkKFold(k, shuffle=True, random_state=state)
                .split(list(range(n))))
    assert len(got) == len(want) == k
    for (gt, gs), (wt, ws) in zip(got, want):
        np.testing.assert_array_equal(gt, wt)
        np.testing.assert_array_equal(gs, ws)


@pytest.fixture
def tree(tmp_path, monkeypatch):
    cache = tmp_path / "cache"
    cache.mkdir()
    monkeypatch.setenv("CACHE_DIR", str(cache))
    (tmp_path / "slides").mkdir()
    rows = [["id", ""], ["hdr", "Actual Cluster Designation"]]
    for i, (c, cl) in enumerate(zip("ABCEFGH", "ABCABCA")):
        name = f"GHP_{i + 1}_{c}"
        rows.append([name, cl])
        (tmp_path / "slides" / f"{name}_H&E.scn").write_bytes(b"fake")
        _cache_slide(str(cache), name, 19 if c == "H" else 24, 8, seed=i)
    with open(tmp_path / "clusters.csv", "w", newline="") as f:
        csv.writer(f).writerows(rows)
    return tmp_path


@pytest.mark.parametrize("fold", [0, 3, -1, 6])
def test_dataset_split_matches_jax(tree, fold):
    """The same slides, labels, split and class weights as the JAX
    dataset (the 19-tile slide falls under MIN_TILES in both)."""
    kw = dict(output_dir=str(tree), root_dir=str(tree), image_dir="slides",
              label_sheet=str(tree / "clusters.csv"), roi_size=8, seed=4)
    port = tdataset.GHPSingleBagDatasetSimple(device="cpu", **kw)
    ref = jdataset.GHPSingleBagDatasetSimple(**kw)
    for d in (port, ref):
        d.load_new(n_folds=6, n_fold_selection=fold)
    assert len(port.all_builders) == 6
    assert port.train_slide_path == ref.train_slide_path
    assert port.test_slide_path == ref.test_slide_path
    assert port.train_slide_record == ref.train_slide_record
    np.testing.assert_array_equal(port.GetClassWeights(),
                                  ref.GetClassWeights())
    port.NewResolution(8)
    port.train()
    tiles, label = port[0]
    assert tiles.device.type == "cpu" and int(label[0]) in (0, 1, 2)


def test_label_sheet_csv_lookup_and_xlsx_refused(tree):
    sheet = str(tree / "clusters.csv")
    ids = accessors.split_GHP_convention("GHP_2_B", dtypes=[str, int, str])
    assert accessors.getClusterIndex(ids, "Actual Cluster Designation",
                                     sheet) == "B"
    with pytest.raises(SystemExit, match="csv"):
        accessors.getClusterIndex(ids, "Actual Cluster Designation",
                                  str(tree / "clusters.xlsx"))
