"""The port's stain deconvolution and cell / IHC datasets against the JAX
package's ``data/stain.py`` and ``data/cell_datasets.py``.

Stain math is numpy in both packages and is held bit for bit. The
datasets are held bit for bit on the files of the JAX package's own
``ihc_tree`` fixture (JPEGs and PNG masks written by cv2, a driver CSV
written by pandas): the port reads the images with Pillow and the CSV
with the ``csv`` module, the JAX package with cv2 and pandas."""

import glob

import numpy as np
import pytest

import conftest  # noqa: F401

from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu.data import (
    cell_datasets as jcells,
    stain as jstain,
)
from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.data import (
    cell_datasets as cells,
    stain,
)


def test_stain_math_bit_for_bit():
    rng = np.random.default_rng(0)
    rgb = rng.random((6, 7, 3))
    u8 = rng.integers(0, 256, (9, 5, 3), np.uint8)
    for name, arg in (("rgb2hed", rgb), ("_rgb2hed_2019", rgb),
                      ("img_as_float", u8), ("img_as_float", rgb),
                      ("dab_channel", u8)):
        got, want = getattr(stain, name)(arg), getattr(jstain, name)(arg)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    hed = stain.rgb2hed(rgb)
    np.testing.assert_array_equal(stain.hed2rgb(hed), jstain.hed2rgb(hed))
    x = rng.standard_normal(50) * 0.2 - 0.4
    np.testing.assert_array_equal(stain.rescale_intensity(x, (-0.45, -0.3)),
                                  jstain.rescale_intensity(x, (-0.45, -0.3)))
    np.testing.assert_array_equal(
        stain.dab_channel(u8, in_range=(-0.5, -0.2)),
        jstain.dab_channel(u8, in_range=(-0.5, -0.2)))


@pytest.fixture
def ihc_tree(tmp_path):
    """The JAX package's fixture (tests/test_aux_models.py), and one cell
    with a partial cell mask and a nucleus, so the masking shows."""
    import cv2

    rng = np.random.default_rng(0)
    d = tmp_path / "cells"
    d.mkdir()
    for i in range(3):
        img = rng.integers(0, 256, (96, 96, 3), np.uint8)
        name = f"c77_{10+i}_{20+i}_{30}_{40}_wholecell-raw.png.jpg"
        cv2.imwrite(str(d / name), img)
        mask = np.full((96, 96), 255, np.uint8)
        nucleus = np.zeros((96, 96), np.uint8)
        if i == 2:
            mask[:, :40] = 0
            nucleus[50:70, 50:70] = 255
        cv2.imwrite(str(d / name.replace("wholecell-raw.png.jpg",
                                         "wholecell-mask.png")), mask)
        cv2.imwrite(str(d / name.replace("wholecell-raw.png.jpg",
                                         "nucleus-mask.png")), nucleus)
    return str(d) + "/"


def _same(got, want):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            _same(got[k], want[k])
    elif isinstance(want, tuple):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w)
    else:
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


def test_cell_image_dataset(ihc_tree):
    ds, jds = cells.CellImageDataset(ihc_tree), jcells.CellImageDataset(
        ihc_tree)
    assert len(ds) == len(jds) == 3
    for i in range(3):
        _same(ds[i], jds[i])
    names = glob.glob(ihc_tree + "*wholecell-raw.png.jpg")  # the order read
    masked = ds.data_store[[k for k, n in enumerate(names)
                            if "_12_22_" in n][0]]
    assert (masked[:, :40] == 0).all() and (masked[55:65, 55:65] == 0).all()
    assert masked[:, 40:50].any()


def test_cell_image_dataset_he(ihc_tree):
    ds = cells.CellImageDatasetHE(ihc_tree, seed=0)
    jds = jcells.CellImageDatasetHE(ihc_tree, seed=0)
    assert len(ds) == len(jds) == 3
    for i in (0, 1, 2, 0):
        _same(ds[i], jds[i])
    assert ds[1]["image"].shape == (64, 64, 1)
    for name in ("c77_10_20_30_40_wholecell-raw.png.jpg", "a_1_2_3_4.png"):
        np.testing.assert_array_equal(cells.parse_coords_from_name(name),
                                      jcells.parse_coords_from_name(name))


def test_cell_image_dataset_random_spot(ihc_tree):
    ds = cells.CellImageDatasetRandomSpot(ihc_tree + "*raw.png.jpg", size=3,
                                          seed=1)
    jds = jcells.CellImageDatasetRandomSpot(ihc_tree + "*raw.png.jpg",
                                            size=3, seed=1)
    assert len(ds) == len(jds) == 3
    for i in range(3):
        _same(ds[i], jds[i])
    with pytest.raises(FileNotFoundError):
        cells.CellImageDatasetRandomSpot(ihc_tree + "*.none")


def test_ihc_mixed_bag_dataset(ihc_tree, tmp_path):
    import pandas as pd

    files = sorted(glob.glob(ihc_tree + "*raw.png.jpg"))
    df = pd.DataFrame({"image_path": files + files[:2],
                       "label": [0, 1, 0, 1, 0]})
    driver = tmp_path / "driver.csv"
    df.to_csv(driver)
    ds = cells.IHCMixedBagDataset(str(driver), mini_batch_size=4)
    jds = jcells.IHCMixedBagDataset(str(driver), mini_batch_size=4)
    assert len(ds) == len(jds) == 4           # label 0 capped at 2
    for i in range(4):
        _same(ds[i], jds[i])
    rgb, dab, coords, labels = ds[0]
    assert rgb.shape == (4, 256, 256, 3) and dab.shape == (4, 256, 256, 1)


@pytest.mark.parametrize("n", [4, 7, 20])
def test_driver_csv_order_is_pandas_sample(n, tmp_path):
    import pandas as pd

    df = pd.DataFrame({"image_path": [f"img{i}.jpg" for i in range(n)],
                       "label": [i % 2 for i in range(n)]})
    path = tmp_path / "d.csv"
    df.to_csv(path)
    want = pd.read_csv(path, index_col=0).sample(frac=1, random_state=42)
    rows = cells.read_driver_csv(str(path), 42)
    assert [r["image_path"] for r in rows] == list(want["image_path"])
    assert [int(r["label"]) for r in rows] == list(want["label"])
