"""The port's caMicroscope interface mode (``classify.main([...,
"--interface"])``) held to the JAX package's, on one synthetic cohort.

Both CLIs run at the tiny arch in float32 (``--f32``) from one JAX-written
checkpoint, with the same output root, so every path they write is the
same: the manifests and ``move_images.sh`` must be identical, both result
tables must have the same header and index with values within 1e-5, and
every ``.dla`` map the same coordinates with weights within 1e-5. The
port runs once on the bag path and once with ``--stream_tiles 1`` (every
slide streams), each against JAX's bag path (measured at most 5.5e-6, on
a min-max normalized ``.dla`` weight of the streamed run); and once with
``--int8`` against JAX's ``--int8``, within 1e-4 (measured 1.9e-6: both
quantize the same weights bit for bit, and their calibration scales
differ only by float32 rounding, which can move one activation a
quantization step). JAX runs once per mode for the whole module. Also
the table writer against pandas, the printed report against
scikit-learn, and ``--int8``'s serving-only rule."""

import os
import shutil

import numpy as np
import pandas as pd
import pytest
from sklearn.metrics import classification_report

import conftest  # noqa: F401
import jax

from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu.models import (
    attention_mil as jamil,
)
from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu.train import (
    checkpoint as jckpt,
    classify as jclassify,
)
from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.train import (
    classify,
)
from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.utils import (
    helpers,
)

TEXT_FILES = ("manifest_img.csv", "manifest_heat.csv", "move_images.sh")
TABLES = ("GBMresult_probs_class.csv", "GBMdata_slideEBs_class.csv")
INT8 = ("--int8", "--int8_calib", "32")


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    """Six cached slides of 20-40 tiles at roi 32 in the GHP_<n>_<x>_H&E
    convention, a csv cluster sheet and a JAX checkpoint; JAX's interface
    output in float32 (``jax_f32``) and with ``--int8`` (``jax_int8``)."""
    root = tmp_path_factory.mktemp("iface")
    cache = root / "cache"
    cache.mkdir()
    (root / "slides").mkdir()
    rng = np.random.default_rng(11)
    rows = [["id", ""], ["hdr", "Actual Cluster Designation"]]
    for i, c, cl in [(1, "A", "A"), (2, "B", "B"), (3, "C", "C"),
                     (5, "E", "A"), (6, "F", "B"), (7, "G", "C")]:
        base = f"GHP_{i}_{c}_H&E"
        rows.append(f"GHP_{i}_{c},{cl}".split(","))
        (root / "slides" / f"{base}.scn").write_bytes(b"fake")
        n = int(rng.integers(20, 41))
        tiles = np.clip(np.array([140, 60, 170]) + rng.integers(
            -40, 40, (n, 32, 32, 3)), 0, 255).astype(np.uint8)
        np.save(cache / f"data_{base}_rois_size32_hsvcut_v3.npy", tiles)
        np.save(cache / f"coor_{base}_rois_size32_hsvcut_v3.npy",
                np.stack([[k * 32, (k % 7) * 32] for k in range(n)]))
    with open(root / "clusters.csv", "w") as f:
        f.write("".join(",".join(r) + "\n" for r in rows))
    jp = jax.jit(jamil.init_attention_mil, static_argnums=1)(
        jax.random.PRNGKey(21), jamil.MILConfig(widths=(8, 8, 8, 8),
                                                blocks=(1, 1, 1, 1)))
    ckpt = jckpt.save(str(root / "train_step-001.model"), jp)
    argv = ["--tag", "IF", "--arch", "tiny", "--resolution", "16",
            "--roi_size", "32", "--f32", "--interface", "--ckpt", ckpt,
            "--data_root", str(root), "--image_dir", "slides",
            "--label_sheet", str(root / "clusters.csv"),
            "--output_root", str(root)]
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("CACHE_DIR", str(cache))
        for name, extra in (("jax_f32", ()), ("jax_int8", INT8)):
            assert jclassify.main(argv + ["--n_vis", "0", *extra]) == 0
            os.rename(root / "interface_data", root / name)
        yield root, argv


def _run_port(cohort, *extra):
    root, argv = cohort
    shutil.rmtree(root / "interface_data", ignore_errors=True)
    assert classify.main(argv + list(extra), device="cpu") == 0
    return root / "interface_data"


def _table(path):
    with open(path) as f:
        lines = f.read().splitlines()
    keys = [ln.split(",")[0] for ln in lines[1:]]
    vals = np.array([[float(v) for v in ln.split(",")[1:]]
                     for ln in lines[1:]])
    return lines[0], keys, vals


def _assert_same_output(port, ref, tol):
    for name in TEXT_FILES:
        assert (port / name).read_text() == (ref / name).read_text(), name
    for name in TABLES:
        head_p, keys_p, vals_p = _table(port / name)
        head_r, keys_r, vals_r = _table(ref / name)
        assert head_p == head_r == ",0,1,2,3" and keys_p == keys_r, name
        assert len(keys_p) == 6
        np.testing.assert_allclose(vals_p, vals_r, rtol=0, atol=tol,
                                   err_msg=name)
    dlas = sorted(f for f in os.listdir(ref) if f.endswith(".dla"))
    assert dlas == sorted(f for f in os.listdir(port) if f.endswith(".dla"))
    assert len(dlas) == 6 * 4  # ATTN + ACTF1..3 per slide
    for f in dlas:
        a, b = np.loadtxt(ref / f), np.loadtxt(port / f)
        np.testing.assert_array_equal(b[:, :2], a[:, :2])
        np.testing.assert_allclose(b[:, 2], a[:, 2], rtol=0, atol=tol,
                                   err_msg=f)


def test_interface_bag_path_matches_jax(cohort):
    port = _run_port(cohort)
    _assert_same_output(port, cohort[0] / "jax_f32", 1e-5)


def test_interface_streamed_path_matches_jax(cohort):
    """Every slide above ``--stream_tiles 1``: streamed, and the same
    output as JAX's one-bag path."""
    port = _run_port(cohort, "--stream_tiles", "1")
    _assert_same_output(port, cohort[0] / "jax_f32", 1e-5)


def test_interface_int8_matches_jax_int8(cohort):
    port = _run_port(cohort, *INT8)
    _assert_same_output(port, cohort[0] / "jax_int8", 1e-4)
    # and it is the quantized path: its probabilities move off float32's
    _, _, q = _table(port / TABLES[0])
    _, _, f = _table(cohort[0] / "jax_f32" / TABLES[0])
    assert np.abs(q - f).max() > 0


def test_int8_is_serving_only(cohort):
    """``--int8`` without ``--interface`` or ``--test_only`` exits 2; with
    ``--test_only`` it validates through the quantized path."""
    root, argv = cohort
    train = [a for a in argv if a != "--interface"]
    assert classify.main(train + ["--tag", "I8T", *INT8],
                         device="cpu") == 2
    assert classify.main(train + ["--tag", "I8V", "--test_only",
                                  "--epoch_start", "200", *INT8],
                         device="cpu") == 0
    assert (root / "run_I8V" / "0200summary.json").is_file()


def test_write_frame_csv_is_pandas_layout(tmp_path):
    rng = np.random.default_rng(0)
    rows = {f"slide{i}" if i != 2 else "GHP_2,B": np.append(
        rng.random(3).astype(np.float32),
        [1e-5 * rng.random(), 1e17, np.nan, -0.0, 3.0][i % 5])
        for i in range(7)}
    pd.DataFrame.from_dict(rows, orient="index").to_csv(tmp_path / "a.csv")
    helpers.write_frame_csv(str(tmp_path / "b.csv"), rows)
    assert (tmp_path / "b.csv").read_text() == \
        (tmp_path / "a.csv").read_text()


def test_classification_report_text_is_sklearn():
    rng = np.random.default_rng(1)
    names = ["A", "B", "C"]
    for _ in range(4):
        y, p = rng.integers(0, 3, 9), rng.integers(0, 3, 9)
        want = classification_report(y, p, labels=[0, 1, 2],
                                     target_names=names, zero_division=0)
        got = helpers.classification_report_text(
            helpers.classification_report(y, p, labels=[0, 1, 2],
                                          target_names=names), names)
        assert got == want
