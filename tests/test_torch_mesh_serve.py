"""The CLIs with ``--mesh 2`` on 2 gloo ranks on the CPU against the same
CLI on one rank: the trainer (``train.classify.main``) on a synthetic
cohort, and the daemon (``train.serve.main``) on a manifest.

Trainer: epoch 0 (windows of 2, 2 and 1 bags: the last padded with a
zero-weight copy), then validation, whose bag streams over the ranks
(``--stream_tiles 10``). Its checkpoint (parameters and Adam state) and
summary equal the single-rank run's to 1e-5, and rank 0 alone wrote the
run's files. Daemon: small slides in ``--batch`` groups, a 40-tile slide
streamed and a tile-less one through the one-pass forward, then
``--int8`` with ``--prewarm``: every row and ``.dla`` map equals the
single-rank daemon's to 1e-5 (the rows carry 6 decimals)."""

import csv
import json
import os
import re

import numpy as np
import pytest

import conftest  # noqa: F401

from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.train import (
    checkpoint,
    classify,
    serve,
)


@pytest.fixture
def cohort(tmp_path, monkeypatch):
    """Six cached slides named in the GHP_<n>_<x>_H&E.scn convention and a
    csv cluster sheet (tests/test_torch_train_cli.py's fixture)."""
    cache = tmp_path / "cache"
    cache.mkdir()
    monkeypatch.setenv("CACHE_DIR", str(cache))
    (tmp_path / "slides").mkdir()
    rng = np.random.default_rng(7)
    rows = [["id", ""], ["hdr", "Actual Cluster Designation"]]
    for i, c, cl in [(1, "A", "A"), (2, "B", "B"), (3, "C", "C"),
                     (5, "E", "A"), (6, "F", "B"), (7, "G", "C")]:
        base = f"GHP_{i}_{c}_H&E"
        rows.append([f"GHP_{i}_{c}", cl])
        (tmp_path / "slides" / f"{base}.scn").write_bytes(b"fake")
        tiles = np.clip(np.array([140, 60, 170])
                        + rng.integers(-40, 40, (24, 32, 32, 3)), 0,
                        255).astype(np.uint8)
        np.save(cache / f"data_{base}_rois_size32_hsvcut_v3.npy", tiles)
        np.save(cache / f"coor_{base}_rois_size32_hsvcut_v3.npy",
                np.stack([[k * 32, 0] for k in range(24)]))
    with open(tmp_path / "clusters.csv", "w", newline="") as f:
        csv.writer(f).writerows(rows)
    return tmp_path


def _train(tree, tag, *extra):
    return classify.main([
        "--tag", tag, "--arch", "tiny", "--resolution", "16",
        "--roi_size", "32", "--accum", "2", "--f32", "--stream_tiles", "10",
        "--epoch_start", "0", "--epoch_end", "0",
        "--data_root", str(tree), "--image_dir", "slides",
        "--label_sheet", str(tree / "clusters.csv"),
        "--output_root", str(tree / "runs"), *extra], device="cpu")


def test_classify_mesh_matches_one_rank(cohort):
    assert _train(cohort, "ONE") == 0
    assert _train(cohort, "MESH", "--mesh", "2") == 0
    one, mesh = (cohort / "runs" / f"run_{t}" for t in ("ONE", "MESH"))
    a = checkpoint.load_raw(str(one / "train_step-000.model"))
    b = checkpoint.load_raw(str(mesh / "train_step-000.model"))
    assert sorted(a) == sorted(b)
    assert int(b["optimizer/count"]) == 3  # one Adam step a window
    for k in a:
        tol = 1e-5 * max(1.0, float(np.abs(a[k]).max()))
        np.testing.assert_allclose(b[k], a[k], atol=tol, err_msg=k)
    with open(one / "0000summary.json") as f:
        sa = json.load(f)
    with open(mesh / "0000summary.json") as f:
        sb = json.load(f)
    for key in ("train_loss", "train_err", "train_wsum", "train_wvar",
                "train_kld", "train_cll2", "valid_loss", "valid_err",
                "valid_wsum", "valid_kld"):
        np.testing.assert_allclose(sb[key], sa[key], atol=1e-5, err_msg=key)
    assert sb["valid_streamed_bags"] == sa["valid_streamed_bags"] == 1
    assert sb["train_acc"] == sa["train_acc"]
    # rank 0 alone wrote the run: the same files (one split file, whose
    # name carries the time of day; the metric curves, drawn where
    # matplotlib is installed, carry the run's tag)

    def names(run):
        return sorted("split" if f.startswith("training_validation")
                      else re.sub(r"_tag\w+\.pdf$", "_tag.pdf", f)
                      for f in os.listdir(run))

    assert names(mesh) == names(one)


@pytest.fixture
def manifest(tmp_path, monkeypatch):
    """Cached roi-32 slides (four of 24 tiles, one of 40, one tile-less)
    in a manifest (tests/test_torch_serve.py's slides)."""
    cache = tmp_path / "cache"
    cache.mkdir()
    monkeypatch.setenv("CACHE_DIR", str(cache))
    slides = tmp_path / "slides"
    slides.mkdir()
    rng = np.random.default_rng(3)
    paths = []
    for name, ntiles in [("GHP_1_A", 24), ("GHP_2_A", 24), ("GHP_3_A", 24),
                         ("GHP_4_A", 24), ("GHP_9_B", 40), ("GHP_0_Z", 0)]:
        path = slides / f"{name}_H&E.scn"
        path.write_bytes(b"fake")
        tiles = np.clip(np.array([140, 60, 170], np.int16)
                        + rng.integers(-40, 40, (ntiles, 32, 32, 3)),
                        0, 255).astype(np.uint8)
        coords = np.array([[i * 32, (i % 5) * 32] for i in range(ntiles)],
                          np.int64).reshape(ntiles, 2)
        np.save(cache / f"data_{name}_H&E_rois_size32_hsvcut_v3.npy", tiles)
        np.save(cache / f"coor_{name}_H&E_rois_size32_hsvcut_v3.npy", coords)
        paths.append(str(path))
    m = tmp_path / "slides.txt"
    m.write_text("\n".join(paths) + "\n")
    return tmp_path, m


def _table(path):
    with open(path) as f:
        rows = [ln.split() for ln in f.read().splitlines() if ln]
    return np.asarray(rows, np.float64).reshape(len(rows), 3)


@pytest.mark.parametrize("flags", [["--batch", "2", "--batch_tile_cap", "30"],
                                   ["--int8", "--prewarm", "20"]])
def test_serve_mesh_matches_one_rank(manifest, flags):
    tree, m = manifest
    common = ["--manifest", str(m), "--arch", "tiny", "--resolution", "16",
              "--roi_size", "32", "--f32", "--once", "--settle_secs", "0",
              "--chunk", "16", *flags]
    outs = {}
    for tag, extra in (("one", []), ("mesh", ["--mesh", "2"])):
        outs[tag] = str(tree / tag)
        assert serve.main(common + ["--out_root", outs[tag]] + extra,
                          device="cpu") == 0
    rows = {}
    for tag, out in outs.items():
        with open(os.path.join(out, "results.csv")) as f:
            rows[tag] = {ln.split(",")[0]: ln.split(",")
                         for ln in f.read().splitlines()[1:] if ln}
    assert sorted(rows["mesh"]) == sorted(rows["one"]) and len(rows["one"]) == 6
    for name, want in rows["one"].items():
        got = rows["mesh"][name]
        np.testing.assert_allclose([float(x) for x in got[1:4]],
                                   [float(x) for x in want[1:4]], atol=1e-5,
                                   err_msg=name)
        assert got[4] == want[4] and got[6] == want[6]
        np.testing.assert_allclose(float(got[5]), float(want[5]), atol=1e-5)
    dlas = sorted(f for f in os.listdir(outs["one"]) if f.endswith(".dla"))
    assert dlas == sorted(f for f in os.listdir(outs["mesh"])
                          if f.endswith(".dla"))
    for f in dlas:
        a, b = (_table(os.path.join(outs[t], f)) for t in ("one", "mesh"))
        assert a.shape == b.shape, f  # (0, 3) for the tile-less slide
        np.testing.assert_allclose(b, a, atol=1e-5, err_msg=f)
    with open(os.path.join(outs["mesh"], "processed.txt")) as f:
        assert len(f.read().split()) == 6


@pytest.mark.parametrize("where,flags,rc,missing", [
    ("read", ["--batch", "2", "--batch_tile_cap", "30"], 1, 1),
    ("calibrate", ["--int8"], 1, 1),
    ("group", ["--batch", "2", "--batch_tile_cap", "30"], 0, 0)])
def test_serve_mesh_survives_a_fault_on_one_rank(manifest, where, flags, rc,
                                                 missing):
    """A slide that fails on one rank fails on every rank, and the daemon
    goes on with the next: an unreadable cache on rank 1 (the streamed
    40-tile slide), a failed int8 calibration on rank 0 (the first slide
    with tiles; the next one calibrates), an extractor error on rank 1 in
    a ``--batch`` group (its members are retried one by one and served).
    The collectives stay in step: the run ends well inside the ranks'
    timeout."""
    import torch_mesh_workers as W

    from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.parallel import (
        mesh as TM,
    )

    tree, m = manifest
    out = tree / "out"
    argv = ["--manifest", str(m), "--arch", "tiny", "--resolution", "16",
            "--roi_size", "32", "--f32", "--once", "--settle_secs", "0",
            "--chunk", "16", "--out_root", str(out), "--mesh", "2", *flags]
    got = TM.launch(W.serve_failing, 2, args=(argv, where),
                    devices=["cpu"] * 2, timeout_s=120)
    assert got == [rc, 0]
    with open(out / "results.csv") as f:
        rows = [ln.split(",")[0] for ln in f.read().splitlines()[1:] if ln]
    with open(out / "processed.txt") as f:
        processed = f.read().split()
    assert len(rows) == len(set(rows)) == 6 - missing
    assert sorted(processed) == sorted(rows)
    if where == "read":
        assert "GHP_9_B_H&E" not in rows
