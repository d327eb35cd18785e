"""The port's figures (``utils/helpers.py``, ``utils/plots.py``,
``train/heatmap.py``, ``classify --peak`` / ``--n_vis``) against the JAX
package's on the CPU.

Held: the data behind each figure equals JAX's: the activation stats and
grids of the ResNet-26's taps to 1e-6 x max(1, |value|) (float32
convolutions summed in another order), the heatmap panel's arrays (the
tissue mosaic and the overlays exactly, the feature strips and the angle
to 1e-6), ``RandomCrop2X``'s crops exactly, the ROC curve and AUC to
scikit-learn's; each drawing call writes its file; ``--peak`` and
``--n_vis`` run through ``classify.main`` and write theirs; and where
matplotlib is missing they, and ``utils.plots.main``, exit naming it."""

import csv
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import conftest  # noqa: F401
from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu.models import (
    attention_mil as jamil,
)
from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu.train import (
    heatmap as jheatmap,
)
from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu.utils import (
    helpers as jhelpers,
)
from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.models import (
    attention_mil as amil,
)
from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.train import (
    classify,
    heatmap,
)
from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.utils import (
    helpers,
    interop,
    plots,
)

TINY = dict(widths=(8, 8, 8, 8), blocks=(1, 1, 1, 1))


@pytest.fixture(scope="module")
def models():
    cfg = jamil.MILConfig(**TINY)
    jp = jax.tree_util.tree_map(np.asarray, jax.jit(
        jamil.init_attention_mil, static_argnums=1)(jax.random.PRNGKey(2),
                                                    cfg))
    model = interop.load_jax_params(
        amil.AttentionMIL(amil.MILConfig(**TINY), device="cpu"), jp)
    return jp, model


@pytest.fixture(scope="module")
def tiles():
    return np.random.default_rng(0).uniform(-1, 1, (4, 32, 32, 3)).astype(
        np.float32)


def close(got, want, tol=1e-6):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.all(np.abs(got - want) <= tol * np.maximum(1.0, np.abs(want)))


def test_activation_summary_and_grids_match_jax(models, tiles):
    jp, model = models
    want = jhelpers.activation_summary(jp["cnn"], jnp.asarray(tiles))
    got = helpers.activation_summary(model.cnn, torch.from_numpy(tiles))
    assert list(got) == list(want)
    for layer, stats in want.items():
        assert got[layer]["shape"] == stats["shape"]
        assert got[layer]["frac_nonzero"] == stats["frac_nonzero"]
        for k in ("mean", "std", "min", "max"):
            close(got[layer][k], stats[k])
    want = jhelpers.activation_grids(jp["cnn"], jnp.asarray(tiles))
    got = helpers.activation_grids(model.cnn, torch.from_numpy(tiles))
    assert list(got) == list(want)
    for layer in want:
        close(got[layer], want[layer])


class _Recorder:
    """A stand-in for pyplot that records every array shown and every
    title, and draws nothing."""

    def __init__(self):
        self.shown, self.titles = [], []
        rec = self

        class Ax:
            class title:
                @staticmethod
                def set_text(t):
                    rec.titles.append(t)

            def imshow(self, a, **kw):
                rec.shown.append(np.asarray(a))

            def __getattr__(self, name):
                return _noop(name)

        class Fig:
            def __getattr__(self, name):
                return _noop(name)

        self._axes = np.empty((2, 3), dtype=object)
        for i in range(2):
            for j in range(3):
                self._axes[i, j] = Ax()
        self._fig = Fig()
        self.cm = __import__("matplotlib").cm

    def subplots(self, *a, **kw):
        return self._fig, self._axes

    def __getattr__(self, name):
        return _noop(name)


def _noop(name):
    if name.startswith("__"):
        raise AttributeError(name)
    return lambda *a, **kw: None


def test_heatmap_panel_data_matches_jax(monkeypatch):
    rng = np.random.default_rng(3)
    T, s = 9, 64
    raster = np.array([[r * s, c * s] for r in range(3) for c in range(3)])
    img = rng.integers(0, 255, (T, 40, 40, 3)).astype(np.uint8)
    A = rng.random((3, T))
    F = rng.standard_normal((T, 80)).astype(np.float32)
    M = rng.standard_normal((3, 1)).astype(np.float32)
    assert heatmap.embedding_angle(M) == jheatmap.embedding_angle(M)

    want = _Recorder()
    monkeypatch.setattr(jheatmap, "plt", want)
    jheatmap.create_map("x", 3, "Last", img, raster, A, F, M, roi_size=s)
    got = _Recorder()
    monkeypatch.setattr(heatmap, "require_pyplot", lambda what: got)
    heatmap.create_map("x", 3, "Last", img, raster, A, F, M, roi_size=s)
    assert got.titles == want.titles
    assert len(got.shown) == len(want.shown) == 7
    for i, (a, b) in enumerate(zip(got.shown, want.shown)):
        if i == 1 or i == 6:  # the feature strips, the embedding
            close(a, b)
        else:  # the mosaic and the four overlays
            np.testing.assert_array_equal(a, b)


def test_attention_overlay_matches_jax():
    rng = np.random.default_rng(4)
    cmap = __import__("matplotlib").cm.jet(np.linspace(0, 1, 105))
    w = rng.random(6) * 120
    rows, cols = np.array([0, 32, 64, 0, 32, 64]), np.array([0, 0, 0, 32,
                                                             32, 32])
    np.testing.assert_array_equal(
        heatmap.attention_overlay(w, rows, cols, 32, 3, 2, 0.9, cmap),
        jheatmap.attention_overlay(w, rows, cols, 32, 3, 2, 0.9, cmap))


def test_random_crop_2x_matches_jax():
    rng = np.random.default_rng(5)
    a, b = rng.random((20, 18, 3)), rng.random((20, 18, 1))
    ours, theirs = helpers.RandomCrop2X(24, seed=7), \
        jhelpers.RandomCrop2X(24, seed=7)
    small = helpers.RandomCrop2X(8, seed=3), jhelpers.RandomCrop2X(8, seed=3)
    for _ in range(3):
        for (x, y) in ((ours, theirs), small):
            ca, cb, off = x.Execute(a, b)
            wa, wb, woff = y.Execute(a, b)
            assert off == woff
            np.testing.assert_array_equal(ca, wa)
            np.testing.assert_array_equal(cb, wb)


def test_roc_curve_and_auc_match_scikit_learn():
    from sklearn import metrics

    rng = np.random.default_rng(6)
    for n in (2, 7, 40):
        labels = rng.integers(0, 2, n).astype(float)
        labels[:2] = [0, 1]
        scores = np.round(rng.random(n), 1)  # ties included
        fpr, tpr, thr = plots.roc_curve(labels, scores)
        wf, wt, wthr = metrics.roc_curve(labels, scores)
        np.testing.assert_allclose(fpr, wf)
        np.testing.assert_allclose(tpr, wt)
        np.testing.assert_array_equal(thr[1:], wthr[1:])
        assert plots.auc(fpr, tpr) == pytest.approx(metrics.auc(wf, wt))


def _summaries(run):
    for epoch in range(3):
        stats = {"train_loss": 1.0 / (epoch + 1), "valid_loss": 0.5,
                 "train_wsum": 0.1, "valid_wsum": 0.2,
                 "coef_a1": 0.5, "coef_a2": 0.6, "coef_a3": 0.7,
                 "train_acc": {"accuracy": 0.5, "A": {"f1-score": 0.3}},
                 "valid_acc": {"accuracy": 0.4},
                 "model_max_weights": {"cnn/conv1/w": 1.0 + epoch,
                                       "cnn/conv1/b": 0.1}}
        helpers.savestats(None, str(run), epoch, stats)
        plots.save_predictions(str(run), epoch, [0.1, 0.8, 0.4, 0.7],
                               [0, 1, 0, 1])


def test_every_drawing_call_writes_its_file(models, tiles, tmp_path):
    _, model = models
    grids = helpers.activation_grids(model.cnn, torch.from_numpy(tiles))
    out = tmp_path
    paths = [helpers.plot_activations(grids["stage1"], str(out / "a.png")),
             helpers.plot_kernels(model, 0, 0, output_dir=str(out)),
             helpers.plot_attn_flow(np.random.rand(3, 20),
                                    str(out / "attn.png")),
             helpers.plot_bag_flow([3, 4, 5], [1.0, 0.5, 0.2],
                                   str(out / "bag.png"))]
    summary = helpers.plot_layer_summary(model, str(out / "layers.png"))
    assert set(summary) == {k for k, _ in helpers.named_parameters(model)}
    paths.append(str(out / "layers.png"))
    model.weight_mask.grad = torch.ones_like(model.weight_mask)
    means = helpers.plot_grad_flow(model, str(out / "grads.png"))
    assert max(means) == 1.0
    paths.append(str(out / "grads.png"))
    assert os.path.basename(paths[1]) == "kernels-cnn.conv1.w-ep000.png"
    _summaries(out)
    paths += plots.plot_gbm_metrics(str(out), "T")
    paths.append(plots.plot_prediction_summary(
        2, str(out), np.random.rand(4, 3), [0, 1, 2, 0]))
    roc_paths, aucs = plots.plot_roc(str(out), "T")
    assert len(aucs) == 3 and aucs[0] == 1.0
    paths += roc_paths
    paths.append(plots.plot_layer_metrics(str(out), "T"))
    assert plots.layer_metric_series(plots._load_summaries(str(out))) == {
        "cnn/conv1/w": [1.0, 2.0, 3.0]}
    paths.append(heatmap.create_map(
        "s", 0, "Last", np.zeros((2, 8, 8, 3), np.uint8),
        np.array([[0, 0], [0, 32]]), np.random.rand(3, 2),
        np.random.rand(2, 80), np.random.rand(3, 1), roi_size=32,
        output_dir=str(out)))
    for p in paths:
        assert p and os.path.getsize(p) > 0, p
    assert plots.main([str(out), "--tag", "M"]) == 0
    assert (out / "gbm_progress_tagM.pdf").exists()


def test_without_matplotlib_the_figures_refuse(monkeypatch, tmp_path, tree):
    monkeypatch.setattr(helpers, "pyplot", lambda: None)
    with pytest.raises(RuntimeError, match="matplotlib"):
        helpers.plot_attn_flow(np.zeros((3, 4)))
    with pytest.raises(SystemExit, match="matplotlib"):
        plots.main([str(tmp_path)])
    for argv in (["--peak"], ["--n_vis", "1"]):
        with pytest.raises(SystemExit, match="matplotlib"):
            _run(tree, "NOPLT", *argv)
        assert not (tree / "runs" / "run_NOPLT").exists()
    # training still writes the data the curves are drawn from
    assert _run(tree, "DATA", "--epoch_start", "0", "--epoch_end", "0") == 0
    run = tree / "runs" / "run_DATA"
    assert (run / "0000summary.json").exists()
    assert (run / "0000predictions.json").exists()
    assert not (run / "gbm_progress_tagDATA.pdf").exists()


@pytest.fixture
def tree(tmp_path, monkeypatch):
    """Six cached slides and a csv cluster sheet (the CLI tests' fixture)."""
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
                np.stack([[(k // 6) * 32, (k % 6) * 32] for k in range(24)]))
    with open(tmp_path / "clusters.csv", "w", newline="") as f:
        csv.writer(f).writerows(rows)
    return tmp_path


def _run(tree, tag, *extra):
    return classify.main([
        "--tag", tag, "--arch", "tiny", "--resolution", "16",
        "--roi_size", "32", "--accum", "2", "--f32",
        "--data_root", str(tree), "--image_dir", "slides",
        "--label_sheet", str(tree / "clusters.csv"),
        "--output_root", str(tree / "runs"), *extra], device="cpu")


def test_peak_and_n_vis_through_the_trainer(tree, capsys):
    assert _run(tree, "PEAK", "--peak") == 0
    run = tree / "runs" / "run_PEAK"
    names = os.listdir(run)
    assert "kernels-cnn.conv1.w-ep000.png" in names
    assert {f"activations-{n}.png" for n in
            ("stem", "stage1", "stage2", "stage3", "stage4")} <= set(names)
    assert "train_step-000.model" not in names  # --peak exits
    assert "stage4" in capsys.readouterr().out

    assert _run(tree, "VIS", "--n_vis", "2", "--epoch_start", "0",
                "--epoch_end", "0") == 0
    run = tree / "runs" / "run_VIS"
    heat = sorted(os.listdir(run / "heatmaps"))
    # the first sample before training, both at epoch 0, and the
    # validation's prediction summary
    panels = [h for h in heat if h.endswith("-heatmap.pdf")]
    assert len(panels) == 2 and all(h.startswith("gbm_status-000_sample-")
                                    for h in panels)
    assert "validation_performance-000.pdf" in heat
    assert "gbm_progress_tagVIS.pdf" in os.listdir(run)
    with open(run / "0000summary.json") as f:
        assert "valid_acc" in json.load(f)


def test_visualize_data_runs_the_slide_through_the_pool(tree):
    """Driver.visualize's data: the whole slide through the eval forward
    (one pool launch on the card; its plain version here), equal to a
    direct forward."""
    import argparse

    args = classify.build_argparser().parse_args([
        "--arch", "tiny", "--resolution", "16", "--roi_size", "32", "--f32",
        "--data_root", str(tree), "--image_dir", "slides",
        "--label_sheet", str(tree / "clusters.csv"),
        "--output_root", str(tree / "runs")])
    assert isinstance(args, argparse.Namespace)
    from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.data import (
        dataset as ds_mod,
    )

    out = str(tree / "runs" / "vis")
    os.makedirs(out)
    ds = ds_mod.GHPSingleBagDatasetSimple(
        bag=True, output_dir=out, root_dir=str(tree), image_dir="slides",
        label_sheet=str(tree / "clusters.csv"), roi_size=32, seed=0,
        device="cpu")
    ds.load_new(n_folds=6, n_fold_selection=0)
    driver = classify.Driver(args, classify.make_config(args), out,
                             device="cpu")
    b = ds.test_slide_builders[0]
    b.update_resolution_and_buffer(16)
    d = driver.visualize_data(b)
    tiles = b.get_inference_data()[0]
    want = amil.apply_attention_mil(driver.model, tiles, 1, driver.cfg)
    assert d["A"].shape == (3, 24) and d["F"].shape == (24, driver.cfg.L)
    np.testing.assert_allclose(d["A"], want["wROIs"].numpy(), atol=1e-6)
    np.testing.assert_allclose(d["M"], want["Mterm"].numpy(), atol=1e-6)
    assert os.path.isfile(driver.visualize(0, b, mode="Test"))
