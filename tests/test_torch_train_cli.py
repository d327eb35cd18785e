"""The port's trainer CLI (``train.classify.main``) on a synthetic cohort,
on the CPU: the JAX CLI's artifacts and summary schema, ``--test_only``
and ``--transfer`` from its checkpoint, bit-exact resume (``--ckpt auto``
replays the uninterrupted run's next epoch), the non-finite-loss halt,
and the figure flags (``--peak``, ``--n_vis`` above 0, also under
``--mesh``) refusing to start where matplotlib is missing."""

import argparse
import csv
import json
import os

import numpy as np
import pytest

import conftest  # noqa: F401
import jax

from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu.models import (
    attention_mil as jamil,
)
from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu.train import (
    checkpoint as jckpt,
)
from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch import (
    train as train_pkg,
)
from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.train import (
    checkpoint,
    classify,
)

# every key the JAX trainer's single-device epoch writes to
# <epoch>summary.json when it validates (train/classify.py), with the keys
# its CLI test checks among them
SUMMARY_KEYS = {
    "coef_a1", "coef_a2", "coef_a3", "input_stall_fraction", "train_acc",
    "train_loss", "train_wsum", "train_wvar", "train_cll2", "train_kld",
    "train_err", "train_secs", "train_sum", "model_temp",
    "model_mean_weights", "model_max_weights", "valid_acc", "valid_loss",
    "valid_err", "valid_wsum", "valid_kld", "valid_streamed_bags",
    "valid_eval_mode", "epoch", "args"}
CLASS_ROWS = {"A", "B", "C", "accuracy", "macro avg", "weighted avg"}


@pytest.fixture
def tree(tmp_path, monkeypatch):
    """Six cached slides named in the GHP_<n>_<x>_H&E.scn convention and a
    csv cluster sheet (the JAX CLI tests' fixture)."""
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


def _run(tree, tag, *extra):
    return classify.main([
        "--tag", tag, "--arch", "tiny", "--resolution", "16",
        "--roi_size", "32", "--accum", "2", "--f32",
        "--data_root", str(tree), "--image_dir", "slides",
        "--label_sheet", str(tree / "clusters.csv"),
        "--output_root", str(tree / "runs"), *extra], device="cpu")


def test_cli_trains_validates_and_writes_the_jax_artifacts(tree):
    assert _run(tree, "SMOKE", "--epoch_start", "0", "--epoch_end", "0") == 0
    run = tree / "runs" / "run_SMOKE"
    files = os.listdir(run)
    assert "model_structure.txt" in files and "train_step-000.model" in files
    assert "0000predictions.json" in files
    assert any(f.startswith("training_validation_testing_data") for f in files)
    with open(run / "0000summary.json") as f:
        stats = json.load(f)
    assert set(stats) == SUMMARY_KEYS
    assert set(stats["train_acc"]) == set(stats["valid_acc"]) == CLASS_ROWS
    assert np.isfinite(stats["train_loss"]) and np.isfinite(stats["valid_loss"])
    assert stats["valid_eval_mode"] is False  # epoch 0 is before Check
    # the weight summaries carry the JAX package's parameter paths
    jp = jax.jit(jamil.init_attention_mil, static_argnums=1)(
        jax.random.PRNGKey(0), classify.make_config(
            argparse.Namespace(arch="tiny")))
    assert set(stats["model_max_weights"]) == set(jckpt._flatten(jp))
    # the checkpoint holds the Adam state in optax's layout, one step
    # taken on each of the epoch's windows (5 training bags, --accum 2)
    blob = checkpoint.load_raw(str(run / "train_step-000.model"))
    assert int(blob["optimizer/count"]) == 3
    assert {k for k in blob if k.startswith("optimizer/mu/")} == \
        {"optimizer/mu/" + k for k in jckpt._flatten(jp)}

    ckpt = str(run / "train_step-000.model")
    for tag, extra in (("TEST", ()), ("XFER", ("--transfer",))):
        assert _run(tree, tag, "--test_only", "--ckpt", ckpt, *extra) == 0
        with open(tree / "runs" / f"run_{tag}" / "0000summary.json") as f:
            assert {"valid_acc", "valid_loss", "args"} <= set(json.load(f))
    assert _run(tree, "GONE", "--ckpt", str(tree / "none.model")) == 2


def test_cli_resume_replays_the_next_epoch_bit_exactly(tree):
    """Epochs 0-1 straight vs epoch 0, then --ckpt auto from its
    checkpoint for epoch 1 in a fresh driver: the same epoch-1 checkpoint,
    bit for bit (parameters and Adam state)."""
    assert _run(tree, "STRAIGHT", "--epoch_start", "0",
                "--epoch_end", "1") == 0
    assert _run(tree, "SPLIT", "--epoch_start", "0", "--epoch_end", "0") == 0
    assert _run(tree, "SPLIT", "--ckpt", "auto", "--epoch_start", "1",
                "--epoch_end", "1") == 0
    a = checkpoint.load_raw(str(tree / "runs" / "run_STRAIGHT"
                                / "train_step-001.model"))
    b = checkpoint.load_raw(str(tree / "runs" / "run_SPLIT"
                                / "train_step-001.model"))
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_cli_halts_on_a_non_finite_loss(tree, monkeypatch):
    real = classify.steps.make_bag_grad

    def poisoned(cfg, compute_dtype=None):
        fn = real(cfg, compute_dtype=compute_dtype)

        def grad_fn(*args, **kw):
            outs = fn(*args, **kw)
            return {**outs, "loss": outs["loss"] * float("nan")}

        return grad_fn

    monkeypatch.setattr(classify.steps, "make_bag_grad", poisoned)
    rc = _run(tree, "NAN", "--epoch_start", "0", "--epoch_end", "3")
    assert rc == train_pkg.DIVERGED_EXIT
    run = tree / "runs" / "run_NAN"
    assert not [f for f in os.listdir(run) if f.startswith("train_step-")]


@pytest.mark.parametrize("argv", [["--peak"], ["--n_vis", "2"],
                                  ["--mesh", "2", "--peak"]])
def test_cli_refuses_flags_not_ported(tree, argv, monkeypatch):
    # every flag is ported; the figure flags need matplotlib, which the
    # card's machine lacks, and without it refuse before any rank starts
    # (they run in tests/test_torch_figures.py)
    monkeypatch.setattr(classify.helpers, "pyplot", lambda: None)
    with pytest.raises(SystemExit, match="matplotlib"):
        _run(tree, "NO", *argv)
    assert not (tree / "runs" / "run_NO").exists()
