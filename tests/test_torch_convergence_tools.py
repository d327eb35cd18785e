"""The port's convergence tools on the CPU: ``tools/torch_convergence_run``
and ``tools/torch_gan_convergence_run`` in their ``--tiny`` smoke modes
end to end (the port's trainers on the JAX tools' synthetic data), their
reports carrying the JAX tools' keys; and the classifier tool's criteria,
on summaries written by a stand-in trainer."""

import json
import math
import os

import numpy as np
import pytest

from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.train import (
    classify,
)
from tools import torch_convergence_run as conv
from tools import torch_gan_convergence_run as gconv

# the keys of the JAX tools' report lines (tools/convergence_run.py; of
# tools/gan_convergence_run.py those of a run without a transition, whose
# pre-transition keys are absent)
CLASSIFIER_KEYS = {
    "epochs", "slides", "arch", "resolution", "first_train_loss",
    "last_train_loss", "last_train_err", "heldout_accuracy",
    "secs_per_train_epoch_median", "total_wall_secs", "run_dir"}
GAN_KEYS = {
    "converged", "res", "max_res", "res_transitions", "step_every",
    "grad_accum", "ema_decay", "ema_warmup", "width_mult", "epochs", "samples",
    "band_dist_init", "band_dist_generator", "band_dist_g_running",
    "band_contrast_real", "band_contrast_init", "band_contrast_generator",
    "train_wall_secs", "ckpt"}


def test_classifier_tool_tiny_runs_the_port_trainer(tmp_path, monkeypatch):
    monkeypatch.setenv("CACHE_DIR", str(tmp_path / "unused"))
    report = conv.run(["--tiny", "--device", "cpu", "--epochs", "5",
                       "--out", str(tmp_path)])
    assert set(report) == CLASSIFIER_KEYS
    assert report["arch"] == "tiny" and report["resolution"] == 32
    for k in ("first_train_loss", "last_train_loss"):
        assert math.isfinite(report[k]) and report[k] > 0
    assert 0.0 <= report["heldout_accuracy"] <= 1.0
    run_dir = tmp_path / "run_CONV"
    assert (run_dir / "0005summary.json").is_file()
    assert (run_dir / "train_step-005.model").is_file()


def _fake_trainer(valid_accuracy, last_loss):
    """A stand-in for ``classify.main`` that writes the summaries of
    epochs 0 and 5 and nothing else."""

    def main(argv, device=None):
        out = argv[argv.index("--output_root") + 1]
        run = os.path.join(out, "run_CONV")
        os.makedirs(run, exist_ok=True)
        for epoch, loss, acc in ((0, 1.1, 0.3), (5, last_loss,
                                                 valid_accuracy)):
            with open(os.path.join(run, f"{epoch:04d}summary.json"),
                      "w") as f:
                json.dump({"train_loss": loss, "train_err": 0.5,
                           "train_secs": 2.0,
                           "valid_acc": {"accuracy": acc}}, f)
        return 0

    return main


@pytest.mark.parametrize("accuracy,last_loss,missed", [
    (1.0, 0.8, None), (0.9, 0.8, "held-out accuracy"),
    (1.0, 1.2, "1.2")])
def test_classifier_tool_criteria(tmp_path, monkeypatch, accuracy,
                                  last_loss, missed):
    monkeypatch.setattr(classify, "main", _fake_trainer(accuracy, last_loss))
    monkeypatch.setenv("CACHE_DIR", str(tmp_path / "unused"))
    argv = ["--epochs", "5", "--slides", "3", "--tiles", "4",
            "--resolution", "8", "--device", "cpu", "--out", str(tmp_path)]
    if missed is None:
        report = conv.run(argv)
        assert report["heldout_accuracy"] == 1.0
        assert report["last_train_loss"] < report["first_train_loss"]
    else:
        with pytest.raises(AssertionError, match=missed):
            conv.run(argv)


def test_gan_tool_tiny_runs_the_port_trainer(tmp_path, capsys):
    argv = ["--tiny", "--device", "cpu", "--epochs", "2", "--n_images",
            "64", "--batch", "16", "--keep", str(tmp_path)]
    record = gconv.run(argv)
    assert set(record) == GAN_KEYS | {"compute_dtype", "seed", "ckpt_every",
                                      "card", "power_limit"}
    assert record["width_mult"] == 1 / 16 and record["samples"] == 128
    assert record["seed"] == 1  # the JAX tool's training seed
    for k in ("band_dist_init", "band_dist_generator",
              "band_dist_g_running"):
        assert math.isfinite(record[k]) and record[k] >= 0
    assert record["converged"] == (
        record["band_dist_generator"] < 0.15
        and record["band_dist_generator"] < 0.5 * record["band_dist_init"])
    assert os.path.isfile(record["ckpt"])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == record
    real = np.stack([np.zeros((8, 8, 3))] * 2)
    assert gconv.band_stats(real).shape == (6,)
