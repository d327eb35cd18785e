"""The port's walkthroughs are load-bearing documentation, as the JAX
package's are (``tests/test_examples.py``): every step of
``examples/torch_full_pipeline_demo.py`` parses with its CLI's own
argparser, ``examples/torch_synthetic_demo.py`` runs end to end on the
CPU, and the full walkthrough (slow) leaves the JAX test's artifacts.
A CLI flag that changes cannot rot either walkthrough silently."""

import csv
import importlib
import os

import pytest

from examples import torch_full_pipeline_demo as full
from examples import torch_synthetic_demo as synth

from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.train import (
    checkpoint,
    classify,
)
from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.models import (
    attention_mil as amil,
)
from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.utils import (
    helpers,
)

STEPS = full.walkthrough("/demo") + synth.walkthrough("/synthetic")


@pytest.mark.parametrize("step", STEPS, ids=[
    f"{s.name}-{s.module}" for s in STEPS])
def test_walkthrough_argv_parses_with_the_cli(step):
    module = importlib.import_module(f"{full.PORT}.{step.module}")
    assert callable(getattr(module, step.entry))
    args = module.build_argparser().parse_args(step.argv)
    assert args is not None
    assert full.command_line(step, "/c").startswith(
        f"CACHE_DIR=/c python -m {full.PORT}.{step.module} ")


def _rows(path):
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


def test_synthetic_demo_runs_on_the_cpu(tmp_path):
    wd = str(tmp_path / "demo")
    runs = synth.run(wd, device="cpu")
    # the trainer's checkpoints restore into the tiny config, no key left
    run = os.path.join(runs, "run_DEMO")
    for epoch in (0, 1):
        assert os.path.exists(os.path.join(
            run, f"train_step-{epoch:03d}.model"))
    cfg = classify.make_config(classify.build_argparser().parse_args(
        ["--arch", "tiny"]))
    model = amil.AttentionMIL(cfg, device="cpu")
    _, loaded, skipped = checkpoint.restore_params(
        model, os.path.join(run, "train_step-000.model"), strict=True)
    assert loaded and not skipped
    # --interface wrote the caMicroscope manifests for the six slides
    iface = os.path.join(runs, "interface_data")
    slides = [f"GHP_{i}_X" for i in range(1, 7)]
    img = _rows(os.path.join(iface, "manifest_img.csv"))
    heat = _rows(os.path.join(iface, "manifest_heat.csv"))
    assert sorted(r["clinicaltrialsubjectid"] for r in img) == slides
    assert sorted(r["clinicaltrialsubjectid"] for r in heat) == slides
    assert all(os.path.exists(r["path"]) for r in heat)


@pytest.mark.slow
def test_full_pipeline_demo_runs_end_to_end(tmp_path):
    wd = str(tmp_path / "demo")
    out = full.run(wd, device="cpu")
    run = os.path.join(wd, "runs", "run_DEMO")
    expected = [  # the JAX test's list, one artifact per subsystem
        os.path.join(wd, "gan_store", "meta.json"),          # 2. store
        os.path.join(wd, "gan_run", "checkpoint",
                     "train_step-1.model"),                  # 3. GAN train
        os.path.join(wd, "gan_run", "sample.png"),           # 4. generate
        os.path.join(wd, "gan_run", "sample_mixing_0.png"),
        os.path.join(run, "train_step-000.model"),           # 6. live driver
        os.path.join(wd, "serve_out", "results.csv"),        # 6b. daemon
        os.path.join(wd, "gradcam_tile.npy"),                # 8. Grad-CAM
    ]
    if helpers.have_matplotlib():
        expected.append(os.path.join(wd, "gradcam_tile.png"))
    missing = [p for p in expected if not os.path.exists(p)]
    assert not missing, f"demo finished but artifacts missing: {missing}"
    assert any(f.startswith("train_step-") for _, _, fs
               in os.walk(os.path.join(wd, "legacy")) for f in fs)
    assert any(f == "manifest_img.csv" for _, _, fs in os.walk(wd)
               for f in fs)
    assert len(_rows(os.path.join(wd, "serve_out", "results.csv"))) == 6
    if helpers.have_matplotlib():  # 7. the plots CLI drew the curves
        assert out["skipped"] == []
        assert any(f.endswith(".pdf") for f in os.listdir(run))
    else:
        assert out["skipped"] == ["7"]
    assert out["gradcam"]["cam"].shape == (32, 32)
