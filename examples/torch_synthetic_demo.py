"""End-to-end demo on synthetic data through the PyTorch port: the twin of
``examples/synthetic_demo.py``. Builds the synthetic slide tree (tile
caches + label sheet, ``synthetic_demo.build_tree``), trains the tiny
model for a few epochs through the port's trainer CLI, runs its
``--interface`` mode from the epoch-0 checkpoint, and lists the
artifacts. Each step is ``train.classify.main`` called in this process,
on the card unless ``--device cpu`` is asked for:

    python examples/torch_synthetic_demo.py [--workdir DIR] [--device cpu]
"""

import argparse
import os
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from examples.synthetic_demo import build_tree  # noqa: E402
from examples.torch_full_pipeline_demo import (  # noqa: E402
    PORT,
    Step,
    call_step,
    cache_dir,
    command_line,
)


def walkthrough(wd: str, epochs: int = 2) -> list:
    """The two trainer runs: ``epochs`` epochs of the tiny model, then
    ``--interface`` from the epoch-0 checkpoint."""
    common = ["--arch", "tiny", "--resolution", "16", "--roi_size", "32",
              "--accum", "2", "--f32",
              "--data_root", wd, "--image_dir", "slides",
              "--label_sheet", os.path.join(wd, "clusters.csv"),
              "--output_root", os.path.join(wd, "runs")]
    ckpt = os.path.join(wd, "runs", "run_DEMO", "train_step-000.model")
    return [Step("train", "train.classify", "main",
                 ["--tag", "DEMO", "--epoch_start", "0",
                  "--epoch_end", str(epochs)] + common),
            Step("interface", "train.classify", "main",
                 ["--interface", "--ckpt", ckpt] + common)]


def run(wd: str, *, epochs: int = 2, device=None) -> str:
    """The demo in ``wd`` on ``device`` (the card unless ``"cpu"``);
    returns the runs directory."""
    from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch._device import (  # noqa: E501
        resolve_device,
    )

    device = resolve_device(device)
    cache, _, _ = build_tree(wd)
    with cache_dir(cache):
        for step in walkthrough(wd, epochs):
            print("\n+ " + command_line(step, cache), flush=True)
            call_step(step, device)
    return os.path.join(wd, "runs")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workdir", default=None,
                    help="default: a new temporary directory")
    ap.add_argument("--epochs", type=int, default=2)
    ap.add_argument("--device", default=None, help="the card unless 'cpu'")
    args = ap.parse_args(argv)
    wd = args.workdir or tempfile.mkdtemp(prefix="torch_demo_")
    runs = run(wd, epochs=args.epochs, device=args.device)
    print(f"\nArtifacts ({PORT}):")
    for root, _, files in os.walk(runs):
        for f in sorted(files)[:50]:
            print("  ", os.path.relpath(os.path.join(root, f), wd))
    return 0


if __name__ == "__main__":
    sys.exit(main())
