"""The complete walkthrough on synthetic data, through the PyTorch port's
CLIs: the twin of ``examples/full_pipeline_demo.py``, the same eight
steps with the same sizes and flags, each the port CLI's ``main`` called
in this process (one CUDA context for the whole walkthrough):

  1. synthetic slide tree (tile caches + cluster label sheet)
  2. resolution-keyed GAN tile store        (data.gan_dataset)
  3. progressive StyleGAN WGAN-GP training  (train.gan)
  4. StyleGAN sampling + style mixing       (train.gan_generate)
  5. legacy GAN-discriminator classifier    (train.classify_legacy)
  6. live attention-MIL driver + interface  (train.classify)
  6b. serving daemon on the int8 W8A8 path  (train.serve, --once)
  7. metric plots from the run artifacts    (utils.plots)
  8. Grad-CAM on a tile from the trained checkpoint (interpret kit)

Runs on the card unless ``--device cpu`` is asked for:

    python examples/torch_full_pipeline_demo.py [--workdir DIR] [--device cpu]

Each step prints the command a user would type. Step 7 and the colour
overlay of step 8 draw with matplotlib, and the overlay's PNG is written
with Pillow: where one is missing, the step prints one line naming it,
and step 8 still saves the map as ``gradcam_tile.npy``. Any other failure
fails the walkthrough.
"""

import argparse
import contextlib
import dataclasses
import importlib
import os
import shlex
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from examples.synthetic_demo import build_tree  # noqa: E402

PORT = "deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch"

# tiny-but-real GAN geometry: width_mult shrinks every channel count;
# resolution 16 = discriminator entry step 2
WM, CODE, RES = "0.125", "32", "16"


@dataclasses.dataclass(frozen=True)
class Step:
    name: str      # the walkthrough's numbering
    module: str    # under the port package
    entry: str     # the function that takes ``argv``
    argv: list
    draws: bool = False  # needs matplotlib


def layout(wd: str) -> dict:
    """The walkthrough's paths under ``wd`` (``build_tree``'s among
    them)."""
    runs = os.path.join(wd, "runs")
    gan_out = os.path.join(wd, "gan_run")
    return {"cache": os.path.join(wd, "cache"),
            "slides": os.path.join(wd, "slides"),
            "sheet": os.path.join(wd, "clusters.csv"),
            "store": os.path.join(wd, "gan_store"), "gan_out": gan_out,
            "gan_ckpt": os.path.join(gan_out, "checkpoint",
                                     "train_step-1.model"),
            "legacy": os.path.join(wd, "legacy"), "runs": runs,
            "run": os.path.join(runs, "run_DEMO"),
            "ckpt": os.path.join(runs, "run_DEMO", "train_step-000.model"),
            "serve_out": os.path.join(wd, "serve_out"),
            "gradcam_png": os.path.join(wd, "gradcam_tile.png"),
            "gradcam_npy": os.path.join(wd, "gradcam_tile.npy")}


def walkthrough(wd: str) -> list:
    """Steps 2 to 7 as one table: each CLI's module, entry and argv."""
    p = layout(wd)
    data_common = ["--data_root", wd, "--image_dir", "slides",
                   "--label_sheet", p["sheet"], "--roi_size", "32", "--f32"]
    live_common = ["--arch", "tiny", "--resolution", RES, "--accum", "2",
                   "--output_root", p["runs"]] + data_common
    return [
        Step("2", "data.gan_dataset", "_main",
             ["--src", p["cache"], "--out", p["store"], "--max-size", RES,
              "--max-items", "64"]),
        Step("3", "train.gan", "main",
             ["--data_dir", p["store"], "--output_dir", p["gan_out"],
              "--epochs", "2", "--step_every", "1", "--init_size", "4",
              "--max_size", "8", "--width_mult", WM, "--code_size", CODE,
              "--batch_override", "4", "--max_batches", "2", "--phase", "8",
              "--mixing", "--seed", "0"]),
        Step("4", "train.gan_generate", "main",
             [p["gan_ckpt"], "--size", "8", "--width_mult", WM,
              "--code_size", CODE, "--n_row", "2", "--n_col", "2",
              "--n_mixing", "2", "--output_dir", p["gan_out"]]),
        Step("5", "train.classify_legacy", "main",
             ["--gan_ckpt", p["gan_ckpt"], "--width_mult", WM,
              "--disc_cutoff", "2", "--resolution", RES,
              "--epoch_start", "0", "--epoch_end", "1", "--accum", "2",
              "--output_root", p["legacy"]] + data_common),
        Step("6", "train.classify", "main",
             ["--tag", "DEMO", "--epoch_start", "0", "--epoch_end", "2"]
             + live_common),
        Step("6i", "train.classify", "main",
             ["--interface", "--ckpt", p["ckpt"]] + live_common),
        Step("6b", "train.serve", "main",
             ["--ckpt", p["ckpt"], "--watch_dir", p["slides"],
              "--out_root", p["serve_out"], "--arch", "tiny",
              "--resolution", RES, "--roi_size", "32", "--f32", "--int8",
              "--once", "--settle_secs", "0", "--chunk", "16"]),
        Step("7", "utils.plots", "main", [p["run"], "--tag", "DEMO"],
             draws=True),
    ]


def command_line(step: Step, cache: str) -> str:
    """The shell command a user types for ``step``."""
    return (f"CACHE_DIR={shlex.quote(cache)} python -m {PORT}.{step.module} "
            + " ".join(shlex.quote(a) for a in step.argv))


@contextlib.contextmanager
def cache_dir(path):
    """``CACHE_DIR`` set to ``path`` (the RoiBuilder's tile caches) for
    the walkthrough, restored after it."""
    old = os.environ.get("CACHE_DIR")
    os.environ["CACHE_DIR"] = path
    try:
        yield
    finally:
        if old is None:
            os.environ.pop("CACHE_DIR", None)
        else:
            os.environ["CACHE_DIR"] = old


def call_step(step: Step, device):
    fn = getattr(importlib.import_module(f"{PORT}.{step.module}"), step.entry)
    rc = fn(step.argv, device=device)
    if rc not in (0, None):
        raise RuntimeError(f"step {step.name} ({step.module}) exited {rc}")


def gradcam_step(wd: str, device) -> dict:
    """Step 8: Grad-CAM at stage 3 on the first cached tile, through the
    extractor of the live driver's checkpoint restored with no key
    skipped. Saves the map as ``gradcam_tile.npy`` and, where matplotlib
    and Pillow are installed, the overlay as ``gradcam_tile.png``."""
    from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.interpret import (  # noqa: E501
        gradcam,
        misc,
    )
    from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.models import (  # noqa: E501
        attention_mil as amil,
    )
    from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.train import (  # noqa: E501
        checkpoint,
        classify,
    )
    from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.utils import (  # noqa: E501
        helpers,
    )

    p = layout(wd)
    # the config the classify CLI trained with: restore_params skips what
    # does not fit, so a drifted copy of the widths would keep random
    # weights
    cfg = classify.make_config(classify.build_argparser().parse_args(
        ["--arch", "tiny"]))
    model = amil.AttentionMIL(cfg, device=device)
    model, _, skipped = checkpoint.restore_params(model, p["ckpt"])
    if skipped:
        raise RuntimeError(f"checkpoint/arch mismatch: {skipped[:3]}...")
    stack = next(f for f in sorted(os.listdir(p["cache"]))
                 if f.startswith("data_"))
    tile_u8 = np.load(os.path.join(p["cache"], stack))[0]
    cam = gradcam.gradcam(model.cnn, misc.preprocess_image(tile_u8), 0,
                          layer="stage3").detach().cpu().numpy()
    np.save(p["gradcam_npy"], cam)
    print(f"Grad-CAM -> {p['gradcam_npy']}  (cam range "
          f"{cam.min():.2f}..{cam.max():.2f})")
    out = {"cam": cam, "png": None}
    if not helpers.have_matplotlib():
        print("step 8: the colour overlay needs matplotlib, which is not "
              "installed; the map is saved as gradcam_tile.npy")
        return out
    _, overlay = misc.apply_colormap_on_image(tile_u8, cam)
    try:
        out["png"] = misc.save_image(overlay, p["gradcam_png"])
    except RuntimeError as e:  # Pillow missing
        print(f"step 8: {e}; the map is saved as gradcam_tile.npy")
    return out


def run(wd: str, *, device=None, step_hook=None) -> dict:
    """The walkthrough in ``wd`` on ``device`` (the card unless ``"cpu"``).
    ``step_hook(step_name)``, where given, returns a context manager
    entered around each step (a caller counting what each step
    launches). Returns the paths of :func:`layout`, the steps skipped for
    a missing package, and the Grad-CAM map."""
    from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch._device import (  # noqa: E501
        resolve_device,
    )
    from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.utils import (  # noqa: E501
        helpers,
    )

    device = resolve_device(device)
    hook = step_hook or (lambda name: contextlib.nullcontext())
    p = layout(wd)
    build_tree(wd)
    os.makedirs(p["legacy"], exist_ok=True)
    skipped = []
    with cache_dir(p["cache"]):
        for step in walkthrough(wd):
            print("\n+ " + command_line(step, p["cache"]), flush=True)
            if step.draws and not helpers.have_matplotlib():
                print(f"step {step.name}: {step.module} draws with "
                      "matplotlib, which is not installed; skipped")
                skipped.append(step.name)
                continue
            with hook(step.name):
                call_step(step, device)
        with hook("8"):
            cam = gradcam_step(wd, device)
    return {**p, "skipped": skipped, "gradcam": cam}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workdir", default=None,
                    help="where the tree and every artifact go (default: "
                         "a new temporary directory)")
    ap.add_argument("--device", default=None,
                    help="the card unless 'cpu'")
    args = ap.parse_args(argv)
    wd = args.workdir or tempfile.mkdtemp(prefix="torch_full_demo_")
    run(wd, device=args.device)
    print("\nArtifacts:")
    for root, _, files in os.walk(wd):
        for f in sorted(files):
            if f.endswith((".png", ".pdf", ".model", ".json", ".csv", ".dla",
                           ".npy")) and not root.endswith("cache"):
                print("  ", os.path.relpath(os.path.join(root, f), wd))
    return 0


if __name__ == "__main__":
    sys.exit(main())
