"""Full-width convergence run of the PyTorch port's classifier: the
port's trainer LEARNS, not merely steps.

The twin of ``tools/convergence_run.py``: the same grating bags (its
``build_tree``, which uses only numpy), the same trainer arguments
(``--arch full`` 20/40/60/80 at 300 px, ``--train_pad 0``, fold 0, seed 0,
42 slides of 64+ tiles), the same criteria (the last train loss below the
first, held-out slide accuracy 1.0) and the same report keys, driving
``<port>/train/classify.main`` instead of the JAX package's. It imports no
JAX, so it runs on a machine without it.

Two differences from the JAX tool's argv, both forced by the port: no
``--n_vis 1`` (the attention grids need matplotlib, which the card's
machine lacks; the port's default is 0), and ``--f32`` on the CPU
(PyTorch's CPU bf16 convolution can return a garbage weight gradient
for this network; the card trains in bf16 as the JAX run did).

Usage:
    python tools/torch_convergence_run.py --epochs 30        # full width, card
    python tools/torch_convergence_run.py --tiny --device cpu  # smoke
"""

import argparse
import glob
import json
import os
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))  # repo root, for `python tools/...`

from tools.convergence_run import build_tree  # noqa: E402


def build_argparser():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--epochs", type=int, default=15,
                    help="must be >= 5: the trainer writes validation "
                         "summaries every 5 epochs, and the criteria need "
                         "at least two of them")
    ap.add_argument("--slides", type=int, default=42)
    ap.add_argument("--tiles", type=int, default=64)
    ap.add_argument("--resolution", type=int, default=300)
    ap.add_argument("--tiny", action="store_true",
                    help="tiny arch + 32 px tiles (smoke; no criteria)")
    ap.add_argument("--out", default=None,
                    help="work dir (default: a temp dir)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="the trainer's device: the card unless 'cpu'")
    return ap


def run(argv=None) -> dict:
    """Build the tree, train, judge: prints the report as one JSON line
    and returns it, or raises AssertionError naming the criterion
    missed."""
    ap = build_argparser()
    args = ap.parse_args(argv)
    if args.epochs < 5:
        ap.error("--epochs must be >= 5 (summaries land every 5 epochs)")

    res = 32 if args.tiny else args.resolution
    work = args.out or tempfile.mkdtemp(prefix="torch_convergence_")
    os.makedirs(work, exist_ok=True)
    tree = os.path.join(work, "tree")
    build_tree(tree, n_slides=args.slides, tiles_per_slide=args.tiles,
               roi=res, seed=args.seed)
    os.environ["CACHE_DIR"] = os.path.join(tree, "cache")

    from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.train import (
        classify,
    )

    t0 = time.time()
    rc = classify.main([
        "--tag", "CONV", "--arch", "tiny" if args.tiny else "full",
        "--resolution", str(res), "--roi_size", str(res),
        "--epoch_start", "0", "--epoch_end", str(args.epochs),
        "--fold", "0", "--seed", str(args.seed),
        "--train_pad", "0",
        "--data_root", tree, "--image_dir", "slides",
        "--label_sheet", os.path.join(tree, "clusters.csv"),
        "--output_root", work,
    ] + (["--f32"] if args.device == "cpu" else []), device=args.device)
    wall = time.time() - t0
    assert rc == 0, f"trainer exited {rc}"

    run_dir = os.path.join(work, "run_CONV")
    stats = []
    for path in sorted(glob.glob(os.path.join(run_dir, "*summary.json"))):
        with open(path) as f:
            stats.append((os.path.basename(path), json.load(f)))
    assert stats, f"no summary.json under {run_dir}"
    first, last = stats[0][1], stats[-1][1]
    train_secs = [s.get("train_secs") for _, s in stats
                  if s.get("train_secs")]
    valid_acc = last["valid_acc"]["accuracy"]
    report = {
        "epochs": args.epochs,
        "slides": args.slides,
        "arch": "tiny" if args.tiny else "full 20/40/60/80",
        "resolution": res,
        "first_train_loss": round(first["train_loss"], 4),
        "last_train_loss": round(last["train_loss"], 4),
        "last_train_err": round(last["train_err"], 4),
        "heldout_accuracy": round(valid_acc, 4),
        "secs_per_train_epoch_median": round(float(np.median(train_secs)),
                                             1),
        "total_wall_secs": round(wall, 1),
        "run_dir": run_dir,
    }
    print(json.dumps(report))
    if not args.tiny:
        # a 5-epoch tiny model at the warm-up lr has no convergence claim
        assert last["train_loss"] < first["train_loss"], \
            (first["train_loss"], last["train_loss"])
        assert valid_acc == 1.0, f"held-out accuracy {valid_acc} != 1.0"
    return report


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
