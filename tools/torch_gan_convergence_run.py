"""StyleGAN WGAN-GP convergence run of the PyTorch port: the port's GAN
trainer LEARNS, not merely steps.

The twin of ``tools/gan_convergence_run.py``: the same two-band palette
images (its ``make_dataset``), the same band-stats metric (its
``band_stats`` / ``band_contrast``; those three use only numpy and
Pillow), the same trainer arguments at one resolution (2048 images, res
8, 30 epochs, batch 64, full width, training seed 1, the phase and the
checkpoint cadence the JAX tool derives), and the same criteria, driving
``<port>/data/gan_dataset`` and ``<port>/train/gan.main`` and generating
with the port's generator. It imports no JAX, so it runs on a machine
without it.

Criteria (the JAX tool's): the trainer exits 0, and the mean-abs distance
from the trained generator's band stats to the real data's is below 0.15
and below 50 % of the untrained generator's distance (the same
architecture from another seed). The running-average generator
(``g_running``) is judged and printed beside it, as in the JAX tool.

``--compute_dtype bf16`` trains under ``torch.autocast`` (the trainer's
option); the JAX runs were float32. The JAX tool's progressive-growing
runs (``--max_res``) and its ``--grad_accum`` / ``--ema_*`` pass-throughs
have no counterpart here.

Usage:
    python tools/torch_gan_convergence_run.py                  # card, f32
    python tools/torch_gan_convergence_run.py --compute_dtype bf16
    python tools/torch_gan_convergence_run.py --seed 2        # another run
    python tools/torch_gan_convergence_run.py --tiny --device cpu \\
        --epochs 1 --n_images 64 --batch 16                    # smoke
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

from tools.gan_convergence_run import (  # noqa: E402
    band_contrast,
    band_stats,
    make_dataset,
)

CODE_SIZE = 512
N_JUDGE = 256


def generate(gen, n, step, seed, device):
    """``n`` images [n, s, s, 3] from ``gen`` at ``step`` (alpha 1), the
    latents and noise drawn on the CPU from ``seed`` (the same draws on
    any device)."""
    import torch

    from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.models import (
        stylegan as sg,
    )

    g = torch.Generator().manual_seed(seed)
    zs = torch.randn((1, n, CODE_SIZE), generator=g).to(device)
    noise = [p.to(device) for p in sg.make_noise(g, n, step)]
    with torch.no_grad():
        imgs = sg.apply_styled_generator(gen, zs, noise, step=step,
                                         alpha=1.0)
    return imgs.permute(0, 2, 3, 1).float().cpu().numpy()


def build_argparser():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--res", type=int, default=8)
    ap.add_argument("--n_images", type=int, default=2048)
    ap.add_argument("--epochs", type=int, default=30)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--width", type=float, default=1.0)
    ap.add_argument("--tiny", action="store_true",
                    help="width_mult 1/16 (CPU smoke)")
    ap.add_argument("--keep", default=None,
                    help="keep run artifacts in this dir (default: tmp)")
    ap.add_argument("--compute_dtype", default="f32",
                    choices=["f32", "bf16"])
    ap.add_argument("--device", default=None,
                    help="the trainer's device: the card unless 'cpu'")
    ap.add_argument("--seed", type=int, default=1,
                    help="the trainer's seed (the JAX tool's is 1)")
    return ap


def run(argv=None) -> dict:
    """Make the images and the store, train, judge: prints the record as
    one JSON line and returns it (``converged`` says whether it met the
    criteria)."""
    import torch

    from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch._device import (
        resolve_device,
    )
    from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.data import (
        gan_dataset,
    )
    from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.models import (
        stylegan as sg,
    )
    from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.train import (
        gan,
    )

    args = build_argparser().parse_args(argv)
    device = resolve_device(args.device)
    width = (1 / 16) if args.tiny else args.width

    workdir = args.keep or tempfile.mkdtemp(prefix="torch_gan_conv_")
    img_dir = os.path.join(workdir, "imgs")
    store = os.path.join(workdir, "store")
    out = os.path.join(workdir, "run")
    step = int(np.log2(args.res)) - 2

    print(f"# workdir {workdir}")
    make_dataset(img_dir, args.n_images, 4 * args.res)
    gan_dataset._main(["--src", img_dir, "--out", store,
                       "--max-size", str(args.res), "--seed", "0"],
                      device=device)

    # the real data's statistics from the first 512 PNGs, resized to the
    # judged resolution (as the JAX tool does)
    from PIL import Image

    real = []
    for p in sorted(glob.glob(os.path.join(img_dir, "*.png")))[:512]:
        with Image.open(p) as im:
            real.append(np.asarray(im.resize((args.res, args.res)),
                                   np.float32) / 127.5 - 1.0)
    real = np.stack(real)
    s_real = band_stats(real)
    c_real = band_contrast(real)

    # the untrained baseline: the same architecture from another seed
    g0 = sg.init_styled_generator(torch.Generator().manual_seed(99),
                                  style_dim=CODE_SIZE, width_mult=width,
                                  device=device)
    init_imgs = generate(g0, N_JUDGE, step, 7, device)
    d_init = float(np.abs(band_stats(init_imgs) - s_real).mean())
    c_init = band_contrast(init_imgs)
    del g0

    t0 = time.time()
    rc = gan.main(["--data_dir", store, "--output_dir", out,
                   "--init_size", str(args.res), "--max_size", str(args.res),
                   "--step_every", str(args.epochs),
                   "--phase", str(max(args.n_images * 2, 4000)),
                   "--epochs", str(args.epochs),
                   "--batch_override", str(args.batch),
                   "--ckpt_every", str(args.epochs),
                   "--width_mult", str(width), "--seed", str(args.seed),
                   "--compute_dtype", args.compute_dtype],
                  device=device)
    wall = time.time() - t0
    if rc not in (0, None):
        record = {"converged": False, "reason": f"trainer rc={rc}"}
        print(json.dumps(record))
        return record

    last = os.path.join(out, "checkpoint",
                        f"train_step-{args.epochs - 1}.model")
    with np.load(last, allow_pickle=False) as z:
        blob = {k: z[k] for k in z.files}
    template = sg.init_styled_generator(torch.Generator().manual_seed(0),
                                        style_dim=CODE_SIZE,
                                        width_mult=width, device=device)
    dist, contrast = {}, {}
    for section in ("generator", "g_running"):
        loaded, total = gan.restore_section(template, blob, section)
        assert loaded == total, (section, loaded, total)
        imgs = generate(template, N_JUDGE, step, 7, device)
        dist[section] = float(np.abs(band_stats(imgs) - s_real).mean())
        contrast[section] = band_contrast(imgs)

    d_gen = dist["generator"]
    converged = bool(d_gen < 0.15 and d_gen < 0.5 * d_init)

    record = {
        "converged": converged, "res": args.res,
        "compute_dtype": args.compute_dtype, "width_mult": width,
        "seed": args.seed, "epochs": args.epochs,
        "samples": args.n_images * args.epochs,
        "band_dist_init": round(d_init, 4),
        "band_dist_generator": round(d_gen, 4),
        "band_dist_g_running": round(dist["g_running"], 4),
        "band_contrast_real": round(c_real, 4),
        "band_contrast_init": round(c_init, 4),
        "band_contrast_generator": round(contrast["generator"], 4),
        "train_wall_secs": round(wall, 1), "ckpt": last,
    }
    print(json.dumps(record))
    return record


def main(argv=None) -> int:
    return 0 if run(argv)["converged"] else 1


if __name__ == "__main__":
    sys.exit(main())
