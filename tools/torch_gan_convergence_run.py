"""StyleGAN WGAN-GP convergence run of the PyTorch port: the port's GAN
trainer LEARNS, not merely steps.

The twin of ``tools/gan_convergence_run.py``: the same two-band palette
images (its ``make_dataset``), the same band-stats metric (its
``band_stats`` / ``band_contrast``; those three use only numpy and
Pillow), the same trainer arguments (2048 images, res 8, 30 epochs, batch
64, full width, training seed 1) and the same schedule (:func:`schedule`:
the epochs a resolution, the phase, the checkpoint cadence), and the same
criteria, driving ``<port>/data/gan_dataset`` and ``<port>/train/gan.main``
and generating with the port's generator. It imports no JAX, so it runs on
a machine without it.

``--max_res`` above ``--res`` trains across the progressive-growing
transitions (``--step_every`` epochs a resolution, by default the epoch
budget split evenly; a phase of half an epoch's images, so that each
fade-in ends inside its epoch; a checkpoint at the end of each
resolution), judges at ``--max_res`` and also judges the last epoch before
the first transition at ``--res`` (``band_dist_pre_transition``), as the
JAX tool does. ``--grad_accum``, ``--ema_decay`` and ``--ema_warmup`` pass
through to the trainer.

Criteria (the JAX tool's): the trainer exits 0, and the mean-abs distance
from the trained generator's band stats to the real data's is below 0.15
and below 50 % of the untrained generator's distance (the same
architecture from another seed). The running-average generator
(``g_running``) is judged and printed beside it, as in the JAX tool.

``--compute_dtype bf16`` trains under ``torch.autocast`` (the trainer's
option); the JAX runs were float32.

Usage:
    python tools/torch_gan_convergence_run.py                  # card, f32
    python tools/torch_gan_convergence_run.py --compute_dtype bf16
    python tools/torch_gan_convergence_run.py --seed 2        # another run
    python tools/torch_gan_convergence_run.py --max_res 32 --ema_decay 0.99
    python tools/torch_gan_convergence_run.py --tiny --device cpu \\
        --epochs 1 --n_images 64 --batch 16                    # smoke
"""

import argparse
import glob
import json
import os
import re
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))  # repo root, for `python tools/...`

from tools import torch_measure as TM  # noqa: E402
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
    ap.add_argument("--max_res", type=int, default=None,
                    help="final resolution; above --res the run trains "
                         "across the progressive-growing transitions and "
                         "is judged at this resolution")
    ap.add_argument("--step_every", type=int, default=None,
                    help="epochs a resolution (default: the epoch budget "
                         "split evenly across the resolutions)")
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
    ap.add_argument("--grad_accum", type=int, default=1,
                    help="microbatches a step (train.gan --grad_accum)")
    ap.add_argument("--ema_decay", type=float, default=0.999,
                    help="g_running's decay (train.gan --ema_decay)")
    ap.add_argument("--ema_warmup", action="store_true",
                    help="train.gan --ema_warmup: the decay "
                         "min(ema_decay, (1+t)/(10+t))")
    return ap


def schedule(res, max_res, epochs, n_images, step_every=None):
    """The JAX tool's schedule: the epochs a resolution, the phase (half
    an epoch's images when a transition comes, else past the run), the
    checkpoint cadence (one a resolution), the resolution step of each
    epoch, the transitions, the judged step and the last epoch before the
    first transition."""
    max_res = max_res or res
    if max_res < res:
        raise SystemExit(f"--max_res {max_res} is below --res {res}")
    n_res = int(np.log2(max_res)) - int(np.log2(res)) + 1
    step_every = step_every or max(epochs // n_res, 1)
    init_step, max_step = int(np.log2(res)) - 2, int(np.log2(max_res)) - 2
    res_seq = [min(init_step + e // step_every, max_step)
               for e in range(epochs)]
    transitions = sum(a != b for a, b in zip(res_seq, res_seq[1:]))
    return {"max_res": max_res, "step_every": step_every,
            "phase": (max(n_images // 2, 512) if max_res > res
                      else max(n_images * 2, 4000)),
            "ckpt_every": step_every, "init_step": init_step,
            "max_step": max_step, "res_seq": res_seq,
            "res_transitions": transitions,
            "pre_transition_epoch": step_every - 1 if transitions else None}


def trainer_argv(args, store, out, width, sched):
    """``train.gan.main``'s arguments: the JAX tool's, with the seed and
    the compute dtype."""
    return (["--data_dir", store, "--output_dir", out,
             "--init_size", str(args.res),
             "--max_size", str(sched["max_res"]),
             "--step_every", str(sched["step_every"]),
             "--phase", str(sched["phase"]),
             "--epochs", str(args.epochs),
             "--batch_override", str(args.batch),
             "--grad_accum", str(args.grad_accum),
             "--ema_decay", str(args.ema_decay),
             "--ckpt_every", str(sched["ckpt_every"]),
             "--width_mult", str(width), "--seed", str(args.seed),
             "--compute_dtype", args.compute_dtype]
            + (["--ema_warmup"] if args.ema_warmup else []))


def _restore(template, path, section):
    from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.train import (
        gan,
    )

    with np.load(path, allow_pickle=False) as z:
        blob = {k: z[k] for k in z.files}
    loaded, total = gan.restore_section(template, blob, section)
    assert loaded == total, (section, loaded, total)
    return template


def run(argv=None) -> dict:
    """Make the images and the store, train, judge: prints the record as
    one JSON line and returns it (``converged`` says whether it met the
    criteria)."""
    import torch

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
    device = TM.resolve(args.device, "torch_gan_convergence_run")
    width = (1 / 16) if args.tiny else args.width
    sched = schedule(args.res, args.max_res, args.epochs, args.n_images,
                     args.step_every)
    max_res = sched["max_res"]

    workdir = args.keep or tempfile.mkdtemp(prefix="torch_gan_conv_")
    img_dir = os.path.join(workdir, "imgs")
    store = os.path.join(workdir, "store")
    out = os.path.join(workdir, "run")
    step = sched["max_step"]  # judged at the final resolution

    print(f"# workdir {workdir}")
    make_dataset(img_dir, args.n_images, 4 * max_res)
    gan_dataset._main(["--src", img_dir, "--out", store,
                       "--max-size", str(max_res), "--seed", "0"],
                      device=device)

    # the real data's statistics from the first 512 PNGs, each decoded
    # once and resized to every judged resolution (as the JAX tool does)
    from PIL import Image

    judge_res = {max_res} | ({args.res} if sched["res_transitions"]
                             else set())
    stacks = {r: [] for r in judge_res}
    for p in sorted(glob.glob(os.path.join(img_dir, "*.png")))[:512]:
        with Image.open(p) as im:
            for r in judge_res:
                stacks[r].append(np.asarray(im.resize((r, r)), np.float32)
                                 / 127.5 - 1.0)
    real_by_res = {r: np.stack(v) for r, v in stacks.items()}
    real = real_by_res[max_res]
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
    rc = gan.main(trainer_argv(args, store, out, width, sched),
                  device=device)
    wall = time.time() - t0
    if rc not in (0, None):
        record = {"converged": False, "reason": f"trainer rc={rc}"}
        print(json.dumps(record))
        return record

    ckpts = glob.glob(os.path.join(out, "checkpoint", "train_step-*.model"))
    last = max(ckpts, key=lambda p: int(
        re.search(r"-(\d+)\.model$", p).group(1)))
    template = sg.init_styled_generator(torch.Generator().manual_seed(0),
                                        style_dim=CODE_SIZE,
                                        width_mult=width, device=device)
    dist, contrast = {}, {}
    for section in ("generator", "g_running"):
        imgs = generate(_restore(template, last, section), N_JUDGE, step, 7,
                        device)
        dist[section] = float(np.abs(band_stats(imgs) - s_real).mean())
        contrast[section] = band_contrast(imgs)

    d_gen = dist["generator"]
    converged = bool(d_gen < 0.15 and d_gen < 0.5 * d_init)

    record = {
        "converged": converged, "res": args.res, "max_res": max_res,
        "res_transitions": sched["res_transitions"],
        "step_every": sched["step_every"],
        "ckpt_every": sched["ckpt_every"], "grad_accum": args.grad_accum,
        "ema_decay": args.ema_decay, "ema_warmup": args.ema_warmup,
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
        **TM.card_record(device),
    }
    pre_ep = sched["pre_transition_epoch"]
    pre_path = os.path.join(out, "checkpoint", f"train_step-{pre_ep}.model")
    if pre_ep is not None and os.path.exists(pre_path):
        # learned before the fade against after it: the last epoch before
        # the first transition, judged at the starting resolution
        pre_imgs = generate(_restore(template, pre_path, "generator"),
                            N_JUDGE, sched["init_step"], 7, device)
        record["band_dist_pre_transition"] = round(float(np.abs(
            band_stats(pre_imgs) - band_stats(real_by_res[args.res])
        ).mean()), 4)
        record["pre_transition_epoch"] = pre_ep
    print(json.dumps(record))
    return record


def main(argv=None) -> int:
    return 0 if run(argv)["converged"] else 1


if __name__ == "__main__":
    sys.exit(main())
