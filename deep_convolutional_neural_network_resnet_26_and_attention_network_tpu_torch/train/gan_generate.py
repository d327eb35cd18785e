"""StyleGAN sample and style-mixing grids from a GAN checkpoint.

Counterpart of ``train/gan_generate.py`` in the JAX package, after the
reference's generate.py (reference:
style-based-gan-pytorch-master-512/generate.py:1-100): the mean style of
10 x 1024 codes, an n_row x n_col sample grid truncated toward it at
weight 0.7, and ``--n_mixing`` style-mixing grids in which the source
codes drive blocks 0-1 and each target code the rest. Only the
checkpoint's ``g_running`` (EMA) section is read. The grids are PNG files
written without Pillow (``train/gan.save_image_grid``). Draws come from a
``torch.Generator`` seeded by ``--seed`` on the card (``device="cpu"``
for the host).

Run ``python -m deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.train.gan_generate <checkpoint>``.
"""

import argparse
import math
import os
import sys

import torch

from .._device import resolve_device
from ..models import stylegan as sg
from . import checkpoint
from .gan import restore_section, save_image_grid


def get_mean_style(gen, generator, *, code_size=512):
    """Average mapped style over 10 x 1024 codes (reference:
    generate.py:10-24)."""
    total = None
    for _ in range(10):
        z = torch.randn((1024, code_size), generator=generator,
                        device=generator.device)
        m = sg.mean_style(gen, z)
        total = m if total is None else total + m
    return total / 10.0


def _noise_seed(generator) -> int:
    return int(torch.randint(0, 2 ** 62, (1,), generator=generator,
                             device=generator.device))


def sample(gen, generator, step, mean_style_w, n_sample, *, code_size=512):
    """Samples truncated at style weight 0.7 (reference: generate.py:26-36)."""
    zs = torch.randn((1, n_sample, code_size), generator=generator,
                     device=generator.device)
    noise = sg.make_noise(generator, n_sample, step)
    return sg.apply_styled_generator(gen, zs, noise, step=step, alpha=1.0,
                                     mean_style_w=mean_style_w,
                                     style_weight=0.7)


def style_mixing(gen, generator, step, mean_style_w, n_source, n_target, *,
                 code_size=512):
    """The source/target grid (reference: generate.py:38-71): with zs =
    [target_i, source], blocks 0-1 take the source's style
    (mixing_range=(0, 1)) and the others the target's; every call of one
    batch size sees the same noise planes."""
    dev = generator.device
    source = torch.randn((n_source, code_size), generator=generator,
                         device=dev)
    target = torch.randn((n_target, code_size), generator=generator,
                         device=dev)
    noise_seed = _noise_seed(generator)
    shape = 4 * 2 ** step

    def gen_(zs, sel=None):
        g = torch.Generator(device=dev).manual_seed(noise_seed)
        return sg.apply_styled_generator(
            gen, zs, sg.make_noise(g, zs.shape[1], step), step=step,
            alpha=1.0, style_sel=sel, mean_style_w=mean_style_w,
            style_weight=0.7)

    images = [torch.full((1, 3, shape, shape), -1.0, device=dev)]
    source_image = gen_(source[None])
    target_image = gen_(target[None])
    images.append(source_image)
    sel = [1 if i <= 1 else 0 for i in range(gen.n_blocks)]
    for i in range(n_target):
        zs = torch.stack([target[i][None].expand(n_source, -1), source])
        images.append(target_image[i][None])
        images.append(gen_(zs, sel))
    return torch.cat(images, dim=0)


def build_argparser():
    p = argparse.ArgumentParser()
    p.add_argument("path", type=str, help="path to checkpoint file")
    p.add_argument("--size", type=int, default=1024)
    p.add_argument("--n_row", type=int, default=3)
    p.add_argument("--n_col", type=int, default=5)
    p.add_argument("--code_size", type=int, default=512)
    p.add_argument("--width_mult", type=float, default=1.0)
    p.add_argument("--n_mixing", type=int, default=20)
    p.add_argument("--output_dir", default=".")
    p.add_argument("--seed", type=int, default=0)
    return p


def main(argv=None, *, device=None):
    args = build_argparser().parse_args(argv)
    device = resolve_device(device)

    os.makedirs(args.output_dir, exist_ok=True)
    gen = sg.init_styled_generator(torch.Generator().manual_seed(args.seed),
                                   style_dim=args.code_size,
                                   width_mult=args.width_mult, device=device)
    blob = {k: v for k, v in checkpoint.load_raw(args.path).items()
            if k.startswith("g_running/")}
    if not blob:
        raise ValueError(f"{args.path} has no g_running section")
    loaded, total = restore_section(gen, blob, "g_running")
    print(f"Loaded g_running from {args.path}: {loaded}/{total} tensors")
    if loaded < total:
        print(f"WARNING: {total - loaded} generator tensors missing or "
              "shape-mismatched (check --width_mult/--code_size match the "
              "GAN run); those layers keep RANDOM init weights")
    generator = torch.Generator(device=device).manual_seed(args.seed)
    step = int(math.log(args.size, 2)) - 2
    with torch.no_grad():
        mean_w = get_mean_style(gen, generator, code_size=args.code_size)
        img = sample(gen, generator, step, mean_w, args.n_row * args.n_col,
                     code_size=args.code_size)
        save_image_grid(img, os.path.join(args.output_dir, "sample.png"),
                        nrow=args.n_col)
        for j in range(args.n_mixing):
            img = style_mixing(gen, generator, step, mean_w, args.n_col,
                               args.n_row, code_size=args.code_size)
            save_image_grid(img, os.path.join(
                args.output_dir, f"sample_mixing_{j}.png"),
                nrow=args.n_col + 1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
