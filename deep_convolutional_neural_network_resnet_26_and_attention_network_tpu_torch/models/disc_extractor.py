"""StyleGAN-critic feature extraction ("partial GAN trained discriminator
reduction").

Counterpart of ``models/disc_extractor.py`` in the JAX package. The
reference's legacy pipeline reused a histology-GAN critic, cut at
``disc_cutoff = 6``, as the classifier's frozen tile feature extractor
(reference: gbm/classify.py:33,37,116 ``classifier(x, y,
step_input=disc_cutoff)``): from_rgb at the tiles' resolution step, then
the progression blocks from that step down while ``i > step - cutoff``,
then a spatial mean into ``[T, C]``, which feeds the attention-MIL head
through ``apply_attention_mil(extractor=...)``.

The blocks above 4 px act on each tile alone, so they run ``chunk`` tiles
at a time (a 5000-tile bag at 64 px would otherwise hold tens of GB of
activations); the 4 px block's minibatch stddev then sees the whole bag,
as it does in the JAX package.
"""

import torch

from . import stylegan as sg

DISC_CUTOFF = 6  # reference: gbm/classify.py:33
CHUNK = 512


def feature_dim(step: int, *, cutoff: int = DISC_CUTOFF,
                width_mult: float = 1.0) -> int:
    """The output width: the cout of the last block the cut critic runs
    (i = step down to step - cutoff + 1)."""
    layout, _ = sg._disc_layout(width_mult)
    last_i = max(step - cutoff, -1) + 1
    return layout[len(layout) - last_i - 1][1]


def apply_disc_extractor(disc, tiles, *, step: int, cutoff: int = DISC_CUTOFF,
                         chunk: int = CHUNK):
    """tiles [T, s, s, 3] (NHWC, resolution 4 * 2**step) -> features
    [T, C], without dropout and without autograd."""
    n = disc.n_blocks
    if not 0 <= step < n:
        raise ValueError(
            f"step {step} out of range for a {n}-block discriminator "
            f"(max resolution {4 * 2 ** (n - 1)}px)")
    if cutoff < 1:
        raise ValueError(f"cutoff must be >= 1 (got {cutoff}): at least "
                         "one discriminator block must run")
    blocks = list(range(step, max(step - cutoff, -1), -1))
    per_tile = [i for i in blocks if i > 0]

    def run(x, ids):
        for i in ids:
            index = n - i - 1
            if i == step:
                x = disc.from_rgb[index](x)
            if i == 0:
                x = sg.minibatch_stddev(x)
            x = disc.progression[index](x)
        return x

    with torch.no_grad():
        x = tiles.permute(0, 3, 1, 2)
        parts = [run(x[lo:lo + chunk], per_tile)
                 for lo in range(0, max(x.shape[0], 1), chunk)]
        out = torch.cat(parts, dim=0) if len(parts) > 1 else parts[0]
        if blocks[-1] == 0:
            out = run(out, [0] if per_tile else blocks)
        return out.mean(dim=(2, 3))


def make_extractor(disc, *, step: int, cutoff: int = DISC_CUTOFF,
                   chunk: int = CHUNK):
    """``extract(cnn, tiles) -> [T, C]`` for ``apply_attention_mil(
    extractor=...)``: the critic's weights are closed over and frozen, like
    the reference's pretrained discriminator (gbm/classify.py:37); the
    classifier's own ``cnn`` is unused."""

    def extract(_cnn, tiles):
        return apply_disc_extractor(disc, tiles, step=step, cutoff=cutoff,
                                    chunk=chunk)

    return extract
