"""The one traffic generator: it reads a mix (``traffic/<mix>.json``), the
configuration's slide scale and a seed, and yields the work of a run.

Every seed gets the same set of slide sizes, in another order: the sizes
are the ``count`` quantiles of a log-uniform law over the configuration's
``[slide_tiles_min, slide_tiles_max]``, rounded to a ``multiple`` of
tiles, and a run walks them in cycles, each a
fresh permutation drawn from the seed. So runs of different seeds do the
same work, and the shapes a run will meet are known at set-up. The tiles of
a slide are a contiguous run of the host pool at an offset drawn from the
seed; a training bag's augmentation noise, subsample scores, dropout mask
and label are drawn from the seed too.
"""

import numpy as np
import torch

# sub-streams of a run's seed; a number keeps its draws once it is used
POOL, ORDER, OFFSETS, NOISE, WEIGHTS, CHECK = 0, 1, 2, 4, 5, 6


def rng(seed, stream):
    """The numpy generator of ``stream`` for the run's ``seed`` (any
    non-negative integer)."""
    return np.random.default_rng(np.random.SeedSequence([int(seed), stream]))


def torch_seed(seed, stream):
    """A 63-bit seed for a ``torch.Generator`` from the run's seed."""
    return int(rng(seed, stream).integers(0, 2 ** 63 - 1))


def slide_sizes(spec, cfg):
    """The mix's fixed set of slide sizes over the configuration's slide
    scale, ascending."""
    lo, hi = cfg["slide_tiles_min"], cfg["slide_tiles_max"]
    n, m = spec["count"], spec["multiple"]
    out = []
    for i in range(n):
        t = lo * (hi / lo) ** ((i + 0.5) / n)
        out.append(int(min(hi, max(lo, m * round(t / m)))))
    return out


def make_pool(n_tiles, px, seed, device, *, block=256):
    """The host pool of ``n_tiles`` uint8 tiles [N, px, px, 3], drawn on
    ``device`` from the seed in blocks and copied to host memory.

    Each tile has a colour, a contrast and a smooth texture of its own
    (8 x 8 Gaussian values upsampled to the tile) under pixel noise, so
    that tiles differ from one another as a slide's do. Tiles of noise
    alone give features that barely vary across a bag (their spread is a
    fortieth of their size at 300 px), which the head's batch norm over
    the bag then divides by."""
    gen = torch.Generator(device=device)
    gen.manual_seed(torch_seed(seed, POOL))
    pool = np.empty((n_tiles, px, px, 3), dtype=np.uint8)
    for lo in range(0, n_tiles, block):
        n = min(block, n_tiles - lo)

        def draw(*shape):
            return torch.rand(shape, generator=gen, device=device)

        base = 20.0 + 200.0 * draw(n, 1, 1, 3)
        contrast = 60.0 * draw(n, 1, 1, 1)
        texture = torch.nn.functional.interpolate(
            torch.randn((n, 3, 8, 8), generator=gen, device=device),
            size=(px, px), mode="bilinear", align_corners=False)
        noise = 12.0 * torch.randn((n, px, px, 3), generator=gen,
                                   device=device)
        tiles = base + contrast * texture.permute(0, 2, 3, 1) + noise
        pool[lo:lo + n] = tiles.clamp_(0, 255).round_().to(
            torch.uint8).cpu().numpy()
    return pool


class Traffic:
    """The work of one run of ``mix`` for the configuration ``cfg`` at
    ``seed`` over a pool of ``pool_tiles`` tiles."""

    def __init__(self, mix, cfg, seed, pool_tiles):
        self.mix, self.cfg = mix, cfg
        self.seed, self.pool_tiles = int(seed), pool_tiles
        self.sizes = slide_sizes(mix["sizes"], cfg) if "sizes" in mix else []
        if self.sizes and max(self.sizes) > pool_tiles:
            raise ValueError("a slide is larger than the pool")
        self._order = rng(seed, ORDER)
        self._offsets = rng(seed, OFFSETS)

    def _slide(self, size):
        return size, int(self._offsets.integers(0, self.pool_tiles - size + 1))

    def slides(self):
        """Slides ``(tiles, offset)`` without end: cycles over the sizes,
        each in a fresh order."""
        while True:
            for i in self._order.permutation(len(self.sizes)):
                yield self._slide(self.sizes[i])

    def windows(self):
        """Training windows without end: ``accum``
        bags of ``bag_tiles`` tiles, each ``(offset, noise, label)``; the
        noise holds the crop offsets [T, 2] within ``[0, 2 * pad]``, the
        flips [T], the Gumbel scores [T] of the subsample and the dropout
        keep mask [k, L] of its ``k = max(1, int(T * fraction))`` tiles."""
        cfg, T, pad = self.cfg, self.mix["bag_tiles"], self.mix["pad"]
        n_classes, L, rate = cfg["n_classes"], cfg["L"], cfg["dropout"]
        k = max(1, int(T * cfg["train_tile_fraction"]))
        noise = rng(self.seed, NOISE)
        while True:
            window = []
            for _ in range(self.mix["accum"]):
                _, offset = self._slide(T)
                u = noise.random(T, dtype=np.float32)
                u = np.maximum(u, np.finfo(np.float32).tiny)
                window.append((offset, {
                    "offsets": torch.from_numpy(
                        noise.integers(0, 2 * pad + 1, (T, 2))),
                    "flip_h": torch.from_numpy(noise.random(T) < 0.5),
                    "flip_v": torch.from_numpy(noise.random(T) < 0.5),
                    "scores": torch.from_numpy(-np.log(-np.log(u))),
                    "keep": torch.from_numpy(noise.random((k, L)) >= rate),
                }, int(noise.integers(0, n_classes))))
            yield window


def quantile(values, q):
    """The ``q`` quantile of ``values`` by linear interpolation."""
    return float(np.percentile(np.asarray(values, dtype=np.float64), q))
