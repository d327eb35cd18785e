"""Interleaved sweep of the extractor's dispatch shape on the card: K
forwards of B tiles, the twin of ``tools/exp_megabatch.py``.

The forward is the JAX tool's: uint8 tiles cast to bf16 and divided by 255,
then the ResNet-26 of ``<port>/models/resnet.py`` in bf16, seeded init. JAX
runs the K microbatches as one ``lax.scan`` program; eager PyTorch has no
dispatch to amortise, so here they are a loop of K forwards, one sync at
the end. ``--stem kernel`` takes the same uint8 tiles through the
ResNet's uint8 entry, ``forward_u8``, whose stem is the kernel
(``<port>/ops/u8_stem.py``, ``csrc/u8_stem.cu``; the /255 normalize is
``alpha=1/255, beta=0``; 300 px only) before the same stages; ``cudnn``,
the default, is the forward JAX runs.

Rounds go round robin across the configs (and stems, with ``--stem
cudnn,kernel``), each with fresh tiles drawn on the device from a seeded
``torch.Generator``, so drift between rounds lands on every config alike.
Each config is run once first, untimed. One JSON line a stem and config:
the median tiles/s (with every round's), the peak device memory of its
rounds, the launches of each stem kernel (``stem_launches`` the stem
alone, ``stem_pool_launches`` the one that also pools, which bf16 takes),
and the card's name and power limit.

Usage:
    python tools/torch_exp_megabatch.py [--rounds 3] [--configs 8x1024,4x2048]
    python tools/torch_exp_megabatch.py --stem cudnn,kernel
    python tools/torch_exp_megabatch.py --device cpu --configs "1x2,2x2" \\
        --rounds 1 --res 64                              # CPU smoke

Runs on the card unless ``--device cpu``; imports nothing of JAX.
"""

import argparse
import json
import os
import statistics
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))  # repo root, for `python tools/...`

from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.models import (  # noqa: E402,E501
    resnet,
)
from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.ops import (  # noqa: E402,E501
    u8_stem,
)
from tools import torch_measure as TM  # noqa: E402

DTYPE = torch.bfloat16


def parse_configs(text: str):
    """``"8x1024,4x2048"`` -> ``[(8, 1024), (4, 2048)]``."""
    return [tuple(int(v) for v in c.split("x")) for c in text.split(",")]


def make_forward(cnn, stem: str = "cudnn"):
    """uint8 tiles ``[B, res, res, 3]`` -> float32 embeddings ``[B, L]``:
    the JAX tool's ``/255`` bf16 forward, with the stem as asked."""
    if stem == "kernel":
        return lambda x: cnn.forward_u8(
            x, alpha=1 / 255.0, beta=0.0, compute_dtype=DTYPE).float()
    return lambda x: resnet.apply_resnet26(
        cnn, x.to(DTYPE) / 255.0, compute_dtype=DTYPE).float()


def megabatch(fwd, x):
    """K forwards of B tiles: ``x [K, B, ...]`` -> ``[K, B, L]``."""
    return torch.stack([fwd(x[k]) for k in range(x.shape[0])])


def make_tiles(K, B, res, seed, device):
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.randint(0, 256, (K, B, res, res, 3), generator=g,
                         device=device, dtype=torch.uint8)


def sweep(configs, rounds, stems, res, device):
    """The rows, one a stem and config: median and every round's tiles/s,
    peak GB, and the launches of each stem kernel (the untimed first
    call's included)."""
    if "kernel" in stems and res != u8_stem.H_IN:
        raise SystemExit(f"--stem kernel takes {u8_stem.H_IN} px tiles "
                         f"only; got --res {res}")
    cuda = device.type == "cuda"
    cnn = resnet.init_resnet26(torch.Generator().manual_seed(0),
                               device=device)
    fwds = {stem: make_forward(cnn, stem) for stem in stems}
    cases = [(stem, K, B) for stem in stems for K, B in configs]
    rates = {c: [] for c in cases}
    peaks = {c: 0 for c in cases}
    launches = {c: [0, 0] for c in cases}

    def run(case, x):  # launches of the stem kernel and the pooled one
        n0 = u8_stem.LAUNCHES, u8_stem.POOLED_LAUNCHES
        out = megabatch(fwds[case[0]], x)
        launches[case][0] += u8_stem.LAUNCHES - n0[0]
        launches[case][1] += u8_stem.POOLED_LAUNCHES - n0[1]
        return out

    with torch.no_grad():
        for case in cases:  # each shape's first call (cuDNN's plans) untimed
            run(case, make_tiles(*case[1:], res, 0, device))
        TM.sync(device)
        for r in range(rounds):
            for case in cases:
                _, K, B = case
                x = make_tiles(K, B, res, 100 * r + K + B, device)
                TM.sync(device)
                if cuda:
                    torch.cuda.reset_peak_memory_stats(device)
                t0 = time.perf_counter()
                out = run(case, x)
                TM.sync(device)
                rates[case].append(K * B / (time.perf_counter() - t0))
                if cuda:
                    peaks[case] = max(peaks[case],
                                      torch.cuda.max_memory_allocated(device))
                if not bool(torch.isfinite(out).all()):
                    raise RuntimeError(f"non-finite embeddings at {case}")
                del x, out
    return [{"K": c[1], "B": c[2], "tiles": c[1] * c[2], "stem": c[0],
             "res": res, "median_tiles_per_s": statistics.median(rates[c]),
             "tiles_per_s": rates[c],
             "peak_mem_gb": peaks[c] / 1e9 if cuda else None,
             "stem_launches": launches[c][0],
             "stem_pool_launches": launches[c][1]} for c in cases]


def build_argparser():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--configs", default="8x1024,4x2048",
                    help='KxB pairs, e.g. "8x1024,16x512"')
    ap.add_argument("--stem", default="cudnn",
                    help="cudnn (the stem as the forward runs it), kernel "
                         "(the uint8 stem kernel, 300 px) or both, "
                         "comma-separated, interleaved in every round")
    ap.add_argument("--res", type=int, default=300)
    ap.add_argument("--device", default=None, help="the card unless 'cpu'")
    return ap


def main(argv=None) -> int:
    ap = build_argparser()
    args = ap.parse_args(argv)
    stems = args.stem.split(",")
    if not set(stems) <= {"cudnn", "kernel"}:
        ap.error(f"--stem takes cudnn and kernel, got {args.stem!r}")
    device = TM.resolve(args.device, "torch_exp_megabatch")
    card = TM.card_record(device)
    for row in sweep(parse_configs(args.configs), args.rounds, stems,
                     args.res, device):
        print(json.dumps({**row, "device": device.type, **card}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
