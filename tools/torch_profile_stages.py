"""Per-stage profile of the PyTorch port's ResNet-26 forward on the card.

The twin of ``tools/profile_stages.py``. Times each segment (stem /
stage1..4 / pool+fc) of ``<port>/models/resnet.py``'s modules with CUDA
events (median of three runs of ``--iters`` calls, after a warm-up call)
and prints a table of milliseconds, analytic GFLOPs, achieved TFLOP/s and
share of the segment sum; then the whole forward, with the sum of the
segments beside it. ``--json`` prints the twin's keys on one line, with
the card's name and power limit, each segment's TFLOP/s as a share of a
bf16 product calibration taken in the same process
(``share_of_calibration``), and the pool's and stem's kernel launches.

The segments are the ResNet's own pieces (``stem``, ``run_stage``,
``head``). ``--stem cudnn`` (the default) times its float entry,
``ResNet26.forward`` with cuDNN's 7x7/s2 stem on float32 tiles; ``--stem
kernel`` its uint8 entry, ``ResNet26.forward_u8``, whose stem is
``<port>/ops/u8_stem.py`` (``csrc/u8_stem.cu``, 300 px only), in the stem
segment and the whole forward both: the twin of
``tools/exp_stem_pallas.py``'s A/B. In bf16 that stem is one launch that
also pools; beside it ``--stem kernel`` times the composition it replaces
(the stem kernel, then the cast, LeakyReLU and max-pool:
``stem_composition_sec``). The FLOP count is the same, and is
``benchmark/flops.py``'s.

``--device-calibration`` prints the bf16 product rate of chained 4096^3
``torch.matmul`` calls at 16 and 32 chains and their marginal rate.
``--train`` decomposes the single-bag training step through
``<port>/parallel/steps.py`` at ``--tiles-per-bag`` (forward; forward and
backward; the step with Adam), with ``remat`` off and on; each bag pools
its 20 % subsample through the pool's forward and backward kernels.

The twin's fresh inputs defeat a TPU runtime's result cache; PyTorch has
none, so each segment is timed on one input. On the host (``--device
cpu``) the times are the CPU's and the calibration is a 512^3 chain, only
to exercise the path. Imports nothing of JAX.

Usage:
    python tools/torch_profile_stages.py [--batch 128] [--iters 6] [--res 300]
    python tools/torch_profile_stages.py --stem kernel --batch 1024 --json
    python tools/torch_profile_stages.py --device-calibration
    python tools/torch_profile_stages.py --train --tiles-per-bag 2500
"""

import argparse
import json
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))  # repo root, for `python tools/...`

from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.models import (  # noqa: E402,E501
    attention_mil as amil,
    resnet,
)
from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.ops import (  # noqa: E402,E501
    u8_stem,
)
from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.parallel import (  # noqa: E402,E501
    steps,
)
from benchmark.flops import segment_flops  # noqa: E402
from tools import torch_measure as TM  # noqa: E402

SEGMENTS = ("stem", "stage1", "stage2", "stage3", "stage4", "pool_fc")
SERVE_ALPHA, SERVE_BETA = 2 / 255.0, -1.0   # data/transforms.py's normalize
CALIB_N = {"cuda": 4096, "cpu": 512}


def segment_shapes(batch, res, widths=resnet.WIDTHS):
    """Each segment's input shape, NHWC (the twin's ``main``)."""
    shapes = {"stem": (batch, res, res, 3)}
    h = (res + 1) // 2
    h = (h + 1) // 2
    shapes["stage1"] = (batch, h, h, widths[0])
    shapes["stage2"] = (batch, h, h, widths[0])
    h = (h + 1) // 2
    shapes["stage3"] = (batch, h, h, widths[1])
    h = (h + 1) // 2
    shapes["stage4"] = (batch, h, h, widths[2])
    h = (h + 1) // 2
    shapes["pool_fc"] = (batch, h, h, widths[3])
    return shapes


def build_segments(cnn, compute_dtype=torch.bfloat16, stem="cudnn"):
    """``[(name, fn)]`` for each forward segment, the ResNet's own pieces.
    The stem takes NHWC tiles (float, or uint8 with ``stem="kernel"``) and
    returns NCHW (``channels_last``) activations; each stage takes and
    returns them; pool_fc returns the embeddings [B, embed_dim]."""
    def run_stem(x):
        if stem == "kernel":
            return cnn.stem_u8(x, alpha=SERVE_ALPHA, beta=SERVE_BETA,
                               compute_dtype=compute_dtype)
        return cnn.stem(x.contiguous(), compute_dtype=compute_dtype)

    def make_stage(si):
        return lambda x: cnn.run_stage(si, x, compute_dtype=compute_dtype)

    def pool_fc(x):
        return cnn.head(x, compute_dtype=compute_dtype)[1]

    return [("stem", run_stem), ("stage1", make_stage(0)),
            ("stage2", make_stage(1)), ("stage3", make_stage(2)),
            ("stage4", make_stage(3)), ("pool_fc", pool_fc)]


def full_forward(cnn, stem="cudnn", compute_dtype=torch.bfloat16):
    """The whole forward the stem choice runs: ``ResNet26.forward`` or
    ``ResNet26.forward_u8``."""
    if stem == "kernel":
        return lambda x: cnn.forward_u8(x, alpha=SERVE_ALPHA, beta=SERVE_BETA,
                                        compute_dtype=compute_dtype)
    return lambda x: resnet.apply_resnet26(cnn, x,
                                           compute_dtype=compute_dtype)


def calibration_tflops(device, chains: int = 16, repeats: int = 3) -> float:
    """The bf16 product rate the card reaches now: ``chains`` chained
    n^3 ``torch.matmul`` calls (n = 4096 on the card), N(0, 1/n) entries
    keeping the scale near 1, timed with CUDA events, median of
    ``repeats``. The one probe the segment shares divide by."""
    n = CALIB_N[torch.device(device).type]
    g = torch.Generator(device=device).manual_seed(0)
    b = (torch.randn((n, n), generator=g, device=device) / n ** 0.5).to(
        torch.bfloat16)

    def chain():
        y = b
        for _ in range(chains):
            y = y @ b
        return y

    with torch.no_grad():
        ms = TM.time_ms(chain, device, repeats=repeats)
    return chains * 2 * n ** 3 / (ms / 1e3) / 1e12


def device_calibration(device, iters=8):
    """The calibration at 16 and 32 chains, one JSON line each, then the
    marginal rate of the 16 extra products (which cancels any fixed
    per-chain cost)."""
    card = TM.card_record(device)
    n = CALIB_N[torch.device(device).type]
    rates = {}
    for chains in (16, 32):
        rates[chains] = calibration_tflops(device, chains,
                                           repeats=max(iters // 2, 3))
        print(json.dumps({"chains": chains,
                          "matmul_tflops": round(rates[chains], 2),
                          "n": n, **card}), flush=True)
    t16, t32 = (c * 2 * n ** 3 / (rates[c] * 1e12) for c in (16, 32))
    marginal = 16 * 2 * n ** 3 / max(t32 - t16, 1e-12) / 1e12
    print(json.dumps({"marginal_tflops": round(marginal, 2), "n": n,
                      **card}), flush=True)
    return rates, marginal


def _inputs(shape, device, stem, seed, compute_dtype):
    """A segment input: NHWC float32 [0, 1) tiles (uint8 for the stem
    kernel), or for a stage the NCHW ``channels_last`` activations in the
    compute dtype."""
    g = torch.Generator(device=device).manual_seed(seed)
    if len(shape) == 4 and shape[-1] == 3:
        if stem == "kernel":
            return torch.randint(0, 256, shape, generator=g, device=device,
                                 dtype=torch.uint8)
        return torch.rand(shape, generator=g, device=device)
    x = torch.rand(shape, generator=g, device=device)
    x = x.permute(0, 3, 1, 2)
    return x if compute_dtype is None else x.to(compute_dtype)


def profile_forward(batch, res, iters, device, stem="cudnn"):
    """The per-segment and whole-forward rows, the calibration, the launch
    record, and with ``stem="kernel"`` the seconds of the composition that
    the bf16 stem segment's one launch replaces (None otherwise)."""
    if stem == "kernel" and res != u8_stem.H_IN:
        raise SystemExit(f"--stem kernel takes {u8_stem.H_IN} px tiles "
                         f"only; got --res {res}")
    cnn = resnet.init_resnet26(torch.Generator().manual_seed(0),
                               device=device)
    flops = segment_flops(res)
    shapes = segment_shapes(batch, res)
    rows = []
    with TM.kernel_record() as rec, torch.no_grad():
        for i, (name, fn) in enumerate(build_segments(cnn, stem=stem)):
            x = _inputs(shapes[name], device, stem, i, torch.bfloat16)
            ms = TM.time_ms(lambda: fn(x), device, iters=iters)
            del x
            gf = flops[name] * batch / 1e9
            rows.append((name, ms / 1e3, gf, gf / (ms / 1e3) / 1e3))
        x = _inputs(shapes["stem"], device, stem, 99, None)
        full_fn = full_forward(cnn, stem)
        full_sec = TM.time_ms(lambda: full_fn(x), device, iters=iters) / 1e3
        composition_sec = None
        if stem == "kernel":
            composition_sec = TM.time_ms(
                lambda: u8_stem.pool_epilogue(u8_stem.stem_u8_conv(
                    cnn.conv1, x, alpha=SERVE_ALPHA, beta=SERVE_BETA)),
                device, iters=iters) / 1e3
        del x
    calib = calibration_tflops(device)
    return rows, full_sec, calib, rec, composition_sec


def profile_train(tiles_per_bag, res, iters, device, as_json=False):
    """Decompose the single-bag training step: forward only, forward and
    backward, and the full step with Adam, remat off and on; one row
    each. The bag's noise (Gumbel scores and dropout mask) is drawn once
    from a seeded generator and injected."""
    card = TM.card_record(device)
    cuda = torch.device(device).type == "cuda"
    g = torch.Generator().manual_seed(0)
    x = torch.rand((tiles_per_bag, res, res, 3),
                   generator=torch.Generator(device=device).manual_seed(0),
                   device=device)
    mask = torch.ones(tiles_per_bag, device=device)
    cfg0 = amil.MILConfig()
    k = max(1, int(tiles_per_bag * cfg0.train_tile_fraction))
    scores = amil.gumbel_scores(g, tiles_per_bag)
    keep = amil.dropout_keep(g, (k, cfg0.L), cfg0.dropout)
    dtype = torch.bfloat16
    if not as_json:
        print(f"train-step profile  bag={tiles_per_bag}x{res}px bf16 "
              f"(pooled T={k}) device={device} {card['card']}, "
              f"{card['power_limit']}")
    rows = []
    with TM.kernel_record() as rec:
        for remat in (False, True):
            cfg = amil.MILConfig(remat=remat)
            model = amil.init_attention_mil(torch.Generator().manual_seed(0),
                                            cfg, device=device)
            opt = steps.make_optimizer(model)
            grad = steps.make_bag_grad(cfg, compute_dtype=dtype)

            def fwd_only():
                with torch.no_grad():
                    return amil.apply_attention_mil(
                        model, x, 0, cfg, mask=mask, train=True,
                        scores=scores, keep=keep,
                        compute_dtype=dtype)["loss"]

            def fwd_bwd():
                return grad(model, x, mask, 0, scores=scores, keep=keep)

            def full_step():
                fwd_bwd()
                steps.apply_updates(opt, 2e-4)

            if cuda:
                torch.cuda.reset_peak_memory_stats(device)
            t_f = TM.time_ms(fwd_only, device, iters=iters) / 1e3
            t_g = TM.time_ms(fwd_bwd, device, iters=iters) / 1e3
            model.zero_grad(set_to_none=True)
            t_s = TM.time_ms(full_step, device, iters=iters) / 1e3
            peak = (torch.cuda.max_memory_allocated(device) / 1e9 if cuda
                    else None)
            row = {"remat": remat, "fwd_ms": t_f * 1e3,
                   "fwd_bwd_ms": t_g * 1e3, "bwd_over_fwd": t_g / t_f - 1,
                   "step_ms": t_s * 1e3,
                   "trained_tiles_per_s": tiles_per_bag / t_s,
                   "peak_mem_gb": peak}
            rows.append(row)
            if not as_json:
                print(f"  remat={remat}: fwd {t_f*1e3:7.1f} ms | fwd+bwd "
                      f"{t_g*1e3:7.1f} ms (bwd/fwd {t_g/t_f - 1:4.1f}x) | "
                      f"+adam {t_s*1e3:7.1f} ms | "
                      f"{tiles_per_bag/t_s:,.0f} trained tiles/s", flush=True)
            del model, opt
    out = {"train": True, "tiles_per_bag": tiles_per_bag, "res": res,
           "pooled_T": k, "compute_dtype": "bfloat16", "device": device.type,
           "rows": rows, **card, **TM.launches_json(rec)}
    print(json.dumps(out), flush=True)
    return out


def build_argparser():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--iters", type=int, default=6)
    ap.add_argument("--res", type=int, default=300)
    ap.add_argument("--device-calibration", action="store_true")
    ap.add_argument("--train", action="store_true",
                    help="profile the training step instead of the forward")
    ap.add_argument("--tiles-per-bag", type=int, default=512)
    ap.add_argument("--json", action="store_true", help="machine-readable")
    ap.add_argument("--stem", default="cudnn", choices=["cudnn", "kernel"],
                    help="the stem as the forward runs it (cudnn), or the "
                         "uint8 stem kernel (300 px)")
    ap.add_argument("--device", default=None, help="the card unless 'cpu'")
    return ap


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    device = TM.resolve(args.device, "torch_profile_stages")

    if args.device_calibration:
        device_calibration(device)
        return 0
    if args.train:
        profile_train(args.tiles_per_bag, args.res, max(args.iters // 2, 2),
                      device, as_json=args.json)
        return 0

    rows, full_sec, calib, rec, composition_sec = profile_forward(
        args.batch, args.res, args.iters, device, args.stem)
    card = TM.card_record(device)
    total_gf = sum(r[2] for r in rows)
    seg_sum = sum(r[1] for r in rows)

    if args.json:
        print(json.dumps({
            "batch": args.batch, "res": args.res, "stem": args.stem,
            "segments": [{"name": n, "sec": s, "gflops": g, "tflops": t,
                          "share_of_calibration": t / calib}
                         for n, s, g, t in rows],
            "full_sec": full_sec, "seg_sum_sec": seg_sum,
            "full_tflops": total_gf / full_sec / 1e3,
            "full_share_of_calibration": total_gf / full_sec / 1e3 / calib,
            "tiles_per_sec": args.batch / full_sec,
            "stem_composition_sec": composition_sec,
            "calibration_tflops": calib, "device": device.type,
            **card, **TM.launches_json(rec)}), flush=True)
        return 0

    print(f"\nResNet-26 forward profile  batch={args.batch} res={args.res} "
          f"stem={args.stem} device={device} {card['card']}, "
          f"{card['power_limit']}")
    print(f"{'segment':>9} {'ms':>9} {'GFLOP':>9} {'TFLOP/s':>9} {'share':>7}"
          f" {'of calib':>8}")
    for name, sec, gf, tf in rows:
        print(f"{name:>9} {sec * 1e3:9.2f} {gf:9.2f} {tf:9.2f} "
              f"{sec / seg_sum * 100:6.1f}% {tf / calib * 100:7.2f}%")
    print(f"{'SUM':>9} {seg_sum * 1e3:9.2f} {total_gf:9.2f} "
          f"{total_gf / seg_sum / 1e3:9.2f}")
    print(f"{'FULL':>9} {full_sec * 1e3:9.2f} {total_gf:9.2f} "
          f"{total_gf / full_sec / 1e3:9.2f}   "
          f"({args.batch / full_sec:,.0f} tiles/s; segment sum "
          f"{(seg_sum - full_sec) * 1e3:+.2f} ms vs the whole forward)")
    if composition_sec is not None:
        print(f"the stem's composition (kernel, cast, LeakyReLU, max-pool): "
              f"{composition_sec * 1e3:.2f} ms")
    print(f"calibration: {calib:.1f} TFLOP/s bf16 (chained products)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
