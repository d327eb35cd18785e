"""On-card smoke run of the PyTorch/CUDA port (one NVIDIA H100).

    python3 chip_smoke.py

Builds every CUDA kernel of the serving path from the sources in this
checkout (the gated-attention pool and the fused uint8 stem, one ``nvcc``
each, in parallel; the stem's SASS must hold tensor-core instructions),
holds each against its plain PyTorch version on the card (the pool also
at the edges of its partition of T, and bit-identical over two calls),
drives full-width slide
serving (``classify_slide`` and ``classify_slide_streaming``) on synthetic
slides written and cached by the port's own RoiBuilder, serves a manifest
of slides through the serving daemon (``train.serve.main``) from a
checkpoint the port wrote, serves the streaming slide through the uint8
stem (``transform_extract``), checks the outputs, and times the paths with
CUDA events, the host -> card staging, and the kernels with torch.profiler's
device durations (each row says where its device time came from), with an
interleaved stem A/B against cuDNN. A kernel's device time is per call,
summed over the CUDA launches of the call (the pool makes two above
``gated_pool.POOL_RANGE`` tiles); its launch counts are wrapper calls that
reached the kernel. Progress (and the daemon's own
prints) goes to stderr; results go to stdout as JSON lines, each timing
beside the card's name and power limit. The second-to-last line lists the
kernels, the last line is the device record.

Exits non-zero, with no result, when there is no CUDA device, when the
port's package is not beside this file, or when any phase fails. Slides,
caches, the checkpoint and the daemon's outputs are written under
``.smoke_cache/`` in the checkout and deleted at the end. Imports nothing
of JAX.
"""

import concurrent.futures
import contextlib
import csv
import functools
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.data import (  # noqa: E402
    roibuilder,
    slide_io,
    transforms,
)
from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.models import (  # noqa: E402
    attention_mil as amil,
    resnet,
)
from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.ops import (  # noqa: E402
    _build,
    gated_pool,
    u8_stem,
)
from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.ops import (  # noqa: E402
    nn as N,
)
from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.parallel import (  # noqa: E402
    inference,
)
from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.train import (  # noqa: E402
    checkpoint,
    serve,
)

PORT = "deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch"
JAX_PKG = "deep_convolutional_neural_network_resnet_26_and_attention_network_tpu"
CACHE = os.path.join(ROOT, ".smoke_cache")
HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
F32_OPS_PER_S = 67e12          # H100 SXM data sheet, non-tensor float32
BF16_OPS_PER_S = 989e12        # H100 SXM data sheet, dense bf16 tensor cores
# the stem kernel against its plain version: the issue's batch sizes and
# the main path's (the streaming slide's 1024-tile chunks and 904-tile tail)
STEM_B = (1, 8, 64, 904, 1024)
STEM_CONVENTIONS = ((1 / 255.0, 0.0), (2 / 255.0, -1.0))
SERVE_ALPHA, SERVE_BETA = 2 / 255.0, -1.0   # data/transforms.py's normalize
STEM_AB_TILES = 1024
# synthetic slides: name -> (raster rows, cols, roi px, white tiles, pool of
# distinct tissue tiles). 2000 tiles go through the one-pass path; 5000
# stream in 1024-tile chunks; the roi-1200 slide runs the live 1200 -> 300
# anti-aliased resize. Both paths run at the slide's exact tile count.
SLIDES = {"onepass": (45, 45, 300, 25, 32),
          "stream": (71, 71, 300, 41, 32),
          "roi1200": (3, 3, 1200, 1, 4)}
# four small slides (200 tiles) for the daemon's --batch 4
SMALL_SLIDES = {f"small{i}": (15, 15, 300, 25, 16) for i in range(4)}


def tile_count(spec):
    rows, cols, _, n_background, _ = spec
    return rows * cols - n_background


# every bag the main path pools is one slide's exact tile count, serial or
# in a --batch group; the kernel is held to plain at each of them, and at
# a few more (a bag below a warp, K=5/O=2, 2048-2560, a 50k-tile slide,
# and the edges of the kernel's partition of T into ranges)
MAIN_PATH_T = sorted({tile_count(s) for s in (*SLIDES.values(),
                                              *SMALL_SLIDES.values())})
_R = gated_pool.POOL_RANGE
POOL_SHAPES = [(t, 3, 1) for t in MAIN_PATH_T] + [
    (64, 3, 1), (100, 3, 1), (7, 5, 2), (2048, 3, 1), (2560, 3, 1),
    (50000, 3, 1), (_R - 1, 3, 1), (_R, 3, 1), (_R + 1, 3, 1),
    (2 * _R + 1, 3, 1), (2 * _R + 1, 5, 2)]
# two calls on the same inputs at this T must give bit-identical outputs
POOL_REPEAT_T = 50000
# timed: the one-pass slide (the kernels line), the streaming slide, and a
# 50k-tile slide
POOL_TIMED_T = (2000, 5000, 50000)
KERNELS = ("gated_pool", "u8_stem")


def tensor_core_instructions(lib):
    """The count of HMMA and HGMMA instructions in a built library's SASS
    (``cuobjdump -sass``, from the toolkit beside ``nvcc``)."""
    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", lib], capture_output=True,
                          text=True, timeout=120, check=True).stdout
    return len(re.findall(r"\bHG?MMA\.", sass))


def log(msg):
    print(f"[chip_smoke] {msg}", file=sys.stderr, flush=True)


def emit(obj):
    print(json.dumps(obj), flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0].strip()


# ---------------------------------------------------------------- phase 2
def pool_inputs(t, k, o, seed, all_masked=False):
    g = torch.Generator().manual_seed(seed)
    a_raw = torch.randn((t, k), generator=g)
    b = torch.randn((t, o), generator=g)
    mask = (torch.rand(t, generator=g) > 0.3).float()
    if all_masked:
        mask.zero_()
    wm = torch.randn((k,), generator=g)
    return [x.cuda() for x in (a_raw, b, mask, wm)]


def check_pool_kernel():
    """Kernel vs plain on the card, f32, at every listed shape."""
    worst = 0.0
    cases = [(s, False) for s in POOL_SHAPES] + [((2048, 3, 1), True)]
    for i, ((t, k, o), all_masked) in enumerate(cases):
        args = pool_inputs(t, k, o, seed=100 + i, all_masked=all_masked)
        got = gated_pool.gated_attention_pool(*args)
        torch.cuda.synchronize()
        want = gated_pool.gated_attention_pool_reference(*args)
        errs = [float((g - w).abs().max()) for g, w in zip(got, want)]
        ok = errs[0] <= 1e-5 and errs[1] <= 1e-6 and errs[2] <= 1e-6
        emit({"phase": "pool_kernel_vs_plain", "T": t, "K": k, "O": o,
              "all_masked": all_masked, "err_M": errs[0], "err_A1T": errs[1],
              "err_wROIs": errs[2], "tol_M": 1e-5, "tol_A1T_wROIs": 1e-6,
              "ok": ok})
        if not ok:
            raise AssertionError(f"gated_pool kernel disagrees at {t, k, o}")
        worst = max(worst, *errs)
    args = pool_inputs(POOL_REPEAT_T, 3, 1, seed=99)
    first = gated_pool.gated_attention_pool(*args)
    second = gated_pool.gated_attention_pool(*args)
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(first, second))
    emit({"phase": "pool_repeat", "T": POOL_REPEAT_T,
          "nblk": gated_pool.pool_partition(POOL_REPEAT_T)[0],
          "bit_identical": same})
    if not same:
        raise AssertionError("two gated_pool calls on the same inputs differ")
    return worst


def device_ms(fn, iters, match=None, windows=3):
    """Mean device time of one call of ``fn`` from torch.profiler over
    ``iters`` calls, host time between launches excluded. With ``match``,
    the device activities whose name holds it: for each such kernel name,
    its mean duration times its launches per call (its records over
    ``iters``, rounded, at least 1), summed over the names, so a call of
    two launches counts both. Without, the sum of all device activities
    over ``iters``. The profiler on the H100 host now and then records a
    launch short, or a whole window empty: a short window still gives each
    name's mean over what it recorded, an empty one is retried, and after
    ``windows`` empty windows the time comes from CUDA events instead
    (``time_cuda``, which includes launch gaps).

    Returns ``(ms, how)``; ``how`` says where the number came from, and is
    printed beside it: ``source`` ("profiler" or "cuda_events"),
    ``records`` (the device activities recorded; with ``match``, the
    launches), ``calls`` (``iters``) and, with ``match``,
    ``launches_per_call`` (records over calls)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(windows):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        by_name = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA and (match is None
                                                     or match in e.name):
                by_name.setdefault(e.name, []).append(
                    e.time_range.end - e.time_range.start)
        records = sum(len(v) for v in by_name.values())
        if records:
            how = {"source": "profiler", "records": records, "calls": iters}
            if match is None:
                return sum(map(sum, by_name.values())) / 1e3 / iters, how
            how["launches_per_call"] = records / iters
            per_call = 0.0
            for nm, spans in by_name.items():
                per_call += (sum(spans) / len(spans)
                             * max(1, round(len(spans) / iters)))
                if len(spans) % iters:
                    log(f"profiler: {len(spans)} records of {nm[:60]} for "
                        f"{iters} calls")
            return per_call / 1e3, how
        log(f"profiler: no device activity {match or ''} in a window of "
            f"{iters} calls; retrying")
    log(f"profiler: {windows} empty windows; timing {match or 'the calls'} "
        "with CUDA events instead")
    how = {"source": "cuda_events", "records": 0, "calls": iters}
    if match is not None:
        how["launches_per_call"] = None
    return time_cuda(fn, iters), how


def ms_how(how, prefix="ms"):
    """``device_ms``'s provenance as row keys: ``<prefix>_source``,
    ``<prefix>_records``, ``<prefix>_calls``."""
    return {f"{prefix}_{k}": v for k, v in how.items()}


def time_cuda(fn, iters):
    """Mean ms per call of ``fn`` over ``iters`` back-to-back calls, by CUDA
    events, after a warm-up."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def pool_bound_ms(t, k, o):
    """Least time on the card: each input read once, each output written
    once, over the memory rate; or the float32 operations (softplus ~4,
    gate 3, normalise 1, pool and heat 2*O+1 per (t, k)) over the peak."""
    bytes_moved = 4 * (t * k + t * o + t + k) + 4 * (k * o + 2 * k * t)
    ops = t * k * (8 + 2 * o + 1)
    by_bytes, by_ops = bytes_moved / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return 1e3 * max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops
                                         else "operations")


def time_pool(card):
    """At each timed T: the kernel's device time (``ms``, from the
    profiler, so no host time enters it) and the plain version's
    (``plain_device_ms``, all its kernels together); per call by CUDA events
    over back-to-back calls, which includes what the host adds: raw ctypes
    launches (``host_ms``), the checked wrapper (``wrapper_ms``, what the
    serving path pays) and the plain version (``plain_ms``). The floor a
    latency-bound kernel can reach: the device time of one launch that
    does nearly nothing (a one-element fill), times the pool's launches
    per call (``floor_ms``)."""
    rows = {}
    fn = gated_pool._kernel()
    tiny = torch.zeros(1, device="cuda")
    launch_floor, how_floor = device_ms(tiny.zero_, 200)
    for t in POOL_TIMED_T:
        args = pool_inputs(t, 3, 1, seed=7)
        nblk, tiles = gated_pool.pool_partition(t)
        outs = [args[0].new_empty(s) for s in ((3, 1), (3, t), (3, t),
                                               (3, nblk, 2))]
        ptrs = [x.data_ptr() for x in args + outs]
        stream = torch.cuda.current_stream().cuda_stream

        def raw():
            return fn(*ptrs, t, 3, 1, tiles, nblk, stream)

        def plain():
            return gated_pool.gated_attention_pool_reference(*args)

        ms, how = device_ms(raw, 200, match="gated_pool_")
        host_ms = time_cuda(raw, 500)
        n = gated_pool.LAUNCHES
        wrapper_ms = time_cuda(
            lambda: gated_pool.gated_attention_pool(*args), 200)
        gated_pool.LAUNCHES = n  # timing launches are not the main path's
        plain_device, how_plain = device_ms(plain, 50)
        plain_ms = time_cuda(plain, 200)
        bound, bound_by = pool_bound_ms(t, 3, 1)
        floor = launch_floor * (1 if nblk == 1 else 2)
        rows[t] = {"ms": ms, **ms_how(how), "nblk": nblk,
                   "floor_ms": floor, **ms_how(how_floor, "floor_ms"),
                   "host_ms": host_ms,
                   "wrapper_ms": wrapper_ms, "plain_ms": plain_ms,
                   "plain_device_ms": plain_device,
                   **ms_how(how_plain, "plain_device_ms"),
                   "bound_ms": bound, "bound_by": bound_by,
                   "bound_share": bound / ms}
        emit({"phase": "pool_time", "T": t, "K": 3, "O": 1, "nblk": nblk,
              "kernel_device_us": 1e3 * ms, **ms_how(how),
              "kernel_host_us": 1e3 * host_ms,
              "wrapper_us": 1e3 * wrapper_ms, "plain_us": 1e3 * plain_ms,
              "plain_device_us": 1e3 * plain_device,
              **ms_how(how_plain, "plain_device_ms"), "bound_us": 1e3 * bound,
              "bound_by": bound_by, "bound_share": bound / ms,
              "floor_us": 1e3 * floor, "library_us": None, **card})
    return rows


def stem_tiles(b, seed, device):
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.randint(0, 256, (b, 300, 300, 3), dtype=torch.uint8,
                         device=device, generator=g)


def check_stem_kernel(conv1):
    """Kernel vs plain on the card at every B of STEM_B, both normalize
    conventions: max|diff| <= 1e-4 x max|ref|. Both sides form exact
    float32 products of bf16 operands, so only the order of the sums
    differs. Then the wrapper refuses, on the card, what the kernel does
    not take, launching nothing. Returns the worst absolute error."""
    worst = 0.0
    dev = conv1.weight.device
    for i, b in enumerate(STEM_B):
        x = stem_tiles(b, 200 + i, dev)
        for alpha, beta in STEM_CONVENTIONS:
            got = u8_stem.stem_u8_conv(conv1, x, alpha=alpha, beta=beta)
            torch.cuda.synchronize()
            want = u8_stem.stem_u8_conv_reference(conv1, x, alpha=alpha,
                                                  beta=beta)
            err = float((got - want).abs().max())
            scale = float(want.abs().max())
            ok = tuple(got.shape) == tuple(want.shape) and err <= 1e-4 * scale
            emit({"phase": "stem_kernel_vs_plain", "B": b, "alpha": alpha,
                  "beta": beta, "max_abs_err": err, "max_abs_ref": scale,
                  "rel_err": err / scale, "tol_rel": 1e-4, "ok": ok})
            if not ok:
                raise AssertionError(f"u8_stem kernel disagrees at B={b}, "
                                     f"alpha={alpha}, beta={beta}")
            worst = max(worst, err)
            del got, want
    z = functools.partial(torch.zeros, device=dev)
    cases = {"float32 tiles": (conv1, z((1, 300, 300, 3))),
             "299 px tiles": (conv1, z((1, 299, 299, 3), dtype=torch.uint8)),
             "conv1 with 16 outputs": (torch.nn.Conv2d(3, 16, 7, 2, 3,
                                                       device=dev),
                                       z((1, 300, 300, 3), dtype=torch.uint8)),
             "no tiles": (conv1, z((0, 300, 300, 3), dtype=torch.uint8))}
    n = u8_stem.LAUNCHES
    refused = []
    for name, (c, x) in cases.items():
        try:
            u8_stem.stem_u8_conv(c, x, alpha=1.0, beta=0.0)
        except ValueError:
            refused.append(name)
    emit({"phase": "stem_rejections", "refused": refused,
          "launched": u8_stem.LAUNCHES - n})
    if len(refused) != len(cases) or u8_stem.LAUNCHES != n:
        raise AssertionError("the u8_stem wrapper took an input it must "
                             "refuse")
    return worst


def stem_bound_ms(b):
    """Least time on the card for the stem of b tiles: the uint8 input,
    weights and bias read once and the float32 output written once, over
    the memory rate; or its 2 x 22,500 x 20 x 147 operations a tile over
    the bf16 tensor-core peak (its operands are bf16)."""
    bytes_moved = (b * 300 * 300 * 3 + 4 * (20 * 147 + 20)
                   + 4 * b * 150 * 150 * 20)
    ops = 2 * b * 150 * 150 * 20 * 147
    by_bytes, by_ops = bytes_moved / HBM_BYTES_PER_S, ops / BF16_OPS_PER_S
    return 1e3 * max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops
                                         else "operations")


def stem_ab(cnn, card, rounds=4, iters=5):
    """The counterpart of tools/exp_stem_pallas.py on the card, at
    STEM_AB_TILES uint8 tiles, in interleaved rounds (A B B A): the stem
    alone (cuDNN conv of the normalized bf16 input, LeakyReLU, max-pool vs
    the kernel, LeakyReLU, max-pool) and the whole extractor
    (``apply_resnet26`` vs ``u8_stem_extract``). Then the kernel's row: its
    device time from torch.profiler, its bound, the plain version's time
    and the library yardstick, cuDNN's ``F.conv2d`` on the normalized bf16
    input (the stem conv the default serving path runs; the kernel path
    never calls it)."""
    b = STEM_AB_TILES
    bf = torch.bfloat16
    x = stem_tiles(b, 300, cnn.conv1.weight.device)
    kw = {"alpha": SERVE_ALPHA, "beta": SERVE_BETA}

    def stem_cudnn():
        return cnn._stem(transforms.normalize_u8(x), bf, "conv7")

    def stem_kernel():
        h = u8_stem.stem_u8_conv(cnn.conv1, x, **kw).to(bf)
        return F.max_pool2d(N.leaky_relu(h.permute(0, 3, 1, 2)), 3, 2, 1)

    def full_cudnn():
        return resnet.apply_resnet26(cnn, transforms.normalize_u8(x),
                                     compute_dtype=bf)

    def full_kernel():
        return u8_stem.u8_stem_extract(cnn, x, compute_dtype=bf, **kw)

    variants = {"stem/cudnn": stem_cudnn, "stem/kernel": stem_kernel,
                "full/cudnn": full_cudnn, "full/kernel": full_kernel}
    n = u8_stem.LAUNCHES
    with torch.no_grad():
        d_stem = float((stem_kernel().float() - stem_cudnn().float())
                       .abs().max())
        ref = full_cudnn().float()
        d_full = float((full_kernel() - ref).abs().max()) / float(
            ref.abs().max())
        del ref
        times = {k: [] for k in variants}
        for r in range(rounds):
            order = list(variants) if r % 2 == 0 else list(reversed(variants))
            for name in order:
                times[name].append(time_cuda(variants[name], iters))
    med = {k: statistics.median(v) for k, v in times.items()}
    emit({"phase": "stem_ab", "tiles": b, "rounds": rounds,
          "iters_per_round": iters, "ms": med,
          "tiles_per_s": {k: b / (v / 1e3) for k, v in med.items()},
          "kernel_over_cudnn_stem": med["stem/cudnn"] / med["stem/kernel"],
          "kernel_over_cudnn_full": med["full/cudnn"] / med["full/kernel"],
          "stem_max_abs_diff_bf16": d_stem, "features_rel_diff": d_full,
          "all_ms": times, **card})

    conv1 = cnn.conv1
    with torch.no_grad():
        def kernel():
            return u8_stem.stem_u8_conv(conv1, x, **kw)

        def plain():
            return u8_stem.stem_u8_conv_reference(conv1, x, **kw)

        xn = transforms.normalize_u8(x).to(bf).permute(0, 3, 1, 2)
        w, bias = conv1.weight.to(bf), conv1.bias.to(bf)

        def library():
            return F.conv2d(xn, w, bias, stride=2, padding=3)

        ms, how = device_ms(kernel, 10, match="u8_stem_kernel")
        wrapper_ms = time_cuda(kernel, 10)
        plain_ms = time_cuda(plain, 5)
        plain_device, how_plain = device_ms(plain, 3)
        library_ms = time_cuda(library, 10)
        library_device, how_library = device_ms(library, 10)
    u8_stem.LAUNCHES = n  # timing launches are not the main path's
    bound, bound_by = stem_bound_ms(b)
    row = {"ms": ms, **ms_how(how), "wrapper_ms": wrapper_ms,
           "plain_ms": plain_ms, "plain_device_ms": plain_device,
           **ms_how(how_plain, "plain_device_ms"), "bound_ms": bound,
           "bound_by": bound_by, "bound_share": bound / ms,
           "library_ms": library_ms, "library_device_ms": library_device,
           **ms_how(how_library, "library_device_ms")}
    emit({"phase": "stem_time", "B": b, **row, **card})
    return row


# ---------------------------------------------------------------- phase 3
def synthetic_slide(path, rows, cols, roi, n_background, seed, n_pool=32):
    """An H&E-like slide on a raster of rows x cols tiles of ``roi`` px:
    tissue tiles drawn from a pool of purple noise tiles, ``n_background``
    white ones, sized so that the RoiBuilder raster is exactly the grid."""
    rng = np.random.default_rng(seed)
    base = rng.integers([120, 40, 150], [160, 80, 190], (n_pool, 1, 1, 3))
    pool = np.clip(base + rng.integers(-40, 40, (n_pool, roi, roi, 3)), 0,
                   255).astype(np.uint8)
    pool = np.concatenate([pool, np.full((1, roi, roi, 3), 245, np.uint8)])
    idx = rng.integers(0, n_pool, rows * cols)
    idx[rng.choice(rows * cols, n_background, replace=False)] = n_pool
    img = np.full((rows * roi + 2, cols * roi + 2, 3), 245, np.uint8)
    img[:rows * roi, :cols * roi] = pool[idx].reshape(
        rows, cols, roi, roi, 3).transpose(0, 2, 1, 3, 4).reshape(
            rows * roi, cols * roi, 3)
    return slide_io.write_synthetic_slide(path, img)


def write_slide(name, seed, spec):
    rows, cols, roi, n_background, n_pool = spec
    return synthetic_slide(os.path.join(CACHE, f"{name}_H&E.npy"), rows,
                           cols, roi, n_background, seed, n_pool)


def built(name, seed):
    rows, cols, roi, n_background, n_pool = SLIDES[name]
    t0 = time.perf_counter()
    path = write_slide(name, seed, SLIDES[name])
    builder = roibuilder.RoiBuilder(path, {"roi_size": roi})
    builder.build()
    want = rows * cols - n_background
    if builder.getsize() != want:
        raise AssertionError(f"{name}: {builder.getsize()} tiles, want {want}")
    log(f"slide {name}: {want} tiles at roi {roi}, written and cached in "
        f"{time.perf_counter() - t0:.1f} s")
    return builder


def check_probs(name, probs, n_classes):
    if probs.shape != (n_classes,) or not np.all(np.isfinite(probs)) \
            or abs(float(probs.sum()) - 1.0) > 1e-5:
        raise AssertionError(f"{name}: bad probabilities {probs}")


def drive(name, fn, builder):
    """One run of a serving path with the launch count read around it."""
    gated_pool.LAUNCHES = 0
    probs, outs, coords = fn()
    torch.cuda.synchronize()
    launches = gated_pool.LAUNCHES
    if launches < 1:
        raise AssertionError(f"{name}: the gated_pool kernel never launched")
    T = builder.getsize()
    if outs["Aterm"].shape != (3, T) or coords.shape != (T, 2):
        raise AssertionError(f"{name}: outputs not trimmed to T={T}")
    return probs, launches


def timed(fn, repeats=3):
    secs = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    return statistics.median(secs)


def trace(path, fn, card):
    """One call under torch.profiler: the union of the card's activity
    intervals (kernels, copies, sets) against the call's traced wall time
    gives the card's idle share; the top device activities by total time
    say what the busy part is. Reports None where the trace holds no
    device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    busy_us, end, by_name = 0.0, float("-inf"), {}
    for s, e, nm in spans:
        busy_us += max(0.0, e - max(s, end))
        end = max(end, e)
        by_name[nm] = by_name.get(nm, 0.0) + (e - s)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    busy = busy_us / 1e6 if spans else None
    emit({"phase": "trace", "path": path, "traced_wall_s": wall,
          "device_busy_s": busy,
          "device_idle_share": None if busy is None else 1.0 - busy / wall,
          "device_activities": len(spans),
          "top_device_ms": [[nm[:90], t / 1e3] for nm, t in top], **card})


def host_staging(builder, card, chunk=1024, passes=3):
    """The host side of the streaming slide's way to the card, over its
    ``chunk``-tile chunks, median of ``passes``: the copy off the cache's
    memory map into a fresh array per chunk (``np.array``, what the
    streaming loop did before ``data/loader.staged_chunks``) against the
    copy into a reused pinned buffer (what it does now), and the copy to
    the card from pageable against pinned memory."""
    raw = np.load(builder.params["data_cache"], mmap_mode="r")
    T = raw.shape[0]
    starts = range(0, T, chunk)
    pinned = torch.empty((chunk,) + raw.shape[1:], dtype=torch.uint8,
                         pin_memory=True)
    pageable = torch.from_numpy(np.zeros(tuple(pinned.shape), np.uint8))

    def copy_fresh():
        for s in starts:
            np.array(raw[s:s + chunk])

    def copy_pinned():
        for s in starts:
            n = min(chunk, T - s)
            np.copyto(pinned.numpy()[:n], raw[s:s + n])

    def to_card(src, non_blocking):
        def run():
            for s in starts:
                src[:min(chunk, T - s)].to("cuda", non_blocking=non_blocking)
            torch.cuda.synchronize()
        return run

    cases = {"copy_fresh_array_s": copy_fresh,
             "copy_reused_pinned_s": copy_pinned,
             "h2d_pageable_s": to_card(pageable, False),
             "h2d_pinned_s": to_card(pinned, True)}
    out = {}
    for key, fn in cases.items():
        secs = []
        for _ in range(passes):
            t0 = time.perf_counter()
            fn()
            secs.append(time.perf_counter() - t0)
        out[key] = statistics.median(secs)
    emit({"phase": "host_staging", "tiles": T, "chunk": chunk,
          "bytes": int(raw.nbytes), **out, **card})


def read_rows(out_root):
    with open(os.path.join(out_root, "results.csv")) as f:
        return {r["name"]: r for r in csv.DictReader(f)}


def row_probs(row):
    return np.array([float(row[f"prob_{k}"]) for k in range(3)])


def daemon_phase(model, cfg, slides, card):
    """The serving daemon on the card: the seeded model saved with the
    port's checkpoint writer, a manifest of ``slides`` ((name, path)
    pairs), ``serve.main([... "--manifest", ..., "--once", "--ckpt", ...])``.
    Checks: one pool launch per slide served; each results.csv row equals a
    direct ``classify_slide_streaming`` call (within the CSV's 6-decimal
    rounding); a second ``--once`` serves nothing; ``--batch 4`` agrees
    with serial within 1e-3 in bf16 and, on the small slides, within 1e-5
    in f32 with TF32 off. Times the daemon with ``--io_depth 1`` and 0 in
    interleaved runs (1, 0, 0, 1) once the caches exist. Returns the pool
    launches of the main-path run."""
    root = os.path.join(CACHE, "daemon")
    os.makedirs(root)
    ckpt = checkpoint.save(checkpoint.checkpoint_path(root, 0), model)

    def manifest(fname, names):
        path = os.path.join(root, fname)
        with open(path, "w") as f:
            f.write("".join(p + "\n" for _, p in slides if key(p) in names))
        return path

    def key(path):  # the daemon's slide name: the file's basename
        return os.path.split(path)[1].split(".")[0]

    all_names = [key(p) for _, p in slides]
    small = [key(p) for nm, p in slides if nm in SMALL_SLIDES]
    m_all, m_small = manifest("all.txt", all_names), manifest("small.txt",
                                                              small)

    def run(out, mfile, *extra):
        argv = ["--manifest", mfile, "--out_root", os.path.join(root, out),
                "--ckpt", ckpt, "--roi_size", "300", "--resolution", "300",
                "--chunk", "1024", "--settle_secs", "0", "--once", *extra]
        with contextlib.redirect_stdout(sys.stderr):
            t0 = time.perf_counter()
            rc = serve.main(argv)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        if rc != 0:
            raise AssertionError(f"serve.main({argv}) returned {rc}")
        return read_rows(os.path.join(root, out)), wall

    # the main path: builds the small slides' caches (native filter),
    # serves every slide, one pool launch each
    gated_pool.LAUNCHES = 0
    rows, wall_first = run("serial", m_all, "--io_depth", "1")
    torch.cuda.synchronize()
    launches = gated_pool.LAUNCHES
    if sorted(rows) != sorted(all_names) or launches != len(all_names):
        raise AssertionError(f"daemon served {sorted(rows)} with {launches} "
                             "pool launches")
    gated_pool.LAUNCHES = 0
    rows_again, _ = run("serial", m_all)
    if len(rows_again) != len(all_names) or gated_pool.LAUNCHES != 0:
        raise AssertionError("a second --once run served a slide again")

    d_direct, tiles = 0.0, {}
    for path in (p for _, p in slides):
        nm = key(path)
        builder = roibuilder.RoiBuilder(path, {"roi_size": 300})
        probs, outs, _ = inference.classify_slide_streaming(
            model, cfg, builder, resolution=300, chunk=1024,
            compute_dtype=torch.bfloat16)
        row = rows[nm]
        tiles[nm] = builder.getsize()
        d_direct = max(d_direct, float(np.abs(row_probs(row) - probs).max()))
        if (int(row["pred"]) != int(outs["y_pred_hat"])
                or int(row["ntiles"]) != builder.getsize()):
            raise AssertionError(f"daemon row for {nm} differs: {row}")
    # each slide's bag, serial or batched, is pooled at its tile count
    unchecked = {nm: t for nm, t in tiles.items() if t not in MAIN_PATH_T}
    if unchecked:
        raise AssertionError("the daemon pooled bags whose size the pool "
                             f"kernel was not held to plain at: {unchecked}")

    rows_b, _ = run("batch4", m_all, "--batch", "4")
    d_batch_bf16 = max(float(np.abs(row_probs(rows_b[nm])
                                    - row_probs(rows[nm])).max())
                       for nm in all_names)
    rows_f32, _ = run("serial_f32", m_small, "--f32")
    rows_bf32, _ = run("batch4_f32", m_small, "--f32", "--batch", "4")
    d_batch_f32 = max(float(np.abs(row_probs(rows_bf32[nm])
                                   - row_probs(rows_f32[nm])).max())
                      for nm in small)
    emit({"phase": "daemon_checks", "slides": len(all_names),
          "pool_launches": launches, "pool_T": sorted(set(tiles.values())),
          "second_once_rows": len(rows_again),
          "rows_vs_direct_streaming": d_direct, "tol_direct": 1e-5,
          "batch4_vs_serial_bf16": d_batch_bf16, "tol_bf16": 1e-3,
          "batch4_vs_serial_f32": d_batch_f32, "tol_f32": 1e-5})
    if d_direct > 1e-5 or d_batch_bf16 > 1e-3 or d_batch_f32 > 1e-5:
        raise AssertionError("the daemon's results disagree beyond "
                             "tolerance")

    walls = {"1": [], "0": []}
    for i, depth in enumerate(("1", "0", "0", "1")):
        _, wall = run(f"io{depth}_{i}", m_all, "--io_depth", depth)
        walls[depth].append(wall)
    total = sum(tiles.values())
    emit({"phase": "daemon_time", "compute_dtype": "bfloat16",
          "tiles": tiles, "per_slide_s": {nm: float(rows[nm]["secs"])
                                          for nm in all_names},
          "first_run_wall_s": wall_first,
          "io_depth_1_wall_s": walls["1"], "io_depth_0_wall_s": walls["0"],
          "io_depth_1_tiles_per_s": total / statistics.median(walls["1"]),
          "io_depth_0_tiles_per_s": total / statistics.median(walls["0"]),
          **card})
    return launches


def serve_u8_stem(model, cfg, big, p_big, p32_big, card):
    """The streaming slide through the uint8 stem (``transform_extract``):
    one stem launch per chunk, one pool launch, probabilities within 1e-3
    of the cuDNN bf16 path and the f32 path (the bf16 contract,
    BASELINE.md:32). Returns (stem launches, pool launches)."""
    ext = functools.partial(u8_stem.u8_stem_extract, alpha=SERVE_ALPHA,
                            beta=SERVE_BETA, compute_dtype=torch.bfloat16)

    def fn():
        return inference.classify_slide_streaming(
            model, cfg, big, resolution=300, chunk=1024,
            compute_dtype=torch.bfloat16, transform_extract=ext)

    u8_stem.LAUNCHES = 0
    gated_pool.LAUNCHES = 0
    probs, outs, coords = fn()
    torch.cuda.synchronize()
    stem_launches, pool_launches = u8_stem.LAUNCHES, gated_pool.LAUNCHES
    T = big.getsize()
    chunks = -(-T // 1024)
    check_probs("u8_stem streaming", probs, cfg.n_classes)
    d_cudnn = float(np.abs(probs - p_big).max())
    d_f32 = float(np.abs(probs - p32_big).max())
    emit({"phase": "serve_u8_stem", "tiles": T, "chunks": chunks,
          "stem_launches": stem_launches, "pool_launches": pool_launches,
          "probs": probs.tolist(), "vs_cudnn_bf16": d_cudnn,
          "vs_f32": d_f32, "tol": 1e-3})
    if (stem_launches != chunks or pool_launches != 1
            or outs["Aterm"].shape != (3, T) or coords.shape != (T, 2)):
        raise AssertionError("the uint8-stem path did not launch one stem "
                             "kernel per chunk and one pool")
    if d_cudnn > 1e-3 or d_f32 > 1e-3:
        raise AssertionError("the uint8-stem path misses the bf16 contract")
    n_stem, n_pool = u8_stem.LAUNCHES, gated_pool.LAUNCHES
    s_u8 = timed(fn)
    emit({"phase": "serve_u8_stem_time", "tiles": T, "seconds": s_u8,
          "tiles_per_s": T / s_u8, **card})
    trace("classify_slide_streaming u8_stem", fn, card)
    u8_stem.LAUNCHES, gated_pool.LAUNCHES = n_stem, n_pool
    return stem_launches, pool_launches


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device; this script runs on the card")
    name, limit = [s.strip() for s in card_line().split(",", 1)]
    card = {"card": name, "power_limit": limit}
    print(f"{name}, {limit}", flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    emit({"phase": "setup", "torch": torch.__version__,
          "cuda": torch.version.cuda, "device": torch.cuda.get_device_name(0),
          "cudnn.allow_tf32": torch.backends.cudnn.allow_tf32,
          "cuda.matmul.allow_tf32": torch.backends.cuda.matmul.allow_tf32})

    # phase 1: build every kernel of the path from the checkout's sources
    t0 = time.perf_counter()
    shutil.rmtree(_build.BUILD_DIR, ignore_errors=True)
    with concurrent.futures.ThreadPoolExecutor(len(KERNELS)) as pool:
        libs = dict(zip(KERNELS, pool.map(_build.build, KERNELS)))
    build_s = time.perf_counter() - t0
    for kernel, text in _build.BUILD_LOG.items():
        log(f"nvcc {kernel}:\n{text.strip()}")
    hmma = tensor_core_instructions(libs["u8_stem"])
    emit({"phase": "build", "kernels": sorted(_build.BUILD_LOG),
          "seconds": build_s, "u8_stem_tensor_core_sass": hmma})
    if hmma < 1:
        raise AssertionError("the u8_stem kernel has no tensor-core "
                             "(HMMA/HGMMA) instruction")

    # phase 2: each kernel against its plain version, on the card
    cfg = amil.MILConfig()
    model = amil.init_attention_mil(torch.Generator().manual_seed(0), cfg)
    max_err = check_pool_kernel()
    stem_err = check_stem_kernel(model.cnn.conv1)

    # phase 3: full-width serving on synthetic slides
    os.makedirs(CACHE, exist_ok=True)
    os.environ["CACHE_DIR"] = CACHE
    try:
        one, big, hi = (built(nm, seed) for seed, nm in enumerate(SLIDES))

        def onepass(builder, dtype=torch.bfloat16):
            return lambda: inference.classify_slide(
                model, cfg, builder, resolution=300, compute_dtype=dtype)

        def streaming(builder, dtype=torch.bfloat16):
            return lambda: inference.classify_slide_streaming(
                model, cfg, builder, resolution=300, chunk=1024,
                compute_dtype=dtype)

        launches = {}
        p_one, launches["classify_slide"] = drive(
            "classify_slide", onepass(one), one)
        p_big, launches["classify_slide_streaming"] = drive(
            "classify_slide_streaming", streaming(big), big)
        p_hi, launches["classify_slide_roi1200"] = drive(
            "classify_slide roi 1200", onepass(hi), hi)
        for nm, p in (("onepass", p_one), ("streaming", p_big),
                      ("roi1200", p_hi)):
            check_probs(nm, p, cfg.n_classes)
        emit({"phase": "serve_bf16", "launches": launches,
              "probs_onepass": p_one.tolist(),
              "probs_streaming": p_big.tolist(),
              "probs_roi1200": p_hi.tolist()})

        # f32 (TF32 off) one-pass vs streaming, and bf16 vs f32
        p32_one, _ = drive("classify_slide f32", onepass(one, None), one)
        p32_str, _ = drive("classify_slide_streaming f32",
                           streaming(one, None), one)
        p32_big, _ = drive("classify_slide_streaming f32 5000 tiles",
                           streaming(big, None), big)
        d_paths = float(np.abs(p32_one - p32_str).max())
        d_bf16 = max(float(np.abs(p_one - p32_one).max()),
                     float(np.abs(p_big - p32_big).max()))
        emit({"phase": "serve_checks", "f32_streaming_vs_onepass": d_paths,
              "tol_paths": 1e-5, "bf16_vs_f32": d_bf16, "tol_bf16": 1e-3})
        if d_paths > 1e-5 or d_bf16 > 1e-3:
            raise AssertionError("serving paths disagree beyond tolerance")

        # small-input reference: the card's f32 bag forward vs the CPU's
        tiles = transforms.eval_transform(
            torch.from_numpy(np.load(one.params["data_cache"],
                                     mmap_mode="r")[:8].copy()),
            resolution=300)
        cpu_model = amil.AttentionMIL(cfg, device="cpu")
        cpu_model.load_state_dict(model.state_dict())
        out_cpu = amil.apply_attention_mil(cpu_model, tiles, 1, cfg)
        out_gpu = amil.apply_attention_mil(model, tiles.cuda(), 1, cfg)
        d_ref = float((out_gpu["y_pred"].cpu() - out_cpu["y_pred"]).abs().max())
        d_att = float((out_gpu["Aterm"].cpu() - out_cpu["Aterm"]).abs().max())
        # CUDA anti-aliased resize vs the CPU one, on the live 1200 -> 300
        raw = np.load(hi.params["data_cache"])
        tx_gpu = transforms.eval_transform(torch.from_numpy(raw).cuda(),
                                           resolution=300).cpu()
        tx_cpu = transforms.eval_transform(torch.from_numpy(raw),
                                           resolution=300)
        d_tx = float((tx_gpu - tx_cpu).abs().max())
        emit({"phase": "reference_checks", "f32_bag_card_vs_cpu_y_pred": d_ref,
              "f32_bag_card_vs_cpu_Aterm": d_att, "tol_bag": 1e-5,
              "eval_transform_card_vs_cpu": d_tx, "tol_transform": 1e-5})
        if d_ref > 1e-5 or d_att > 1e-5 or d_tx > 1e-5:
            raise AssertionError("card disagrees with the CPU reference")

        # phase 4: times
        T_one, T_big = one.getsize(), big.getsize()
        s_one = timed(onepass(one))
        s_big = timed(streaming(big))
        # one-pass breakdown: cache read + H2D + transform, then the model
        s_data = timed(one.get_inference_data)
        bag = one.get_inference_data()[0]
        s_model = timed(lambda: amil.apply_attention_mil(
            model, bag, 0, cfg, compute_dtype=torch.bfloat16))
        del bag
        emit({"phase": "serve_time", "compute_dtype": "bfloat16",
              "onepass_tiles": T_one, "onepass_s": s_one,
              "onepass_tiles_per_s": T_one / s_one,
              "onepass_data_s": s_data, "onepass_model_s": s_model,
              "streaming_tiles": T_big, "streaming_s": s_big,
              "streaming_tiles_per_s": T_big / s_big,
              "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
              **card})
        trace("classify_slide", onepass(one), card)
        trace("classify_slide_streaming", streaming(big), card)
        pool_times = time_pool(card)
        host_staging(big, card)

        # the serving daemon over a manifest: the two roi-300 slides above
        # and four small ones whose caches the daemon builds itself
        slides = [("onepass", one.params["fullpath"]),
                  ("stream", big.params["fullpath"])]
        slides += [(nm, write_slide(nm, 10 + i, spec))
                   for i, (nm, spec) in enumerate(SMALL_SLIDES.items())]
        launches["serve_daemon"] = daemon_phase(model, cfg, slides, card)

        # the streaming slide through the uint8 stem kernel
        stem_launches, launches["classify_slide_streaming_u8_stem"] = \
            serve_u8_stem(model, cfg, big, p_big, p32_big, card)
        stem_row = stem_ab(model.cnn, card)
    finally:
        shutil.rmtree(CACHE, ignore_errors=True)

    t_main = POOL_TIMED_T[0]
    print(f"{name}, {limit}", flush=True)
    emit({"kernels": [{
        "name": "gated_attention_pool", "route": "cuda",
        "source": f"{PORT}/csrc/gated_pool.cu",
        "replaces": f"{JAX_PKG}/ops/pallas_pool.py:43",
        "launches": sum(launches.values()), "max_abs_err": max_err,
        **pool_times[t_main], "library_ms": None,
        "shape": {"T": t_main, "K": 3, "O": 1},
        "ms_by_T": {t: r["ms"] for t, r in pool_times.items()},
        "bound_share_by_T": {t: r["bound_share"]
                             for t, r in pool_times.items()},
        "launches_by_path": launches}, {
        "name": "stem_u8_conv", "route": "cuda",
        "source": f"{PORT}/csrc/u8_stem.cu",
        "replaces": f"{JAX_PKG}/ops/pallas_stem.py:69",
        "launches": stem_launches, "max_abs_err": stem_err, **stem_row,
        "shape": {"B": STEM_AB_TILES, "H": 300, "W": 300, "C": 3},
        "launches_by_path": {"classify_slide_streaming_u8_stem":
                             stem_launches}}]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
