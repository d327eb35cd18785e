"""On-card smoke run of the PyTorch/CUDA port (one NVIDIA H100).

    python3 chip_smoke.py

Builds every CUDA kernel of the serving and training paths from the
sources in this checkout (the gated-attention pool, forward and backward,
and the fused uint8 stem, one ``nvcc`` each, in parallel; the stem's SASS
must hold tensor-core instructions, and ptxas must report no spill for
the pool's forward and backward kernels), holds each against its plain
PyTorch version on the card (the pool also at the edges of its
partitions of T, the forward's paths and the backward's cluster sizes
included, and bit-identical over two calls),
drives full-width slide
serving (``classify_slide`` and ``classify_slide_streaming``) on synthetic
slides written and cached by the port's own RoiBuilder, serves a manifest
of slides through the serving daemon (``train.serve.main``) from a
checkpoint the port wrote, serves the streaming slide through the uint8
stem (``transform_extract``), checks the outputs, and times the paths with
CUDA events, the host -> card staging, and the kernels with torch.profiler's
device durations (each row says where its device time came from), with an
interleaved stem A/B against cuDNN. Then it trains at full width in bf16
through the trainer's CLI (``train.classify.main``: two epochs of one
5-bag Adam window on a six-slide cohort reusing the serving slides'
caches, validation at epoch 0), resumes epoch 1 from the epoch-0
checkpoint in a fresh process and compares, runs ``--test_only``, holds a
full-width f32 bag gradient on the card to the CPU's with the same
injected noise, and times a training bag (data and model), a window, the
peak memory with and without ``--remat``, a traced window's idle share and
the pool's backward kernel. Then the trainer's serving and
instrumentation modes from the trained checkpoint: ``--interface`` on the
training cohort in bf16 and f32 (its tables against direct calls, a timed
and a traced run); the AOT tier (the checkpoint through the reference's
pickle format and back, bit-identical; a bf16 and an f32 bundle exported
through ``deploy.py``, loaded in a fresh process that builds no model,
``chip_smoke.py --bundle-child``, with the model code poisoned and held to
the live path; ``serve --bundle``; the pool's forward through its
``torch.library`` op); W8A8 ``--int8`` (every conv site of the full-width
int8 forward exact by each of its three lowerings against a float64
convolution on the CPU, the slide-probability drift from bf16 and f32,
the daemon with ``--int8`` behind a tile-less slide, ``--interface
--int8``, and the int8 extractor against the bf16 one); ``--profile
--tensorboard`` for one epoch; ``data/build_caches.py --workers 2``
against the RoiBuilder's caches; and the (slides, tiles) mesh: the pool's
split entries against the one-call kernel, a world of one over NCCL
against the single-card path (and its streaming rate beside the live
pass's), two ranks on the card over gloo against the world of one (at
300 px against the one card's step with the ResNet on the same row
halves), and ``classify --mesh 1`` / ``serve --mesh 1`` on a launched
rank over NCCL (training, a ``--ckpt auto`` resume, ``--test_only``, the
daemon serially, with ``--batch 4`` and with ``--int8``) against the same
CLI runs on the card. Before the mesh, the auxiliary modules (``aux``, f32
with TF32 off): the interpretability kit through the epoch-1 checkpoint's
extractor on a 300 px tile (Grad-CAM at the five taps, guided Grad-CAM,
guided backprop and its layer variant, vanilla backprop, grad x image,
integrated gradients, smooth-grad, the four optimisers), the saliency of
the head's logit with respect to the 2000-tile slide's features (the
pool's forward and backward kernels, every launch held to the plain pool),
the torchvision-template resnet18 / resnet34, the WAE, the LatentUNet and
its cluster layer at the reference's sizes, each against the same modules
on the CPU (ill-conditioned float32 results against the CPU's float64),
the cost of the port's LeakyReLU under autograd against PyTorch's, and
the stain and cell datasets on files the script writes (Pillow and the
``csv`` module: the card's machine has no cv2 and no pandas). After the
GAN's step costs, the cost of its LeakyReLU(0.2) with the JAX package's
derivative at 0 against PyTorch's (32 and 512 px). Then ``learn``: the
port's convergence tools (``tools/torch_convergence_run.py``, the
full-width classifier for 30 epochs at 300 px, whose last train loss
must be below its first and whose held-out slide accuracy must be 1.0,
its pool launches counted and a sample held to the plain pool; and
``tools/torch_gan_convergence_run.py``, the full-width StyleGAN at 8 px
in f32, which must meet the band-distance criteria, and in bf16,
recorded; and the bf16 serving contract on the classifier just trained:
each held-out slide through ``classify_slide_streaming`` in bf16 and
f32, the gap below 1e-3). Then ``examples``: the JAX walkthrough's eight steps through
the port's CLIs (``examples/torch_full_pipeline_demo.py``) in this
process on the card, their artifacts, the pool's launches in each step
(a sample held to the plain pool) and the live driver's checkpoint
against the CPU. Then ``tools``: the port's measuring tools
(``tools/torch_*.py``), each in its own process with a time limit, the
card's health probe alone and the others five at a time side by side
(they check paths there; their times are not measurements): the
ResNet-26 per-stage profile (every segment at
most 1.05 of the bf16 calibration taken in its process), the training
step's decomposition at 500 tiles, the GAN's pieces, one full-width
1024 px d+g step pair (finite losses, its peak memory), the serving
sweep, and the twins of the last JAX experiment tools (the extractor's
K x B sweep with both stems, the daemon's ``--io_depth`` A/B on cold
slides, a cohort of distinct tile counts with and without ``--prewarm``,
the GAN tool across one resolution transition); their pool and stem
launches join the kernels line, and every T they pooled must be one
phase 2 held to the plain pool. After ``gan_parity``, the StyleGAN's
``instance_norm`` against its formula written out, bit for bit (output
and gradient, every norm of the 8 and 512 px generator, f32 and bf16
autocast). In the mesh
phase, ``comm_audit``: every collective of
the world of one's window step recorded (``tools/torch_comm_audit.py``)
and held to the port's pins (no collective: a group of one rank issues
none), its call time printed beside run F3's (PERF.md), and the audit's
six families on two gloo ranks on the card held to the pins the CPU test
holds.
``chip_smoke.py --mesh-cards N``, on a machine with
N cards, runs only the mesh's checks with one rank a card over NCCL,
then the CLIs with ``--mesh N``. A kernel's device time is per call,
summed over the CUDA launches of the call (each entry of the pool's
forward and backward makes one, which the profiler must see); its launch
counts are wrapper calls that reached the kernel. Progress (and the
daemon's own prints) goes to stderr; results go to stdout as JSON lines, each timing
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
import copy
import csv
import dataclasses
import filecmp
import functools
import gc
import glob
import io
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch import (  # noqa: E402
    _device,
    deploy,
)
from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.data import (  # noqa: E402
    build_caches,
    dataset,
    loader,
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
    quant,
    u8_stem,
)
from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.ops import (  # noqa: E402
    nn as N,
)
from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.parallel import (  # noqa: E402
    inference,
    shard_pool,
    steps,
)
from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.parallel import (  # noqa: E402
    mesh as mesh_mod,
)
from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.train import (  # noqa: E402
    checkpoint,
    classify,
    classify_legacy,
    gan,
    gan_generate,
    serve,
)
from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.data import (  # noqa: E402
    gan_dataset,
)
from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.models import (  # noqa: E402
    stylegan as sg,
)
from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.utils import (  # noqa: E402
    helpers,
)
from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.interpret import (  # noqa: E402
    gradcam,
    guided,
    misc,
    optimize,
    saliency,
)
from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.models import (  # noqa: E402
    alt_resnet,
    unet,
    wae,
)
from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.data import (  # noqa: E402
    cell_datasets,
    stain,
)
from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.utils import (  # noqa: E402
    interop,
    torch_interop,
)
from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.data import (  # noqa: E402
    tissue,
)
from tools import torch_comm_audit  # noqa: E402
from tools import torch_exp_serve_hetero  # noqa: E402

PORT = "deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch"
JAX_PKG = "deep_convolutional_neural_network_resnet_26_and_attention_network_tpu"
CACHE = os.path.join(ROOT, ".smoke_cache")
HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
F32_OPS_PER_S = 67e12          # H100 SXM data sheet, non-tensor float32
BF16_OPS_PER_S = 989e12        # H100 SXM data sheet, dense bf16 tensor cores
F32_EPS = torch.finfo(torch.float32).eps
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
# the training cohort: six slides in the GHP_<n>_<x>_H&E.scn convention,
# each reusing a serving slide's tile cache (the 5000-tile one twice, so
# whichever slide fold 0 holds out, a bag above the 2500-tile cap trains),
# with their clusters for the csv label sheet
TRAIN_COHORT = {"GHP_1_A": ("stream", "A"), "GHP_2_B": ("stream", "B"),
                "GHP_3_C": ("onepass", "C"), "GHP_5_E": ("small0", "A"),
                "GHP_6_F": ("small1", "B"), "GHP_7_G": ("small2", "C")}
TRAIN_ROI = 300
TRAIN_ARGS = ["--roi_size", str(TRAIN_ROI), "--resolution", "300",
              "--accum", "5", "--fold", "0", "--seed", "0"]


def tile_count(spec):
    rows, cols, _, n_background, _ = spec
    return rows * cols - n_background


_SPECS = {**SLIDES, **SMALL_SLIDES}
# a training bag pools the 20 % subsample of at most 2500 tiles
TRAIN_POOL_T = sorted({
    max(1, int(min(tile_count(_SPECS[src]), roibuilder.TRAIN_TILE_CAP)
               * amil.MILConfig().train_tile_fraction))
    for src, _ in TRAIN_COHORT.values()})
# every bag the main paths pool is one slide's exact tile count, serial or
# in a --batch group, a training bag's subsample, or a tile-less slide's
# zero bag (the int8 daemon serves one); the kernel is held to
# plain at each of them, and at a few more (a bag below a warp, K=5/O=2,
# O=9 (more columns than a pass of the kernel's sums takes), 2047-2560,
# 4097, a 50k-tile slide, and each crossover of the forward's partition
# of T, -1..+2)
# the measuring tools' phase (tools_phase): torch_profile_stages --train
# pools its bag's subsample forward and backward, torch_exp_serve's
# slides pool whole
TOOLS_TRAIN_BAG = 500
TOOLS_SERVE_TILES = 64
TOOLS_BWD_T = {max(1, int(TOOLS_TRAIN_BAG
                          * amil.MILConfig().train_tile_fraction))}
TOOLS_POOL_T = TOOLS_BWD_T | {TOOLS_SERVE_TILES}
MAIN_PATH_T = sorted({tile_count(s) for s in _SPECS.values()}
                     | set(TRAIN_POOL_T) | {roibuilder.EMPTY_BAG_TILES})
# the T at which gated_pool.pool_fwd_partition changes its path, its
# cluster size or its rounds a thread (FWD_EDGES), and their neighbours
POOL_FWD_CROSS = sorted({e + d for e in gated_pool.FWD_EDGES
                         for d in (-1, 0, 1, 2)})
POOL_SHAPES = [(t, 3, 1) for t in MAIN_PATH_T] + [
    (64, 3, 1), (100, 3, 1), (7, 5, 2), (2048, 3, 1), (2560, 3, 1),
    (50000, 3, 1), (2047, 3, 1), (2049, 3, 1), (4097, 3, 1), (4097, 5, 2),
    (2000, 5, 2), (50000, 5, 2), (2000, 3, 9), (50000, 3, 9)] + [
    (t, 3, 1) for t in POOL_FWD_CROSS]
# the tools' pooled T not listed above, appended so that every case above
# keeps its seed (a case's seed is its index)
POOL_SHAPES += [(t, 3, 1) for t in sorted(TOOLS_POOL_T)
                if (t, 3, 1) not in POOL_SHAPES]
# all-masked bags: one on each path of the forward
POOL_MASKED_T = (2048, 50000)
# the last twins in the tools phase: the io twin's cold slides (every tile
# of its tissue-coloured noise passes the filter) and the hetero twin's
# cohort, each slide pooled whole; held after the masked bags, so that
# every earlier case keeps its seed
TOOLS_IO = {"n": 3, "px": 2000, "roi": 300}
TOOLS_HETERO_MAX = 31
TOOLS_LATE_T = ({len(tissue.sliding_window(
    (TOOLS_IO["px"], TOOLS_IO["px"], 3), TOOLS_IO["roi"]))}
    | set(torch_exp_serve_hetero.cohort_sizes(TOOLS_HETERO_MAX)))
POOL_LATE_SHAPES = [(t, 3, 1) for t in sorted(TOOLS_LATE_T)
                    if (t, 3, 1) not in POOL_SHAPES]
# two calls on the same inputs at this T (and at each of POOL_FWD_CROSS)
# must give bit-identical outputs
POOL_REPEAT_T = 50000
# timed: the one-pass slide (the kernels line), the streaming slide, and a
# 50k-tile slide
POOL_TIMED_T = (2000, 5000, 50000)
# the T at which the backward's partition (gated_pool.pool_bwd_partition)
# changes its cluster size
POOL_BWD_EDGES = [t for t in range(1, 4 * gated_pool.BWD_CLUSTERS[-1][0])
                  if gated_pool.pool_bwd_partition(t)[0]
                  != gated_pool.pool_bwd_partition(t + 1)[0]]
# the backward kernel against its plain version: one tile, a few bag sizes,
# the edges of the forward's partition of T, a two-rank shard of a training
# subsample (250), the edges of the backward's cluster sizes +-1, a 50k-tile
# bag and every training bag's subsample, all at K = 3, O = 1; and a few at
# K = 5, O = 2 (two passes over the maps, a B of two columns)
POOL_BWD_T = sorted({1, 200, 250, 500, 2047, 2048, 2049, 4097, 50000}
                    | set(TRAIN_POOL_T)
                    | {e + d for e in POOL_BWD_EDGES for d in (-1, 0, 1, 2)})
POOL_BWD_SHAPES = ([(t, 3, 1) for t in POOL_BWD_T]
                   + [(7, 5, 2), (500, 5, 2), (POOL_BWD_EDGES[0] + 1, 5, 2),
                      (4097, 5, 2)])
POOL_BWD_SHAPES += [(t, 3, 1) for t in sorted(TOOLS_BWD_T)
                    if (t, 3, 1) not in POOL_BWD_SHAPES]
# timed: every training bag's subsample (the kernels line: the largest) and
# a 50k-tile bag
POOL_BWD_TIMED_T = (40, 400, 500, 50000)
KERNELS = ("gated_pool", "u8_stem")
# the AOT bundles' tile bound: above the 5000-tile streaming slide
BUNDLE_TILES = 8192


def ptxas_report(log, match):
    """The ptxas lines (registers, shared memory, stack and spills) of each
    kernel of a build log whose name holds ``match``: ``{name: lines}``."""
    report, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1) if match in m.group(1) else None
            if name:
                report[name] = []
        elif name and ("registers" in line or "spill" in line
                       or "stack frame" in line):
            report[name].append(line.strip())
    return report


def require_no_spill(report):
    """Fail unless every kernel of a ptxas report spills 0 bytes."""
    spills = {nm: ln for nm, lines in report.items() for ln in lines
              if re.search(r"[1-9]\d* bytes spill (stores|loads)", ln)}
    if not report or spills:
        raise AssertionError(f"ptxas: spills or no report: {spills or report}")


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
def pool_inputs(t, k, o, seed, all_masked=False, device="cuda"):
    g = torch.Generator().manual_seed(seed)
    a_raw = torch.randn((t, k), generator=g)
    b = torch.randn((t, o), generator=g)
    mask = (torch.rand(t, generator=g) > 0.3).float()
    if all_masked:
        mask.zero_()
    wm = torch.randn((k,), generator=g)
    return [x.to(device) for x in (a_raw, b, mask, wm)]


def check_pool_kernel():
    """Kernel vs plain on the card, f32, at every listed shape."""
    worst = 0.0
    cases = ([(s, False) for s in POOL_SHAPES]
             + [((t, 3, 1), True) for t in POOL_MASKED_T]
             + [(s, False) for s in POOL_LATE_SHAPES])
    for i, ((t, k, o), all_masked) in enumerate(cases):
        args = pool_inputs(t, k, o, seed=100 + i, all_masked=all_masked)
        got = gated_pool.gated_attention_pool(*args)
        torch.cuda.synchronize()
        want = gated_pool.gated_attention_pool_reference(*args)
        errs = [float((g - w).abs().max()) for g, w in zip(got, want)]
        ok = errs[0] <= 1e-5 and errs[1] <= 1e-6 and errs[2] <= 1e-6
        if all_masked:  # every output is 0 exactly
            ok = ok and not any(bool(x.any()) for x in got)
        emit({"phase": "pool_kernel_vs_plain", "T": t, "K": k, "O": o,
              "cut": gated_pool.pool_fwd_partition(t),
              "all_masked": all_masked, "err_M": errs[0], "err_A1T": errs[1],
              "err_wROIs": errs[2], "tol_M": 1e-5, "tol_A1T_wROIs": 1e-6,
              "ok": ok})
        if not ok:
            raise AssertionError(f"gated_pool kernel disagrees at {t, k, o}")
        worst = max(worst, *errs)
    for t in sorted({POOL_REPEAT_T, *POOL_FWD_CROSS}):
        args = pool_inputs(t, 3, 1, seed=99)
        first = gated_pool.gated_attention_pool(*args)
        second = gated_pool.gated_attention_pool(*args)
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(first, second))
        emit({"phase": "pool_repeat", "T": t,
              "cut": gated_pool.pool_fwd_partition(t), "bit_identical": same})
        if not same:
            raise AssertionError(f"two gated_pool calls at T={t} on the "
                                 "same inputs differ")
    return worst


PROFILE_PAD = 256  # spin kernels launched before and after a window's calls
PAD_KERNEL = "spin_kernel"  # torch.cuda._sleep's kernel


def profile_window(fn, iters):
    """The card's activities over ``iters`` calls of ``fn`` under
    torch.profiler, as ``{kernel name: [durations in us]}``. The profiler
    on the H100 host loses a run of records at a window's edges (up to
    half of 200 short calls), so the calls sit between PROFILE_PAD spin
    kernels on either side, whose records are dropped here."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILE_PAD):
            torch.cuda._sleep(1)
        for _ in range(iters):
            fn()
        for _ in range(PROFILE_PAD):
            torch.cuda._sleep(1)
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name.setdefault(e.name, []).append(
                e.time_range.end - e.time_range.start)
    pads = [nm for nm in by_name if PAD_KERNEL in nm]
    if by_name and not pads:
        raise AssertionError(f"no {PAD_KERNEL} among the profiler's kernels "
                             f"{sorted(by_name)[:4]}: the padding would be "
                             "timed")
    for nm in pads:
        del by_name[nm]
    return by_name


def device_ms(fn, iters, match=None, windows=3):
    """Mean device time of one call of ``fn`` from torch.profiler over
    ``iters`` calls (:func:`profile_window`), host time between launches
    excluded. With ``match``, the device activities whose name holds it:
    for each such kernel name, its mean duration times its launches per
    call (its records over ``iters``, rounded, at least 1), summed over the
    names, so a call of two launches counts both. Without, the sum of all
    device activities over ``iters``. The profiler on the H100 host now and
    then records a window short, by a few launches or by half of them, or
    records nothing: a window that recorded nothing, or (with ``match``) a
    name short of a whole number of launches a call, is taken again, up to
    ``windows`` windows, and the fullest is used; after
    ``windows`` empty windows the time comes from CUDA events instead
    (``time_cuda``, which includes launch gaps).

    Returns ``(ms, how)``; ``how`` says where the number came from, and is
    printed beside it: ``source`` ("profiler" or "cuda_events"),
    ``records`` (the device activities recorded; with ``match``, the
    launches), ``calls`` (``iters``), ``windows`` (the windows taken) and,
    with ``match``, ``launches_per_call`` (records over calls)."""
    fn()
    torch.cuda.synchronize()
    best, taken = {}, 0
    for taken in range(1, windows + 1):
        by_name = {nm: spans for nm, spans in profile_window(fn, iters).items()
                   if match is None or match in nm}
        records = sum(map(len, by_name.values()))
        if records > sum(map(len, best.values())):
            best = by_name
        short = [nm for nm, spans in by_name.items() if len(spans) % iters]
        if records and (match is None or not short):
            break
        for nm in short:
            log(f"profiler: {len(by_name[nm])} records of {nm[:60]} for "
                f"{iters} calls")
        if not records:
            log(f"profiler: no device activity {match or ''} in a window "
                f"of {iters} calls")
    records = sum(map(len, best.values()))
    if records:
        how = {"source": "profiler", "records": records, "calls": iters,
               "windows": taken}
        if match is None:
            return sum(map(sum, best.values())) / 1e3 / iters, how
        how["launches_per_call"] = records / iters
        per_call = sum(sum(spans) / len(spans)
                       * max(1, round(len(spans) / iters))
                       for spans in best.values())
        return per_call / 1e3, how
    log(f"profiler: {windows} empty windows; timing {match or 'the calls'} "
        "with CUDA events instead")
    how = {"source": "cuda_events", "records": 0, "calls": iters,
           "windows": taken}
    if match is not None:
        how["launches_per_call"] = None
    return time_cuda(fn, iters), how


def ms_how(how, prefix="ms"):
    """``device_ms``'s provenance as row keys: ``<prefix>_source``,
    ``<prefix>_records``, ``<prefix>_calls``, ``<prefix>_windows``."""
    return {f"{prefix}_{k}": v for k, v in how.items()}


def time_cuda(fn, iters, warmup=3):
    """Mean ms per call of ``fn`` over ``iters`` back-to-back calls, by CUDA
    events, after ``warmup`` calls."""
    for _ in range(warmup):
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
    does nearly nothing (a one-element fill), the pool's one launch a call
    (``floor_ms``), which the profiler must see at every T."""
    rows = {}
    fn = gated_pool._kernel()
    tiny = torch.zeros(1, device="cuda")
    launch_floor, how_floor = device_ms(tiny.zero_, 200)
    for t in POOL_TIMED_T:
        args = pool_inputs(t, 3, 1, seed=7)
        ints = gated_pool._fwd_shape(args[0], args[1])
        cut = gated_pool.pool_fwd_partition(t)
        outs = [args[0].new_empty(s) for s in ((3, 1), (3, t), (3, t),
                                               (cut[1], 3, 2))]
        ptrs = [x.data_ptr() for x in args + outs]
        stream = torch.cuda.current_stream().cuda_stream

        def raw():
            return fn(*ptrs, *ints, stream)

        def plain():
            return gated_pool.gated_attention_pool_reference(*args)

        ms, how = device_ms(raw, 200, match="gated_pool_")
        require_one_launch("gated_pool_forward", t, how)
        host_ms = time_cuda(raw, 500)
        n = gated_pool.LAUNCHES
        wrapper_ms = time_cuda(
            lambda: gated_pool.gated_attention_pool(*args), 200)
        gated_pool.LAUNCHES = n  # timing launches are not the main path's
        plain_device, how_plain = device_ms(plain, 50)
        plain_ms = time_cuda(plain, 200)
        bound, bound_by = pool_bound_ms(t, 3, 1)
        floor = launch_floor
        rows[t] = {"ms": ms, **ms_how(how), "cut": cut,
                   "floor_ms": floor, **ms_how(how_floor, "floor_ms"),
                   "host_ms": host_ms,
                   "wrapper_ms": wrapper_ms, "plain_ms": plain_ms,
                   "plain_device_ms": plain_device,
                   **ms_how(how_plain, "plain_device_ms"),
                   "bound_ms": bound, "bound_by": bound_by,
                   "bound_share": bound / ms}
        emit({"phase": "pool_time", "T": t, "K": 3, "O": 1, "cut": cut,
              "kernel_device_us": 1e3 * ms, **ms_how(how),
              "kernel_host_us": 1e3 * host_ms,
              "wrapper_us": 1e3 * wrapper_ms, "plain_us": 1e3 * plain_ms,
              "plain_device_us": 1e3 * plain_device,
              **ms_how(how_plain, "plain_device_ms"), "bound_us": 1e3 * bound,
              "bound_by": bound_by, "bound_share": bound / ms,
              "floor_us": 1e3 * floor, "library_us": None, **card})
    return rows


def pool_backward_case(t, seed, only_dm, all_masked, k=3, o=1):
    """Inputs, the kernel's forward A1T and the cotangents of one backward
    case on the card (dA1T and dwROIs None with ``only_dm``, the training
    path's pattern)."""
    args = pool_inputs(t, k, o, seed, all_masked=all_masked)
    g = torch.Generator().manual_seed(seed + 1)
    cots = [torch.randn((k, o), generator=g)] + [
        None if only_dm else torch.randn((k, t), generator=g)
        for _ in range(2)]
    a1t = gated_pool.gated_attention_pool(*args)[1]
    return args, a1t, [None if c is None else c.cuda() for c in cots]


def check_pool_backward():
    """The backward kernel vs its plain version on the card, at every shape
    of POOL_BWD_SHAPES, with all three cotangents random and with only dM,
    with part of the mask zero and with all of it zero: max error per
    output <= 1e-5 x max|ref|. Then two calls at T = 50000 must be
    bit-identical. Returns the worst absolute error."""
    worst = 0.0
    n_fwd, n_bwd = gated_pool.LAUNCHES, gated_pool.BWD_LAUNCHES
    for i, (t, k, o) in enumerate(POOL_BWD_SHAPES):
        for only_dm in (False, True):
            for all_masked in (False, True):
                args, a1t, cots = pool_backward_case(t, 300 + i, only_dm,
                                                     all_masked, k, o)
                got = gated_pool.gated_attention_pool_backward(
                    *args, a1t, *cots)
                torch.cuda.synchronize()
                want = gated_pool.gated_attention_pool_backward_reference(
                    *args, a1t, *cots)
                errs = [float((g - w).abs().max()) for g, w in zip(got, want)]
                refs = [float(w.abs().max()) for w in want]
                ok = all(e <= 1e-5 * r for e, r in zip(errs, refs))
                emit({"phase": "pool_backward_vs_plain", "T": t, "K": k,
                      "O": o, "cluster": gated_pool.pool_bwd_partition(t)[0],
                      "cotangents": "dM" if only_dm else "all",
                      "mask": "zero" if all_masked else "part",
                      "err_dA_raw": errs[0], "err_dB": errs[1],
                      "err_dw": errs[2], "max_abs_ref": refs,
                      "tol_rel": 1e-5, "ok": ok})
                if not ok:
                    raise AssertionError(
                        f"gated_pool backward kernel disagrees at T={t}, "
                        f"K={k}, O={o}, only_dm={only_dm}, "
                        f"all_masked={all_masked}")
                worst = max(worst, *errs)
    args, a1t, cots = pool_backward_case(POOL_REPEAT_T, 99, False, False)
    first = gated_pool.gated_attention_pool_backward(*args, a1t, *cots)
    second = gated_pool.gated_attention_pool_backward(*args, a1t, *cots)
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(first, second))
    emit({"phase": "pool_backward_repeat", "T": POOL_REPEAT_T,
          "cluster": gated_pool.pool_bwd_partition(POOL_REPEAT_T)[0],
          "bit_identical": same})
    if not same:
        raise AssertionError("two gated_pool backward calls on the same "
                             "inputs differ")
    # comparison launches are not the main path's
    gated_pool.LAUNCHES, gated_pool.BWD_LAUNCHES = n_fwd, n_bwd
    return worst


def require_one_launch(entry, t, how):
    """Fail unless the profiler saw one launch a call of a pool entry:
    its records over its calls in the fullest of ``device_ms``'s windows,
    rounded, since a window may still record a launch or a few short."""
    per_call = how.get("launches_per_call")
    if per_call is None or round(per_call) != 1:
        raise AssertionError(f"{entry} at T={t}: {per_call} launches a call "
                             "(want 1)")


def pool_bwd_bound_ms(t, k, o):
    """Least time on the card for the training path's backward (dM only):
    A_raw, B, mask, w, A1T and dM read once, dA_raw, dB and dw written
    once, over the memory rate; or its float32 operations (da1 2O, dgated
    2, softplus ~4, sigmoid ~4, dA_raw 3, the four sums 6 per (t, k); dB
    2K per (t, o)) over the peak."""
    bytes_moved = (4 * (t * k + t * o + t + k + k * t + k * o)
                   + 4 * (t * k + t * o + k))
    ops = t * k * (2 * o + 19) + 2 * t * o * k
    by_bytes, by_ops = bytes_moved / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return 1e3 * max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops
                                         else "operations")


def time_pool_backward(card):
    """At each T of POOL_BWD_TIMED_T, with the training path's cotangents
    (dM only): the backward kernel's device time per call (``ms``; its one
    launch a call is required), the plain chain's device time
    (``plain_device_ms``), both per call by CUDA events (``wrapper_ms``,
    ``plain_ms``), the bound, and the floor of a latency-bound call: one
    near-empty launch's device time (a one-element fill, ``floor_ms``)."""
    rows = {}
    n_bwd = gated_pool.BWD_LAUNCHES
    tiny = torch.zeros(1, device="cuda")
    launch_floor, how_floor = device_ms(tiny.zero_, 200)
    for t in POOL_BWD_TIMED_T:
        args, a1t, cots = pool_backward_case(t, 7, True, False)

        def kernel():
            return gated_pool.gated_attention_pool_backward(*args, a1t,
                                                            *cots)

        def plain():
            return gated_pool.gated_attention_pool_backward_reference(
                *args, a1t, *cots)

        ms, how = device_ms(kernel, 200, match="gated_pool_bwd")
        require_one_launch("gated_pool_backward", t, how)
        wrapper_ms = time_cuda(kernel, 200)
        plain_device, how_plain = device_ms(plain, 50)
        plain_ms = time_cuda(plain, 200)
        bound, bound_by = pool_bwd_bound_ms(t, 3, 1)
        floor = launch_floor
        rows[t] = {"ms": ms, **ms_how(how), "wrapper_ms": wrapper_ms,
                   "floor_ms": floor, **ms_how(how_floor, "floor_ms"),
                   "plain_ms": plain_ms, "plain_device_ms": plain_device,
                   **ms_how(how_plain, "plain_device_ms"),
                   "bound_ms": bound, "bound_by": bound_by,
                   "bound_share": bound / ms}
        emit({"phase": "pool_backward_time", "T": t, "K": 3, "O": 1,
              "cluster": gated_pool.pool_bwd_partition(t)[0],
              "kernel_device_us": 1e3 * ms, **ms_how(how),
              "wrapper_us": 1e3 * wrapper_ms, "plain_us": 1e3 * plain_ms,
              "plain_device_us": 1e3 * plain_device,
              **ms_how(how_plain, "plain_device_ms"), "bound_us": 1e3 * bound,
              "bound_by": bound_by, "bound_share": bound / ms,
              "floor_us": 1e3 * floor, "library_us": None, **card})
    gated_pool.BWD_LAUNCHES = n_bwd  # timing launches are not the path's
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
    not take, launching nothing. At each B and convention the pooled
    kernel (``stem_u8_pool``) equals the stem kernel's output cast to
    bf16, LeakyReLU and max-pool 3/2/1 bit for bit, and lies within one
    bf16 ulp of max|ref| of its own plain version
    (``stem_u8_pool_reference``, whose float32 sums differ from the
    kernel's in their order alone). Returns the worst absolute error of
    each kernel, the stem kernel's and the pooled kernel's."""
    worst = worst_pooled = 0.0
    dev = conv1.weight.device
    for i, b in enumerate(STEM_B):
        x = stem_tiles(b, 200 + i, dev)
        for alpha, beta in STEM_CONVENTIONS:
            got = u8_stem.stem_u8_conv(conv1, x, alpha=alpha, beta=beta)
            pooled = u8_stem.stem_u8_pool(conv1, x, alpha=alpha, beta=beta)
            same = torch.equal(pooled, u8_stem.pool_epilogue(got))
            torch.cuda.synchronize()
            want = u8_stem.stem_u8_conv_reference(conv1, x, alpha=alpha,
                                                  beta=beta)
            err = float((got - want).abs().max())
            scale = float(want.abs().max())
            shape_ok = tuple(got.shape) == tuple(want.shape)
            del got, want
            want_p = u8_stem.stem_u8_pool_reference(conv1, x, alpha=alpha,
                                                    beta=beta)
            err_p = float((pooled.float() - want_p.float()).abs().max())
            scale_p = float(want_p.float().abs().max())
            ulp = 2.0 ** (math.floor(math.log2(scale_p)) - 7)
            ok = (shape_ok and tuple(pooled.shape) == tuple(want_p.shape)
                  and err <= 1e-4 * scale and same and err_p <= ulp)
            emit({"phase": "stem_kernel_vs_plain", "B": b, "alpha": alpha,
                  "beta": beta, "max_abs_err": err, "max_abs_ref": scale,
                  "rel_err": err / scale, "tol_rel": 1e-4,
                  "pooled_equals_composition": same,
                  "pooled_max_abs_err": err_p, "pooled_max_abs_ref": scale_p,
                  "pooled_tol_abs": ulp, "ok": ok})
            if not ok:
                raise AssertionError(f"u8_stem kernels disagree at B={b}, "
                                     f"alpha={alpha}, beta={beta}")
            worst, worst_pooled = max(worst, err), max(worst_pooled, err_p)
            del pooled, want_p
    z = functools.partial(torch.zeros, device=dev)
    cases = {"float32 tiles": (conv1, z((1, 300, 300, 3))),
             "299 px tiles": (conv1, z((1, 299, 299, 3), dtype=torch.uint8)),
             "conv1 with 16 outputs": (torch.nn.Conv2d(3, 16, 7, 2, 3,
                                                       device=dev),
                                       z((1, 300, 300, 3), dtype=torch.uint8)),
             "no tiles": (conv1, z((0, 300, 300, 3), dtype=torch.uint8))}
    n = u8_stem.LAUNCHES + u8_stem.POOLED_LAUNCHES
    refused = []
    for name, (c, x) in cases.items():
        for stem in (u8_stem.stem_u8_conv, u8_stem.stem_u8_pool):
            try:
                stem(c, x, alpha=1.0, beta=0.0)
            except ValueError:
                refused.append(f"{stem.__name__}: {name}")
    launched = u8_stem.LAUNCHES + u8_stem.POOLED_LAUNCHES - n
    emit({"phase": "stem_rejections", "refused": refused,
          "launched": launched})
    if len(refused) != 2 * len(cases) or launched:
        raise AssertionError("the u8_stem wrapper took an input it must "
                             "refuse")
    return worst, worst_pooled


def stem_bound_ms(b, pooled=False):
    """Least time on the card for the stem of b tiles: the uint8 input,
    weights and bias read once and the float32 output (``pooled``: the
    bf16 max-pooled [75, 75, 20] a tile) written once, over the memory
    rate; or its 2 x 22,500 x 20 x 147 operations a tile over the bf16
    tensor-core peak (its operands are bf16)."""
    out_bytes = 2 * 75 * 75 * 20 if pooled else 4 * 150 * 150 * 20
    bytes_moved = (b * 300 * 300 * 3 + 4 * (20 * 147 + 20)
                   + b * out_bytes)
    ops = 2 * b * 150 * 150 * 20 * 147
    by_bytes, by_ops = bytes_moved / HBM_BYTES_PER_S, ops / BF16_OPS_PER_S
    return 1e3 * max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops
                                         else "operations")


def stem_ab(cnn, card, rounds=4, iters=5):
    """The counterpart of tools/exp_stem_pallas.py on the card, at
    STEM_AB_TILES uint8 tiles, in interleaved rounds (A B B A): the stem
    alone (cuDNN conv of the normalized bf16 input, LeakyReLU, max-pool vs
    ``stem_u8``, the pooled kernel's one launch, vs the composition it
    replaced: the stem kernel, the cast, LeakyReLU, max-pool) and the
    whole extractor (``ResNet26.forward`` vs ``forward_u8``). Then the
    stem kernel's row: its device time from torch.profiler, its bound, the
    plain version's time and the library yardstick, cuDNN's ``F.conv2d``
    on the normalized bf16 input (the stem conv the default serving path
    ran before the kernels; neither kernel's path calls it); and under
    the pooled kernel's row, its device time beside its bound, the
    composition's and the plain version's. Returns the two rows."""
    b = STEM_AB_TILES
    bf = torch.bfloat16
    x = stem_tiles(b, 300, cnn.conv1.weight.device)
    kw = {"alpha": SERVE_ALPHA, "beta": SERVE_BETA}

    def stem_cudnn():
        return cnn.stem(transforms.normalize_u8(x), compute_dtype=bf)

    def stem_kernel():
        return cnn.stem_u8(x, compute_dtype=bf, **kw)

    def stem_composition():
        return u8_stem.pool_epilogue(u8_stem.stem_u8_conv(cnn.conv1, x, **kw))

    def full_cudnn():
        return resnet.apply_resnet26(cnn, transforms.normalize_u8(x),
                                     compute_dtype=bf)

    def full_kernel():
        return cnn.forward_u8(x, compute_dtype=bf, **kw).float()

    variants = {"stem/cudnn": stem_cudnn, "stem/kernel": stem_kernel,
                "stem/composition": stem_composition,
                "full/cudnn": full_cudnn, "full/kernel": full_kernel}
    n = u8_stem.LAUNCHES, u8_stem.POOLED_LAUNCHES
    with torch.no_grad():
        d_stem = float((stem_kernel().float() - stem_cudnn().float())
                       .abs().max())
        same = torch.equal(stem_kernel().permute(0, 2, 3, 1),
                           stem_composition())
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
          "pooled_over_composition": (med["stem/composition"]
                                      / med["stem/kernel"]),
          "pooled_equals_composition": same,
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

        def pooled():
            return u8_stem.stem_u8_pool(conv1, x, **kw)

        def pooled_plain():
            return u8_stem.stem_u8_pool_reference(conv1, x, **kw)

        ms, how = device_ms(kernel, 10, match="u8_stem_kernel")
        wrapper_ms = time_cuda(kernel, 10)
        plain_ms = time_cuda(plain, 5)
        plain_device, how_plain = device_ms(plain, 3)
        library_ms = time_cuda(library, 10)
        library_device, how_library = device_ms(library, 10)
        p_ms, p_how = device_ms(pooled, 10, match="u8_stem_pool_kernel")
        p_wrapper_ms = time_cuda(pooled, 10)
        composition_ms = time_cuda(stem_composition, 10)
        composition_device, how_composition = device_ms(stem_composition, 10)
        p_plain_ms = time_cuda(pooled_plain, 5)
    # timing launches are not the main path's
    u8_stem.LAUNCHES, u8_stem.POOLED_LAUNCHES = n
    p_bound, p_bound_by = stem_bound_ms(b, pooled=True)
    pooled_row = {"ms": p_ms, **ms_how(p_how), "wrapper_ms": p_wrapper_ms,
                  "bound_ms": p_bound, "bound_by": p_bound_by,
                  "bound_share": p_bound / p_ms,
                  "composition_ms": composition_ms,
                  "composition_device_ms": composition_device,
                  **ms_how(how_composition, "composition_device_ms"),
                  "plain_ms": p_plain_ms}
    emit({"phase": "stem_pool_time", "B": b, **pooled_row, **card})
    bound, bound_by = stem_bound_ms(b)
    row = {"ms": ms, **ms_how(how), "wrapper_ms": wrapper_ms,
           "plain_ms": plain_ms, "plain_device_ms": plain_device,
           **ms_how(how_plain, "plain_device_ms"), "bound_ms": bound,
           "bound_by": bound_by, "bound_share": bound / ms,
           "library_ms": library_ms, "library_device_ms": library_device,
           **ms_how(how_library, "library_device_ms")}
    emit({"phase": "stem_time", "B": b, **row, **card})
    return row, pooled_row


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


def built(name, seed, spec=None):
    spec = spec or SLIDES[name]
    rows, cols, roi, n_background, n_pool = spec
    t0 = time.perf_counter()
    path = write_slide(name, seed, spec)
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
    in bf16 one launch of the pooled stem kernel per chunk and none of the
    stem kernel alone, one pool launch, probabilities within 1e-3 of the
    cuDNN bf16 path and the f32 path (the bf16 contract, BASELINE.md:32).
    Returns the launches of the stem kernel (none), of the pooled stem
    kernel and of the pool."""
    def ext(cnn, x):
        return cnn.forward_u8(x, alpha=SERVE_ALPHA, beta=SERVE_BETA,
                              compute_dtype=torch.bfloat16).float()

    def fn():
        return inference.classify_slide_streaming(
            model, cfg, big, resolution=300, chunk=1024,
            compute_dtype=torch.bfloat16, transform_extract=ext)

    u8_stem.LAUNCHES = u8_stem.POOLED_LAUNCHES = 0
    gated_pool.LAUNCHES = 0
    probs, outs, coords = fn()
    torch.cuda.synchronize()
    stem_launches, pooled_launches, pool_launches = (
        u8_stem.LAUNCHES, u8_stem.POOLED_LAUNCHES, gated_pool.LAUNCHES)
    T = big.getsize()
    chunks = -(-T // 1024)
    check_probs("u8_stem streaming", probs, cfg.n_classes)
    d_cudnn = float(np.abs(probs - p_big).max())
    d_f32 = float(np.abs(probs - p32_big).max())
    emit({"phase": "serve_u8_stem", "tiles": T, "chunks": chunks,
          "stem_launches": stem_launches,
          "stem_pool_launches": pooled_launches,
          "pool_launches": pool_launches,
          "probs": probs.tolist(), "vs_cudnn_bf16": d_cudnn,
          "vs_f32": d_f32, "tol": 1e-3})
    if (pooled_launches != chunks or stem_launches or pool_launches != 1
            or outs["Aterm"].shape != (3, T) or coords.shape != (T, 2)):
        raise AssertionError("the uint8-stem path did not launch one stem "
                             "kernel per chunk and one pool")
    if d_cudnn > 1e-3 or d_f32 > 1e-3:
        raise AssertionError("the uint8-stem path misses the bf16 contract")
    n_pooled, n_pool = u8_stem.POOLED_LAUNCHES, gated_pool.LAUNCHES
    s_u8 = timed(fn)
    emit({"phase": "serve_u8_stem_time", "tiles": T, "seconds": s_u8,
          "tiles_per_s": T / s_u8, **card})
    trace("classify_slide_streaming u8_stem", fn, card)
    u8_stem.POOLED_LAUNCHES, gated_pool.LAUNCHES = n_pooled, n_pool
    return stem_launches, pooled_launches, pool_launches


# ---------------------------------------------------------------- training
def train_cohort(root):
    """The training cohort under ``root``: a placeholder file per slide of
    TRAIN_COHORT (the JAX CLI tests' convention) whose tile cache in
    $CACHE_DIR links to a serving slide's, and a csv cluster sheet. Returns
    the trainer's data flags."""
    slides = os.path.join(root, "slides")
    os.makedirs(slides)
    rows = [["id", ""], ["hdr", "Actual Cluster Designation"]]
    for name, (src, cluster) in TRAIN_COHORT.items():
        with open(os.path.join(slides, f"{name}_H&E.scn"), "wb") as f:
            f.write(b"fake")
        for kind in ("data", "coor"):
            target = os.path.join(
                CACHE, f"{kind}_{src}_H&E_rois_size{TRAIN_ROI}_hsvcut_v3.npy")
            if not os.path.isfile(target):
                raise AssertionError(f"no tile cache for {src}: {target}")
            os.symlink(target, os.path.join(
                CACHE, f"{kind}_{name}_H&E_rois_size{TRAIN_ROI}_hsvcut_v3.npy"))
        rows.append([name, cluster])
    sheet = os.path.join(root, "clusters.csv")
    with open(sheet, "w", newline="") as f:
        csv.writer(f).writerows(rows)
    return ["--data_root", root, "--image_dir", "slides", "--label_sheet",
            sheet]


def run_trainer(argv):
    """``train.classify.main(argv)`` on the card, its prints on stderr."""
    with contextlib.redirect_stdout(sys.stderr):
        rc = classify.main(argv)
    torch.cuda.synchronize()
    if rc != 0:
        raise AssertionError(f"classify.main({argv}) returned {rc}")


def read_summary(run, epoch):
    with open(os.path.join(run, f"{epoch:04d}summary.json")) as f:
        return json.load(f)


def checkpoint_gap(path_a, path_b):
    """The largest difference between two checkpoints' parameters and
    between their Adam moments, beside the largest parameter."""
    a, b = checkpoint.load_raw(path_a), checkpoint.load_raw(path_b)
    if sorted(a) != sorted(b):
        raise AssertionError("the two checkpoints hold different keys")

    def gap(prefix):
        keys = [k for k in a if k.startswith(prefix)]
        return max(float(np.abs(a[k].astype(np.float64) - b[k]).max())
                   for k in keys)

    return {"param_max_abs_diff": gap("classifier/"),
            "param_max_abs": max(float(np.abs(a[k]).max()) for k in a
                                 if k.startswith("classifier/")),
            "moment_max_abs_diff": gap("optimizer/"),
            "bit_identical": all(np.array_equal(a[k], b[k]) for k in a)}


def train_main_path(flags, runs, card):
    """The trainer's CLI at full width, bf16: epochs 0-1 (one 5-bag window
    each, validation at epoch 0) with the pool kernels' launches counted
    and every bag size they pool recorded; then epoch 1 again from the
    epoch-0 checkpoint (``--ckpt auto``) in a fresh process, compared with
    the uninterrupted run; then ``--test_only`` from the epoch-1
    checkpoint. Returns (forward launches, backward launches)."""
    common = [*TRAIN_ARGS, *flags, "--output_root", runs]
    seen = {"forward": set(), "backward": set()}
    real = gated_pool._launch, gated_pool._launch_backward

    def record(fn, key):
        def launch(a_raw, *rest):
            seen[key].add(int(a_raw.shape[0]))
            return fn(a_raw, *rest)
        return launch

    gated_pool._launch = record(real[0], "forward")
    gated_pool._launch_backward = record(real[1], "backward")
    gated_pool.LAUNCHES = gated_pool.BWD_LAUNCHES = 0
    try:
        t0 = time.perf_counter()
        run_trainer(["--tag", "U", "--epoch_start", "0", "--epoch_end", "1",
                     *common])
        wall = time.perf_counter() - t0
    finally:
        gated_pool._launch, gated_pool._launch_backward = real
    fwd, bwd = gated_pool.LAUNCHES, gated_pool.BWD_LAUNCHES
    run_u = os.path.join(runs, "run_U")
    s0 = read_summary(run_u, 0)
    split = next(f for f in os.listdir(run_u)
                 if f.startswith("training_validation_testing_data"))
    with open(os.path.join(run_u, split)) as f:
        train_paths = json.load(f)["train_paths"]
    # each training bag's tiles after the cap, and after the subsample
    bag_tiles = [min(tile_count(_SPECS[TRAIN_COHORT[
        os.path.basename(p).split("_H&E")[0]][0]]),
        roibuilder.TRAIN_TILE_CAP) for p in train_paths]
    cnn_tiles = [max(1, int(t * amil.MILConfig().train_tile_fraction))
                 for t in bag_tiles]
    missing = [k for k in ("train_loss", "train_err", "valid_loss",
                           "valid_acc", "coef_a1", "model_max_weights")
               if k not in s0]
    unchecked = {"forward": sorted(seen["forward"] - set(MAIN_PATH_T)),
                 "backward": sorted(seen["backward"] - set(POOL_BWD_T))}
    emit({"phase": "train_checks", "epochs": [0, 1], "train_bags":
          len(train_paths), "pool_forward_launches": fwd,
          "pool_backward_launches": bwd,
          "pooled_T": {k: sorted(v) for k, v in seen.items()},
          "train_loss_epoch0": s0["train_loss"],
          "valid_loss_epoch0": s0["valid_loss"],
          "input_stall_fraction": s0["input_stall_fraction"],
          "missing_summary_keys": missing, "unchecked_T": unchecked})
    if missing or not (np.isfinite(s0["train_loss"])
                       and np.isfinite(s0["valid_loss"])):
        raise AssertionError(f"epoch 0's summary is not right: {missing}")
    if not os.path.isfile(checkpoint.checkpoint_path(run_u, 1)):
        raise AssertionError("epoch 1 wrote no checkpoint (non-finite loss)")
    if fwd < 1 or bwd != 2 * len(train_paths):
        raise AssertionError(f"pool launches on the training path: forward "
                             f"{fwd}, backward {bwd}")
    if unchecked["forward"] or unchecked["backward"]:
        raise AssertionError("the trainer pooled bags whose size the pool "
                             f"kernels were not held to plain at: {unchecked}")
    emit({"phase": "train_time_epoch0", "compute_dtype": "bfloat16",
          "train_secs": s0["train_secs"], "bag_tiles": bag_tiles,
          "tiles_per_s": sum(bag_tiles) / s0["train_secs"],
          "cnn_tiles_per_s": sum(cnn_tiles) / s0["train_secs"],
          "two_epochs_wall_s": wall, **card})

    # resume epoch 1 from the epoch-0 checkpoint in a fresh process
    run_r = os.path.join(runs, "run_R")
    os.makedirs(run_r)
    shutil.copy(checkpoint.checkpoint_path(run_u, 0), run_r)
    env = dict(os.environ, CACHE_DIR=CACHE,
               PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", f"{PORT}.train.classify", "--tag", "R",
         "--ckpt", "auto", "--epoch_start", "1", "--epoch_end", "1",
         *common], cwd=ROOT, env=env, stdout=sys.stderr, stderr=sys.stderr,
        timeout=600, check=False)
    if proc.returncode != 0:
        raise AssertionError(f"the resumed trainer exited {proc.returncode}")
    gap = checkpoint_gap(checkpoint.checkpoint_path(run_u, 1),
                         checkpoint.checkpoint_path(run_r, 1))
    ok = gap["param_max_abs_diff"] <= 1e-5 * gap["param_max_abs"]
    emit({"phase": "train_resume", **gap, "tol_rel": 1e-5,
          "process_wall_s": time.perf_counter() - t0, "ok": ok})
    if not ok:
        raise AssertionError("the resumed epoch 1 differs from the "
                             "uninterrupted run's beyond tolerance")

    run_trainer(["--tag", "T", "--test_only", "--ckpt",
                 checkpoint.checkpoint_path(run_u, 1), "--epoch_start", "1",
                 *common])
    st = read_summary(os.path.join(runs, "run_T"), 1)
    emit({"phase": "train_test_only", "valid_loss": st["valid_loss"],
          "valid_err": st["valid_err"],
          "valid_eval_mode": st["valid_eval_mode"]})
    if not np.isfinite(st["valid_loss"]) or "valid_acc" not in st:
        raise AssertionError("--test_only gave no finite validation loss")
    return fwd, bwd


GRAD_RES, GRAD_TILES, GRAD_CANDIDATES = 64, 40, 16


def bag_grads(model, tiles, scores, keep):
    """The f32 bag gradient (no compute dtype) with injected noise, as JAX
    parameter paths -> host arrays, and the loss."""
    model.zero_grad(set_to_none=True)
    outs = steps.make_bag_grad(model.cfg)(
        model, tiles, torch.ones(tiles.shape[0], device=tiles.device), 1,
        scores=scores, keep=keep)
    return float(outs["loss"]), checkpoint._flatten(
        interop.jax_params_from_module(model, lambda p: p.grad))


def grad_gap(got, want):
    """The worst leaf's max abs difference over max(1, max|g|)."""
    return max((float(np.abs(got[k] - g).max())
                / max(1.0, float(np.abs(g).max())), k) for k, g in want.items())


def train_grad_card_vs_cpu(builder):
    """A full-width f32 bag gradient (TF32 off) on the card against the
    CPU's, with the same weights and injected noise: every leaf within
    1e-4 x max(1, max|g|).

    The gradient of this model is not smooth: a LeakyReLU pre-activation
    within rounding of 0 takes the other slope on the other device, and at
    300 px a bag holds millions of them, so a rounding-sized change of the
    input moves the CPU's own gradient beyond 1e-4 (``at_300px`` reports
    both gaps). The check is held on
    a bag whose CPU gradient is shown stable: among GRAD_CANDIDATES bags of
    GRAD_TILES distinct synthetic tiles at GRAD_RES px (8 through the CNN),
    the first whose gradient moves by at most 1e-5 under three random 1e-6
    relative changes of its tiles. At 300 px (40 tiles of the one-pass
    slide) the card's gap is reported beside the CPU's own under such a
    change, and not held."""
    cfg = amil.MILConfig()
    model = amil.init_attention_mil(torch.Generator().manual_seed(3), cfg)
    cpu_model = amil.AttentionMIL(cfg, device="cpu")
    cpu_model.load_state_dict(model.state_dict())
    k = max(1, int(GRAD_TILES * cfg.train_tile_fraction))

    def noise(rng):
        return (torch.from_numpy(rng.gumbel(size=GRAD_TILES)
                                 .astype(np.float32)),
                torch.from_numpy(rng.random((k, cfg.L)) < 1.0 - cfg.dropout))

    def nudged(tiles, rng):
        return tiles * (1.0 + 1e-6 * torch.from_numpy(
            rng.standard_normal(tuple(tiles.shape)).astype(np.float32)))

    chosen = None
    for c in range(GRAD_CANDIDATES):
        rng = np.random.default_rng(300 + c)
        base = rng.integers([120, 40, 150], [160, 80, 190],
                            (GRAD_TILES, 1, 1, 3))
        raw = np.clip(base + rng.integers(-40, 40, (GRAD_TILES, 300, 300, 3)),
                      0, 255).astype(np.uint8)
        tiles = transforms.eval_transform(torch.from_numpy(raw),
                                          resolution=GRAD_RES)
        scores, keep = noise(rng)
        loss_cpu, g_cpu = bag_grads(cpu_model, tiles, scores, keep)
        cpu_gaps = [grad_gap(bag_grads(cpu_model, nudged(tiles, rng), scores,
                                       keep)[1], g_cpu)[0] for _ in range(3)]
        if max(cpu_gaps) <= 1e-5:
            chosen = c
            break
    if chosen is None:
        raise AssertionError(f"no bag among {GRAD_CANDIDATES} has a CPU "
                             "gradient stable to 1e-5")
    loss_card, g_card = bag_grads(model, tiles.cuda(), scores, keep)
    worst, worst_key = grad_gap(g_card, g_cpu)

    # at 300 px: reported beside the CPU's own gap under a 1e-6 change
    rng = np.random.default_rng(5)
    raw = np.load(builder.params["data_cache"], mmap_mode="r")[:GRAD_TILES]
    tiles = transforms.eval_transform(torch.from_numpy(raw.copy()),
                                      resolution=300)
    scores, keep = noise(rng)
    _, g300_cpu = bag_grads(cpu_model, tiles, scores, keep)
    _, g300_card = bag_grads(model, tiles.cuda(), scores, keep)
    gap300 = grad_gap(g300_card, g300_cpu)
    self300 = grad_gap(bag_grads(cpu_model, nudged(tiles, rng), scores,
                                 keep)[1], g300_cpu)
    emit({"phase": "train_grad_card_vs_cpu", "dtype": "float32",
          "tiles": GRAD_TILES, "cnn_tiles": k, "resolution": GRAD_RES,
          "candidate": chosen, "cpu_gaps_under_1e-6_change": cpu_gaps,
          "loss_card": loss_card, "loss_cpu": loss_cpu,
          "worst_leaf": worst_key, "worst_err_over_max1_g": worst,
          "tol": 1e-4, "ok": worst <= 1e-4,
          "at_300px": {"card_vs_cpu": gap300[0], "leaf": gap300[1],
                       "cpu_under_1e-6_change": self300[0],
                       "cpu_leaf": self300[1]}})
    if worst > 1e-4:
        raise AssertionError(f"the card's bag gradient differs from the "
                             f"CPU's at {worst_key}: {worst}")


def train_times(flags, runs, card):
    """A training bag's data time (gather + copy to the card +
    train_transform) and model time (forward + backward) on the largest
    training slide (2500 tiles after the cap), median of 3; a 5-bag window
    through the trainer's loader with the optimizer step, median of 3; the
    peak device memory of a bag's step with and without remat; one traced
    window."""
    args = classify.build_argparser().parse_args(
        ["--tag", "TIME", *TRAIN_ARGS, *flags, "--output_root", runs])
    out = os.path.join(runs, "run_TIME")
    os.makedirs(out)
    ds = dataset.GHPSingleBagDatasetSimple(
        output_dir=out, root_dir=args.data_root, image_dir=args.image_dir,
        label_sheet=args.label_sheet, roi_size=args.roi_size, seed=args.seed)
    ds.load_new(n_folds=6, n_fold_selection=args.fold)
    cfg = classify.make_config(args, ds.GetClassWeights())
    driver = classify.Driver(args, cfg, out)
    ds.NewResolution(args.resolution)
    big = max(ds.train_slide_builders, key=lambda b: b.getsize())
    big.reseed_augment(0, 0, 0)
    s_data = timed(big.get_train_data)
    bag = big.get_train_data()
    mask = torch.ones(bag.shape[0], device=bag.device)

    def bag_step(grad_fn=driver.grad_fn):
        return grad_fn(driver.model, bag, mask, 0, driver.bag_generator(0, 0))

    s_model = timed(bag_step)
    peaks = {}
    for remat in (False, True):
        grad_fn = steps.make_bag_grad(dataclasses.replace(cfg, remat=remat),
                                      compute_dtype=driver.compute_dtype)
        driver.model.zero_grad(set_to_none=True)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        bag_step(grad_fn)
        torch.cuda.synchronize()
        peaks[remat] = (torch.cuda.max_memory_allocated(), base)
    s_model_remat = timed(lambda: bag_step(steps.make_bag_grad(
        dataclasses.replace(cfg, remat=True),
        compute_dtype=driver.compute_dtype)))
    driver.model.zero_grad(set_to_none=True)

    def window():
        ds.train()
        for tiles, m, label in loader.sample_data(
                ds, image_size=args.resolution, shuffle=True, seed=1):
            driver.grad_fn(driver.model, tiles, m, label,
                           driver.bag_generator(0, 0))
        steps.apply_updates(driver.optimizer, 1e-5)

    s_window = timed(window)
    emit({"phase": "train_time", "compute_dtype": "bfloat16",
          "bag_tiles": int(bag.shape[0]),
          "bag_model_tiles": max(1, int(bag.shape[0]
                                        * cfg.train_tile_fraction)),
          "bag_data_s": s_data, "bag_model_s": s_model,
          "bag_model_remat_s": s_model_remat,
          "window_bags": len(ds.train_slide_builders), "window_s": s_window,
          "peak_mem_gb": peaks[False][0] / 1e9,
          "peak_mem_remat_gb": peaks[True][0] / 1e9,
          "step_mem_gb": (peaks[False][0] - peaks[False][1]) / 1e9,
          "step_mem_remat_gb": (peaks[True][0] - peaks[True][1]) / 1e9,
          **card})
    del bag
    trace("train window (5 bags + Adam step)", window, card)


# ------------------------------------------------------ serving modes
def read_interface(out):
    """An interface run's output directory: the probability table
    (key -> [p0, p1, p2, Aterm_var]), the manifests' row counts and the
    ``.dla`` maps."""
    with open(os.path.join(out, "GBMresult_probs_class.csv")) as f:
        rows = list(csv.reader(f))
    if rows[0] != ["", "0", "1", "2", "3"]:
        raise AssertionError(f"interface table header {rows[0]}")
    table = {r[0]: np.array([float(v) for v in r[1:]]) for r in rows[1:]}
    counts = {}
    for name in ("manifest_img.csv", "manifest_heat.csv", "move_images.sh"):
        with open(os.path.join(out, name)) as f:
            counts[name] = len(f.read().splitlines())
    dlas = [f for f in os.listdir(out) if f.endswith(".dla")]
    return table, counts, dlas


def check_interface_output(label, out, n_slides):
    """One row a slide in the table and each manifest, four maps a slide,
    finite probabilities that sum to 1. Returns the table."""
    table, counts, dlas = read_interface(out)
    want = {"manifest_img.csv": n_slides + 1,
            "manifest_heat.csv": n_slides + 1, "move_images.sh": n_slides}
    if len(table) != n_slides or counts != want or len(dlas) != 4 * n_slides:
        raise AssertionError(f"{label}: {len(table)} rows, {counts}, "
                             f"{len(dlas)} maps for {n_slides} slides")
    for key, row in table.items():
        check_probs(f"{label} {key}", row[:3], 3)
    return table


def interface_phase(flags, runs, ckpt, card):
    """``classify.main([... "--interface"])`` on the training cohort from
    the trainer's epoch-1 checkpoint, in bf16 and in f32: the two
    5000-tile slides stream (above the default --stream_tiles 4096), the
    rest go as one bag each. One pool launch a slide, every pooled T held
    to plain; the table's probabilities against direct ``classify_slide``
    / ``classify_slide_streaming`` calls with the same weights (f32 within
    1e-5, bf16 within the 1e-3 contract). Then the bf16 run's wall time
    (seconds a slide, tiles/s) and a traced run. Returns (the pool
    launches of the two runs, the f32 table)."""
    common = [*TRAIN_ARGS, *flags, "--interface", "--ckpt", ckpt]
    seen, real = set(), gated_pool._launch

    def launch(a_raw, *rest):
        seen.add(int(a_raw.shape[0]))
        return real(a_raw, *rest)

    tables, launches, walls = {}, {}, {}
    gated_pool._launch = launch
    try:
        for dtype, extra in (("bfloat16", []), ("float32", ["--f32"])):
            root = os.path.join(runs, f"iface_{dtype}")
            gated_pool.LAUNCHES = 0
            t0 = time.perf_counter()
            run_trainer(["--tag", "IF", *common, *extra,
                         "--output_root", root])
            walls[dtype] = time.perf_counter() - t0
            launches[dtype] = gated_pool.LAUNCHES
            tables[dtype] = check_interface_output(
                f"interface {dtype}", os.path.join(root, "interface_data"),
                len(TRAIN_COHORT))
    finally:
        gated_pool._launch = real

    cfg = amil.MILConfig()
    model = amil.init_attention_mil(torch.Generator().manual_seed(0), cfg)
    checkpoint.restore_params(model, ckpt)
    slides = os.path.join(runs, os.pardir, "slides")
    gaps, tiles, streamed = {"bfloat16": 0.0, "float32": 0.0}, 0, 0
    for name in TRAIN_COHORT:
        builder = roibuilder.RoiBuilder(
            os.path.join(slides, f"{name}_H&E.scn"), {"roi_size": TRAIN_ROI})
        tiles += builder.getsize()
        stream = builder.getsize() > 4096
        streamed += stream
        for dtype, cd in (("bfloat16", torch.bfloat16), ("float32", None)):
            if stream:
                probs, _, _ = inference.classify_slide_streaming(
                    model, cfg, builder, resolution=300, compute_dtype=cd)
            else:
                probs, _, _ = inference.classify_slide(
                    model, cfg, builder, resolution=300, compute_dtype=cd)
            gaps[dtype] = max(gaps[dtype], float(np.abs(
                tables[dtype][f"{name}_H&E"][:3] - probs).max()))
    unchecked = sorted(seen - set(MAIN_PATH_T))
    emit({"phase": "interface_checks", "slides": len(TRAIN_COHORT),
          "streamed_slides": streamed, "pool_launches": launches,
          "pooled_T": sorted(seen), "unchecked_T": unchecked,
          "table_vs_direct_f32": gaps["float32"], "tol_f32": 1e-5,
          "table_vs_direct_bf16": gaps["bfloat16"], "tol_bf16": 1e-3})
    if any(n != len(TRAIN_COHORT) for n in launches.values()):
        raise AssertionError(f"interface pool launches {launches}, want one "
                             "a slide")
    if unchecked:
        raise AssertionError("the interface pooled bags whose size the pool "
                             f"kernel was not held to plain at: {unchecked}")
    if gaps["float32"] > 1e-5 or gaps["bfloat16"] > 1e-3:
        raise AssertionError(f"the interface tables differ from direct "
                             f"calls: {gaps}")

    argv = ["--tag", "IF", *common, "--output_root",
            os.path.join(runs, "iface_traced")]
    n = gated_pool.LAUNCHES
    emit({"phase": "interface_time", "compute_dtype": "bfloat16",
          "slides": len(TRAIN_COHORT), "tiles": tiles,
          "wall_s": walls["bfloat16"], "wall_f32_s": walls["float32"],
          "s_per_slide": walls["bfloat16"] / len(TRAIN_COHORT),
          "tiles_per_s": tiles / walls["bfloat16"], **card})
    trace("interface (classify.main --interface, bf16)",
          lambda: run_trainer(argv), card)
    gated_pool.LAUNCHES = n  # the traced run is not the main path's
    return launches, tables["float32"]


def int8_sites(model, tiles, qp, sc):
    """Every conv site of the full-width int8 forward on ``tiles``: each
    lowering's int32 accumulation on the card against the float64
    convolution of the same int8 operands on the CPU (exact): all equal,
    bit for bit. Returns the site count and the largest |accumulation|."""
    sites, real = [], quant._conv_i8_acc

    def record(wq, x_i8, *, stride, padding, impl="conv"):
        sites.append((wq, x_i8, stride, padding))
        return real(wq, x_i8, stride=stride, padding=padding, impl=impl)

    quant._conv_i8_acc = record
    try:
        quant.apply_resnet26_int8(qp, sc, tiles)
    finally:
        quant._conv_i8_acc = real
    biggest = 0
    for i, (wq, x_i8, stride, padding) in enumerate(sites):
        want = torch.round(F.conv2d(x_i8.cpu().double(), wq.cpu().double(),
                                    stride=stride, padding=padding)
                           ).to(torch.int32)
        biggest = max(biggest, int(want.abs().max()))
        for impl in quant.IMPLS:
            got = real(wq, x_i8, stride=stride, padding=padding,
                       impl=impl).cpu()
            if not torch.equal(got, want):
                raise AssertionError(
                    f"int8 site {i} ({tuple(wq.shape)}, stride {stride}): "
                    f"{impl} differs from the exact accumulation by "
                    f"{int((got - want).abs().max())}")
    return len(sites), biggest


def int8_ab(cnn, qp, sc, card, rounds=2, iters=2):
    """The int8 extractor by each lowering against the bf16 cuDNN
    extractor (``apply_resnet26``) at STEM_AB_TILES normalized tiles, in
    interleaved rounds (A B C D, D C B A), median ms per call by CUDA
    events (one warm-up call each time), and each one's device time per
    call from the profiler (all its kernels). The three lowerings'
    features must be bit-identical."""
    x = transforms.eval_transform(
        stem_tiles(STEM_AB_TILES, 400, cnn.conv1.weight.device),
        resolution=300)

    def bf16():
        return resnet.apply_resnet26(cnn, x, compute_dtype=torch.bfloat16)

    variants = {"bf16/cudnn": bf16}
    for impl in quant.IMPLS:
        variants[f"int8/{impl}"] = functools.partial(
            quant.apply_resnet26_int8, qp, sc, x, impl=impl)
    with torch.no_grad():
        feats = [variants[f"int8/{impl}"]() for impl in quant.IMPLS]
        same = all(torch.equal(feats[0], f) for f in feats[1:])
        ref = bf16().float()
        d_bf16 = float((feats[0] - ref).abs().max() / ref.abs().max())
        del feats, ref
        if not same:
            raise AssertionError("the int8 lowerings' features differ at "
                                 f"{STEM_AB_TILES} tiles")
        times = {k: [] for k in variants}
        for r in range(rounds):
            order = list(variants) if r % 2 == 0 else list(reversed(variants))
            for name in order:
                times[name].append(time_cuda(variants[name], iters,
                                             warmup=1))
        device = {}
        for name, fn in variants.items():
            ms, how = device_ms(fn, 2)
            device[name] = {"ms": ms, **ms_how(how)}
    med = {k: statistics.median(v) for k, v in times.items()}
    emit({"phase": "int8_ab", "tiles": STEM_AB_TILES, "rounds": rounds,
          "iters_per_round": iters, "ms": med,
          "tiles_per_s": {k: STEM_AB_TILES / (v / 1e3) for k, v in med.items()},
          "over_bf16": {k: med["bf16/cudnn"] / v for k, v in med.items()},
          "device": device, "lowerings_bit_identical": same,
          "int8_vs_bf16_features_rel": d_bf16, "all_ms": times, **card})


def int8_daemon(model, cfg, slides, calib, card):
    """The daemon with ``--int8`` over the serving manifest behind a
    tile-less slide (the oldest file, so it comes first): calibration
    defers past it to the first slide with tiles (``onepass``), one pool
    launch a slide, every pooled T held to plain, and each slide's row
    equal to a direct ``classify_slide_streaming`` call with the int8
    program calibrated on the same tiles (within the CSV's rounding,
    1e-5). Returns the pool launches."""
    root = os.path.join(CACHE, "daemon_int8")
    os.makedirs(root)
    ckpt = checkpoint.save(checkpoint.checkpoint_path(root, 0), model)
    empty = write_slide("empty", 99, (3, 3, 300, 9, 4))
    os.utime(empty, (1, 1))
    mfile = os.path.join(root, "slides.txt")
    with open(mfile, "w") as f:
        f.write("".join(p + "\n" for p in [empty] + [p for _, p in slides]))
    argv = ["--manifest", mfile, "--out_root", os.path.join(root, "out"),
            "--ckpt", ckpt, "--roi_size", "300", "--resolution", "300",
            "--chunk", "1024", "--settle_secs", "0", "--once", "--int8",
            "--int8_calib", str(calib.shape[0])]
    seen, real = set(), gated_pool._launch

    def launch(a_raw, *rest):
        seen.add(int(a_raw.shape[0]))
        return real(a_raw, *rest)

    text = io.StringIO()
    gated_pool._launch = launch
    gated_pool.LAUNCHES = 0
    try:
        with contextlib.redirect_stdout(text):
            t0 = time.perf_counter()
            rc = serve.main(argv)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        gated_pool._launch = real
    launches = gated_pool.LAUNCHES
    log(text.getvalue())
    if rc != 0:
        raise AssertionError(f"serve.main({argv}) returned {rc}")
    rows = read_rows(os.path.join(root, "out"))
    deferred = "int8 calibration deferred: empty_H&E has no tiles" in \
        text.getvalue()
    armed_on_onepass = "calibration tiles from onepass_H&E)" in text.getvalue()

    te = quant.make_int8_transform_extract(model.cnn, calib, 300)
    gap, tiles = 0.0, 0
    for _, path in slides:
        builder = roibuilder.RoiBuilder(path, {"roi_size": 300})
        tiles += builder.getsize()
        probs, outs, _ = inference.classify_slide_streaming(
            model, cfg, builder, resolution=300, chunk=1024,
            compute_dtype=torch.bfloat16, transform_extract=te)
        row = rows[builder.getname()]
        gap = max(gap, float(np.abs(row_probs(row) - probs).max()))
        if int(row["pred"]) != int(outs["y_pred_hat"]):
            raise AssertionError(f"int8 daemon row differs: {row}")
    unchecked = sorted(seen - set(MAIN_PATH_T))
    emit({"phase": "int8_daemon", "slides": len(rows),
          "pool_launches": launches, "pooled_T": sorted(seen),
          "unchecked_T": unchecked, "calibration_deferred": deferred,
          "armed_on_first_slide_with_tiles": armed_on_onepass,
          "rows_vs_direct_int8": gap, "tol": 1e-5, "wall_s": wall,
          "tiles_per_s": tiles / wall, **card})
    if (len(rows) != len(slides) + 1 or launches != len(rows)
            or not deferred or not armed_on_onepass or unchecked
            or gap > 1e-5):
        raise AssertionError("the int8 daemon's run is not right")
    return launches


def int8_phase(model, cfg, one, slides, p_one, p32_one, flags, runs, ckpt,
               f32_table, card):
    """W8A8 int8 at full width on the card: every conv site exact by each
    lowering (``int8_sites``, 16 tiles of the one-pass slide), the
    slide-probability drift of the 2000-tile slide from the bf16 and f32
    paths (< 2e-3; the argmax kept unless the f32 top two lie closer than
    the drift itself), the daemon with ``--int8``, ``--interface --int8``
    on the training cohort, and the A/B against the bf16 extractor.
    Returns the pool launches of the daemon and interface runs."""
    calib = quant.calib_tiles_from_builder(one, 256, 300)
    qp, sc = quant.quantize_and_calibrate(model.cnn, calib)
    tiles = transforms.eval_transform(torch.from_numpy(np.load(
        one.params["data_cache"], mmap_mode="r")[:16].copy()).cuda(),
        resolution=300)
    n_sites, biggest = int8_sites(model, tiles, qp, sc)
    del tiles

    te = quant.make_int8_transform_extract(model.cnn, calib, 300,
                                           qp_sc=(qp, sc))
    p8, _, _ = inference.classify_slide_streaming(
        model, cfg, one, resolution=300, chunk=1024, transform_extract=te)
    check_probs("int8 one-pass slide", p8, cfg.n_classes)
    drift = {"vs_bf16": float(np.abs(p8 - p_one).max()),
             "vs_f32": float(np.abs(p8 - p32_one).max())}
    top2 = np.sort(p32_one)[-2:]
    margin = float(top2[1] - top2[0])
    kept = int(np.argmax(p8)) == int(np.argmax(p32_one))
    emit({"phase": "int8_checks", "conv_sites": n_sites,
          "max_abs_accumulation": biggest, "float32_exact_below": 2 ** 24,
          "sites_exact_every_lowering": True, "tiles": one.getsize(),
          "probs_int8": p8.tolist(), "probs_f32": p32_one.tolist(),
          "drift": drift, "tol": 2e-3, "argmax_kept": kept,
          "f32_top2_margin": margin})
    if max(drift.values()) >= 2e-3 or not (kept or margin < drift["vs_f32"]):
        raise AssertionError(f"int8 drift {drift}, argmax kept {kept}")

    launches = {"serve_daemon_int8": int8_daemon(model, cfg, slides, calib,
                                                 card)}
    root = os.path.join(runs, "iface_int8")
    gated_pool.LAUNCHES = 0
    run_trainer(["--tag", "IF", *TRAIN_ARGS, *flags, "--interface", "--ckpt",
                 ckpt, "--int8", "--output_root", root])
    launches["interface_int8"] = gated_pool.LAUNCHES
    table = check_interface_output(
        "interface int8", os.path.join(root, "interface_data"),
        len(TRAIN_COHORT))
    emit({"phase": "interface_int8", "pool_launches":
          launches["interface_int8"],
          "drift_vs_f32_interface": max(
              float(np.abs(table[k][:3] - f32_table[k][:3]).max())
              for k in table)})
    if launches["interface_int8"] != len(TRAIN_COHORT):
        raise AssertionError("interface --int8 did not pool once a slide")
    int8_ab(model.cnn, qp, sc, card)
    return launches


def profile_phase(flags, runs, card):
    """``--profile --tensorboard`` for one epoch: the Chrome trace under
    ``<run>/profile/`` holds the card's kernels, the summary's
    ``step_times`` at least one step, and the run exits 0 (``--tensorboard``
    is a no-op where tensorboard is not installed; whether it wrote is
    reported). Returns (forward, backward) pool launches."""
    gated_pool.LAUNCHES = gated_pool.BWD_LAUNCHES = 0
    t0 = time.perf_counter()
    run_trainer(["--tag", "PROF", "--epoch_start", "0", "--epoch_end", "0",
                 "--profile", "--tensorboard", *TRAIN_ARGS, *flags,
                 "--output_root", runs])
    wall = time.perf_counter() - t0
    launches = gated_pool.LAUNCHES, gated_pool.BWD_LAUNCHES
    run = os.path.join(runs, "run_PROF")
    prof = os.path.join(run, "profile")
    traces = [os.path.join(prof, f) for f in os.listdir(prof)
              if f.endswith(".json")]
    with open(traces[0]) as f:
        events = json.load(f)["traceEvents"]
    spans = sorted((e["ts"], e["ts"] + e.get("dur", 0)) for e in events
                   if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))
    busy, end = 0.0, float("-inf")
    for s0, e0 in spans:
        busy += max(0.0, e0 - max(s0, end))
        end = max(end, e0)
    stamps = [e["ts"] for e in events if "ts" in e]
    span_us = (max(stamps) - min(stamps)) if stamps else 0.0
    steps = read_summary(run, 0).get("step_times", {})
    emit({"phase": "profile", "wall_s": wall, "traces": len(traces),
          "trace_bytes": os.path.getsize(traces[0]),
          "device_events": len(spans), "trace_span_s": span_us / 1e6,
          "device_busy_s": busy / 1e6,
          "device_idle_share": 1.0 - busy / span_us if span_us else None,
          "step_times": steps, "pool_launches": launches[0],
          "pool_backward_launches": launches[1],
          "tensorboard_wrote": os.path.isdir(
              os.path.join(runs, "runs", "TAG_PROF")), **card})
    if len(traces) != 1 or not spans or steps.get("steps", 0) < 1:
        raise AssertionError("--profile wrote no trace of the card's "
                             "kernels or no step times")
    return launches


def build_caches_phase(slides, card):
    """``data/build_caches.py --workers 2`` over links to the serving
    slides' files, into a fresh cache directory: the caches must be byte
    for byte the ones ``RoiBuilder`` wrote for the same slides."""
    root = os.path.join(CACHE, "build_caches")
    os.makedirs(os.path.join(root, "imgs"))
    os.makedirs(os.path.join(root, "cache"))
    for _, path in slides:
        os.link(path, os.path.join(root, "imgs", os.path.basename(path)))
    argv = ["--data_root", root, "--image_dir", "imgs", "--roi_size", "300",
            "--glob", "*.npy", "--workers", "2"]
    os.environ["CACHE_DIR"] = os.path.join(root, "cache")
    try:
        with contextlib.redirect_stdout(sys.stderr):
            t0 = time.perf_counter()
            rc = build_caches.main(argv)
            wall = time.perf_counter() - t0
    finally:
        os.environ["CACHE_DIR"] = CACHE
    if rc != 0:
        raise AssertionError(f"build_caches.main({argv}) returned {rc}")
    names = sorted(os.listdir(os.path.join(root, "cache")))
    differ = [n for n in names
              if not filecmp.cmp(os.path.join(root, "cache", n),
                                 os.path.join(CACHE, n), shallow=False)]
    emit({"phase": "build_caches", "workers": 2, "slides": len(slides),
          "cache_files": len(names), "differ_from_roibuilder": differ,
          "wall_s": wall, **card})
    if len(names) != 2 * len(slides) or differ:
        raise AssertionError(f"build_caches wrote {names}; differing {differ}")


# ------------------------------------------------------------ AOT bundles
def _poison_model_code():
    """Make the port's model builders and module entry points raise: a
    bundle must serve without them."""
    def boom(*a, **k):
        raise AssertionError("model code called on a bundle's path")

    for obj, name in ((resnet, "init_resnet26"), (resnet, "apply_resnet26"),
                      (resnet.ResNet26, "forward"),
                      (resnet.ResNet26, "forward_u8"),
                      (amil, "init_attention_mil"),
                      (amil.AttentionMIL, "__init__"),
                      (amil, "attention_pool")):
        setattr(obj, name, boom)


def bundle_child(spec_path, out_path):
    """``chip_smoke.py --bundle-child SPEC OUT``, the fresh process of
    ``bundle_phase``, in which no model is ever built: with the model code
    poisoned, for each bundle of the JSON ``SPEC`` (name -> {"dir",
    "slides"}), in order, load it (timed; the first load pays the
    process's cold imports) and classify each slide once (its pool
    launches and pooled T recorded), then time the largest slide's
    classification (median of 3) and the pool program at T = 2000 (CUDA
    events). Writes the results to ``OUT`` as JSON."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    _poison_model_code()
    with open(spec_path) as f:
        spec = json.load(f)
    t0 = time.perf_counter()
    torch.zeros(1, device=_device.resolve_device(None))
    torch.cuda.synchronize()
    result = {"cuda_init_s": time.perf_counter() - t0, "bundles": {}}
    seen, real = [], gated_pool._launch

    def launch(a_raw, *rest):
        seen.append(int(a_raw.shape[0]))
        return real(a_raw, *rest)

    for name, job in spec.items():
        t0 = time.perf_counter()
        clf = deploy.DeployedClassifier(job["dir"])
        load_s = time.perf_counter() - t0
        slides, builders = {}, []
        gated_pool._launch = launch
        try:
            for path in job["slides"]:
                builder = roibuilder.RoiBuilder(
                    path, {"roi_size": clf.manifest["roi_size"]})
                gated_pool.LAUNCHES = 0
                t0 = time.perf_counter()
                probs, outs, coords = clf.classify_builder(builder)
                torch.cuda.synchronize()
                slides[builder.getname()] = {
                    "T": builder.getsize(), "launches": gated_pool.LAUNCHES,
                    "first_s": time.perf_counter() - t0,
                    "probs": probs.tolist(), "Aterm": outs["Aterm"].tolist(),
                    "coords": len(coords)}
                builders.append(builder)
        finally:
            gated_pool._launch = real
        big = max(builders, key=lambda b: b.getsize())
        H = torch.randn((2000, clf.manifest["feature_dim"]),
                        generator=torch.Generator().manual_seed(5)
                        ).to(clf.device)
        result["bundles"][name] = {
            "load_s": load_s, "slides": slides,
            "timed_tiles": big.getsize(),
            "timed_s": timed(lambda: clf.classify_builder(big)),
            "pool_program_T": 2000,
            "pool_program_ms": time_cuda(lambda: clf.pool(H), 100)}
    result["pooled_T"] = seen
    with open(out_path, "w") as f:
        json.dump(result, f)


class _FunctionOverCtypes(torch.autograd.Function):
    """The forward path before the op (the autograd Function launching
    through ctypes straight away), kept here only to time it beside the
    op's."""

    @staticmethod
    def forward(ctx, *args):
        return gated_pool._launch(*args)


def time_pool_op(card, t=2000, rounds=2):
    """The forward's cost a call at ``t`` tiles by CUDA events over 500
    back-to-back calls, the mean of ``rounds`` interleaved rounds: the
    checked wrapper through the autograd Function and the op (what every
    path pays), the same wrapper launching through ctypes without the op
    (the path before it), the ``torch.library`` op alone and ``_launch``
    alone."""
    args = pool_inputs(t, 3, 1, seed=7)

    def before():
        gated_pool._check(*args)
        return _FunctionOverCtypes.apply(*args)

    variants = {"wrapper_us": lambda: gated_pool.gated_attention_pool(*args),
                "wrapper_without_op_us": before,
                "custom_op_us": lambda: gated_pool.gated_pool_forward(*args),
                "ctypes_launch_us": lambda: gated_pool._launch(*args)}
    n = gated_pool.LAUNCHES
    times = {k: [] for k in variants}
    for r in range(rounds):
        for k in (variants if r % 2 == 0 else reversed(variants)):
            times[k].append(1e3 * time_cuda(variants[k], 500))
    gated_pool.LAUNCHES = n  # timing launches are not the main path's
    emit({"phase": "pool_op_time", "T": t, "K": 3, "O": 1, "rounds": rounds,
          **{k: statistics.mean(v) for k, v in times.items()},
          "all_us": times, **card})


def bundle_phase(ckpt, one, big, hi, slides, card):
    """The AOT tier from the trained checkpoint ``ckpt``. The checkpoint
    goes to a reference-keyed pickle and back (``utils/torch_interop``),
    bit-identical. Two full-width bundles are exported from the imported
    ``.model`` through ``deploy.main``: bf16 at roi 300 (``--tiles``
    8192) and f32 at roi 1200, so that the exported extractor runs the
    anti-aliased resize. Both load in one fresh process that builds no
    model, its model code poisoned (``bundle_child``), and each classifies
    its slides (bf16: the 2000-
    and 5000-tile slides; f32: the 1200 px one): one pool launch a slide,
    every pooled T held to plain, probabilities and ``Aterm`` within 1e-5
    of the live ``classify_slide_streaming`` of the same weights in the
    same dtype (TF32 off), and within 1e-3 of the other dtype's. Then
    ``serve --bundle --once`` over the daemon's manifest behind a
    tile-less slide: one launch a served slide, rows within 1e-6 of direct
    ``DeployedClassifier`` calls, the tile-less slide failed and not
    recorded; a ``--prewarm`` run; the times. Returns the pool launches of
    the bundle paths."""
    root = os.path.join(CACHE, "bundle")
    os.makedirs(root)
    ref = os.path.join(root, "reference.pt")
    imported = os.path.join(root, "imported.model")
    n_keys = len(torch_interop.export_checkpoint(ckpt, ref))
    torch_interop.import_checkpoint(ref, imported)
    a, b = checkpoint.load_raw(ckpt), checkpoint.load_raw(imported)
    params = sorted(k for k in a if k.startswith("classifier/"))
    same = params == sorted(k for k in b if k.startswith("classifier/")) \
        and all(a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
                and a[k].tobytes() == np.ascontiguousarray(b[k]).tobytes()
                for k in params)
    emit({"phase": "reference_checkpoint_roundtrip", "tensors": n_keys,
          "bit_identical": same})
    if not same or n_keys != len(params):
        raise AssertionError("export_checkpoint then import_checkpoint "
                             "changed the trained checkpoint")

    exports = {}
    for name, flags in (("bf16", ["--roi_size", "300"]),
                        ("f32", ["--roi_size", "1200", "--f32"])):
        out = os.path.join(root, name)
        argv = ["export", "--ckpt", imported, "--out", out, "--resolution",
                "300", "--chunk", "1024", "--tiles", str(BUNDLE_TILES),
                *flags]
        with contextlib.redirect_stdout(sys.stderr):
            t0 = time.perf_counter()
            rc = deploy.main(argv)
            wall = time.perf_counter() - t0
        if rc != 0:
            raise AssertionError(f"deploy.main({argv}) returned {rc}")
        with open(os.path.join(out, deploy.MANIFEST)) as f:
            manifest = json.load(f)
        manifest.pop("config")
        exports[name] = {"dir": out, "export_s": wall, "manifest": manifest,
                         "bytes": sum(os.path.getsize(os.path.join(out, f))
                                      for f in os.listdir(out))}

    served = {"bf16": (one, big), "f32": (hi,)}
    spec, out = (os.path.join(root, f) for f in ("child.json", "child_out.json"))
    with open(spec, "w") as f:
        json.dump({nm: {"dir": exports[nm]["dir"],
                        "slides": [bb.params["fullpath"] for bb in builders]}
                   for nm, builders in served.items()}, f)
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--bundle-child", spec,
         out], cwd=ROOT, env=dict(os.environ, CACHE_DIR=CACHE),
        stdout=sys.stderr, stderr=sys.stderr, timeout=600, check=False)
    if proc.returncode != 0:
        raise AssertionError(f"the bundles' process exited {proc.returncode}")
    with open(out) as f:
        child = json.load(f)
    children = child["bundles"]

    cfg = amil.MILConfig()
    model = amil.init_attention_mil(torch.Generator().manual_seed(0), cfg)
    checkpoint.restore_params(model, imported, strict=True)
    n = gated_pool.LAUNCHES

    def live(builder, dtype):
        return inference.classify_slide_streaming(
            model, cfg, builder, resolution=300, chunk=1024,
            compute_dtype=dtype)[:2]

    gaps = {"same_dtype_probs": 0.0, "same_dtype_Aterm": 0.0,
            "other_dtype_probs": 0.0}
    for name, builders in served.items():
        dtype, other = ((torch.bfloat16, None) if name == "bf16"
                        else (None, torch.bfloat16))
        for builder in builders:
            got = children[name]["slides"][builder.getname()]
            probs, outs = live(builder, dtype)
            gaps["same_dtype_probs"] = max(gaps["same_dtype_probs"], float(
                np.abs(np.array(got["probs"]) - probs).max()))
            gaps["same_dtype_Aterm"] = max(gaps["same_dtype_Aterm"], float(
                np.abs(np.array(got["Aterm"]) - outs["Aterm"]).max()))
            gaps["other_dtype_probs"] = max(gaps["other_dtype_probs"], float(
                np.abs(np.array(got["probs"]) - live(builder, other)[0]).max()))
    s_live = timed(lambda: live(big, torch.bfloat16))
    gated_pool.LAUNCHES = n  # comparison launches are not the main path's
    per_slide = {nm: s["launches"] for c in children.values()
                 for nm, s in c["slides"].items()}
    pooled = sorted(set(child["pooled_T"]))
    unchecked = sorted(set(pooled) - set(MAIN_PATH_T))
    emit({"phase": "bundle_checks", "launches_per_slide": per_slide,
          "pooled_T": pooled, "unchecked_T": unchecked, **gaps,
          "tol_same_dtype": 1e-5, "tol_other_dtype": 1e-3,
          "manifests": {nm: e["manifest"] for nm, e in exports.items()}})
    if any(v != 1 for v in per_slide.values()) or unchecked:
        raise AssertionError("a bundle did not pool each slide with one "
                             "kernel launch at a checked T")
    if (gaps["same_dtype_probs"] > 1e-5 or gaps["same_dtype_Aterm"] > 1e-5
            or gaps["other_dtype_probs"] > 1e-3):
        raise AssertionError(f"the bundles disagree with the live path: "
                             f"{gaps}")

    # the daemon over the serving manifest behind a tile-less slide
    empty = write_slide("bundle_empty", 98, (3, 3, 300, 9, 4))
    mfile = os.path.join(root, "slides.txt")
    with open(mfile, "w") as f:
        f.write("".join(p + "\n" for p in [empty] + [p for _, p in slides]))
    seen, real = set(), gated_pool._launch

    def launch(a_raw, *rest):
        seen.add(int(a_raw.shape[0]))
        return real(a_raw, *rest)

    def run_daemon(out, *extra):
        argv = ["--manifest", mfile, "--out_root", os.path.join(root, out),
                "--bundle", exports["bf16"]["dir"], "--settle_secs", "0",
                "--once", *extra]
        text, errs = io.StringIO(), io.StringIO()
        with contextlib.redirect_stdout(text), contextlib.redirect_stderr(errs):
            t0 = time.perf_counter()
            rc = serve.main(argv)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        log(text.getvalue() + errs.getvalue())
        return rc, read_rows(os.path.join(root, out)), text.getvalue(), \
            errs.getvalue(), wall

    gated_pool._launch = launch
    gated_pool.LAUNCHES = 0
    try:
        rc, rows, _, errs, wall = run_daemon("serve")
    finally:
        gated_pool._launch = real
    launches = gated_pool.LAUNCHES
    clf = deploy.DeployedClassifier(exports["bf16"]["dir"])
    gap, tiles = 0.0, 0
    for _, path in slides:
        builder = roibuilder.RoiBuilder(path, {"roi_size": 300})
        tiles += builder.getsize()
        probs, outs, _ = clf.classify_builder(builder)
        row = rows[builder.getname()]
        gap = max(gap, float(np.abs(row_probs(row) - probs).max()))
        if (int(row["pred"]) != int(outs["y_pred_hat"])
                or int(row["ntiles"]) != builder.getsize()):
            raise AssertionError(f"bundle daemon row differs: {row}")
    empty_failed = ("bundle_empty_H&E" not in rows
                    and "AOT bundles serve tiled slides only" in errs)
    rc_w, _, text_w, _, _ = run_daemon("serve_prewarm", "--prewarm", "1024")
    prewarmed = "prewarm done (bundle" in text_w
    gated_pool.LAUNCHES = launches
    unchecked = sorted(seen - set(MAIN_PATH_T))
    emit({"phase": "bundle_daemon", "rc": rc, "slides": len(rows),
          "pool_launches": launches, "pooled_T": sorted(seen),
          "unchecked_T": unchecked, "rows_vs_direct": gap, "tol": 1e-6,
          "tile_less_failed": empty_failed, "prewarm_rc": rc_w,
          "prewarm_ran": prewarmed, "wall_s": wall,
          "tiles_per_s": tiles / wall, **card})
    if (rc != 1 or len(rows) != len(slides) or launches != len(slides)
            or unchecked or gap > 1e-6 or not empty_failed or rc_w != 1
            or not prewarmed):
        raise AssertionError("serve --bundle did not serve the manifest "
                             "right")

    bf16 = children["bf16"]
    emit({"phase": "bundle_time", "compute_dtype": "bfloat16",
          "export_s": {nm: e["export_s"] for nm, e in exports.items()},
          "bundle_bytes": {nm: e["bytes"] for nm, e in exports.items()},
          "load_s": {nm: c["load_s"] for nm, c in children.items()},
          "child_cuda_init_s": child["cuda_init_s"],
          "streaming_tiles": bf16["timed_tiles"],
          "bundle_streaming_s": bf16["timed_s"],
          "bundle_streaming_tiles_per_s": bf16["timed_tiles"] / bf16["timed_s"],
          "live_streaming_s": s_live,
          "live_streaming_tiles_per_s": big.getsize() / s_live,
          "pool_program_T": bf16["pool_program_T"],
          "pool_program_us": 1e3 * bf16["pool_program_ms"], **card})
    time_pool_op(card)
    return {"deploy_bundle": sum(per_slide.values()),
            "serve_bundle": launches}


# ------------------------------------------------------------ mesh phase
# The (slides, tiles) mesh (parallel/mesh.py) on the one card: the pool's
# split entries against the one-call kernel, a world of one over NCCL
# against the single-card path, two ranks on cuda:0 over gloo against the
# world of one. The split entries are checked at every T the paths pool,
# at a two-rank shard of a training subsample (250), just above each edge
# of the backward's cluster sizes, at each crossover of the forward's
# partition -1..+2 and at a 50k-tile bag; timed at the one-pass slide and
# the 50k bag (the backward at 250 as well).
MESH_POOL_T = sorted(set(MAIN_PATH_T) | {POOL_REPEAT_T, 250}
                     | {e + 1 for e in POOL_BWD_EDGES} | set(POOL_FWD_CROSS))
MESH_TIMED_T = (2000, 50000)
# the split backward is timed at a two-rank shard of a training subsample
# (250) as well
MESH_BWD_TIMED_T = (250, 2000, 50000)
# the window of the mesh's training checks: two bags of the one-pass
# slide's tiles (their 20 % subsamples are 120 and 80 tiles). The world of
# one is held to one card at 300 px. Two ranks split each bag's tiles, so
# the ResNet runs on each half on its own and cuDNN sees other batch
# sizes: they are held to the world of one at 64 px, and at 300 px to the
# one card's step with the ResNet called on the same halves and the pool
# and statistics whole (split_extract_step), the gap to the whole-bag step
# reported beside it
MESH_BAGS = ((0, 600), (600, 1000))
MESH_HELD_RES = 64
MESH_POOL_H_T = 2000           # the sharded pool's bag (the one-pass slide)
SPLIT_COUNTS = ("PARTIAL_LAUNCHES", "FINISH_LAUNCHES",
                "BWD_PARTIAL_LAUNCHES", "BWD_FINISH_LAUNCHES")
POOL_COUNTS = ("LAUNCHES", "BWD_LAUNCHES") + SPLIT_COUNTS


def pool_counts():
    torch.cuda.synchronize()
    return {k: getattr(gated_pool, k) for k in POOL_COUNTS}


def zero_pool_counts():
    for k in POOL_COUNTS:
        setattr(gated_pool, k, 0)


def set_pool_counts(counts):
    for k, v in counts.items():
        setattr(gated_pool, k, v)


def require_launched(path, counts, kernels):
    """Fail unless each wrapper count of ``kernels`` is above 0."""
    missing = [k for k in kernels if counts[k] < 1]
    if missing:
        raise AssertionError(f"{path}: {missing} never launched")


def _halves(t):
    return ([slice(0, t)] if t < 2
            else [slice(0, t // 2), slice(t // 2, t)])


def _rows_of(args, cut):
    a, b, m, w = args
    return [a[cut].contiguous(), b[cut].contiguous(), m[cut].contiguous(), w]


def split_pool_case(t, seed, device="cuda"):
    """The split entries at T = t against the one-call kernel and the plain
    versions: one shard (partials, then finish) and two (the partials of
    both halves summed in torch, then each half's finish), forward and,
    with random cotangents of all three outputs, backward. Returns the
    errors and whether one shard is the one-call kernel bit for bit."""
    args = pool_inputs(t, 3, 1, seed, device=device)
    one = gated_pool.gated_attention_pool(*args)
    plain = gated_pool.gated_attention_pool_reference(*args)
    single = gated_pool.pool_forward_finish(
        *args, gated_pool.pool_forward_partials(*args))
    shards = [_rows_of(args, c) for c in _halves(t)]
    totals = sum(gated_pool.pool_forward_partials(*x) for x in shards)
    fin = [gated_pool.pool_forward_finish(*x, totals) for x in shards]
    two = (fin[0][0], torch.cat([f[1] for f in fin], 1),
           torch.cat([f[2] for f in fin], 1))
    g = torch.Generator().manual_seed(seed + 1)
    cots = [torch.randn((3, 1), generator=g).to(device)] + [
        torch.randn((3, t), generator=g).to(device) for _ in range(2)]
    a1t = one[1]
    bwd_one = gated_pool.gated_attention_pool_backward(*args, a1t, *cots)
    bwd_plain = gated_pool.gated_attention_pool_backward_reference(
        *args, a1t, *cots)
    stats, db = gated_pool.pool_backward_partials(*args, a1t, *cots)
    bwd_single = (*gated_pool.pool_backward_finish(*args, stats, *cots),)
    bwd_single = (bwd_single[0], db, bwd_single[1])
    parts = []
    for c in _halves(t):
        x = _rows_of(args, c)
        cc = [cots[0], cots[1][:, c].contiguous(), cots[2][:, c].contiguous()]
        parts.append((x, cc, gated_pool.pool_backward_partials(
            *x, a1t[:, c].contiguous(), *cc)))
    totals_b = sum(p[2][0] for p in parts)
    fin_b = [gated_pool.pool_backward_finish(*x, totals_b, *cc)
             for x, cc, _ in parts]
    bwd_two = (torch.cat([f[0] for f in fin_b]),
               torch.cat([p[2][1] for p in parts]), sum(f[1] for f in fin_b))
    if device == "cuda":
        torch.cuda.synchronize()

    def gap(got, want):
        return [float((x - y).abs().max()) for x, y in zip(got, want)]

    same = (all(torch.equal(x, y) for x, y in zip(single, one))
            and all(torch.equal(x, y) for x, y in zip(bwd_single, bwd_one)))
    refs = [float(w.abs().max()) for w in bwd_plain]
    return {"T": t, "one_shard_bit_identical": same,
            "fwd_err_two_vs_kernel": gap(two, one),
            "fwd_err_two_vs_plain": gap(two, plain),
            "bwd_err_two_vs_kernel": gap(bwd_two, bwd_one),
            "bwd_err_two_vs_plain": gap(bwd_two, bwd_plain),
            "bwd_max_abs_ref": refs}


def check_split_pool(device="cuda"):
    """The split entries at every T of MESH_POOL_T (split_pool_case): one
    shard bit-identical to the one-call kernel; two shards within the
    one-call tolerances of the kernel and of the plain versions (M 1e-5,
    A1T and wROIs 1e-6; the backward 1e-5 x max|ref|). Returns the worst
    error against the plain versions."""
    saved = pool_counts()
    worst = 0.0
    for i, t in enumerate(MESH_POOL_T):
        row = split_pool_case(t, 700 + i, device)
        ok = row["one_shard_bit_identical"]
        for key in ("fwd_err_two_vs_kernel", "fwd_err_two_vs_plain"):
            e = row[key]
            ok = ok and e[0] <= 1e-5 and e[1] <= 1e-6 and e[2] <= 1e-6
        for key in ("bwd_err_two_vs_kernel", "bwd_err_two_vs_plain"):
            ok = ok and all(e <= 1e-5 * r for e, r in
                            zip(row[key], row["bwd_max_abs_ref"]))
        emit({"phase": "mesh_split_pool", **row, "tol_M": 1e-5,
              "tol_A1T_wROIs": 1e-6, "tol_bwd_rel": 1e-5, "ok": ok})
        if not ok:
            raise AssertionError(f"the split pool entries disagree at T={t}")
        worst = max(worst, *row["fwd_err_two_vs_plain"],
                    *row["bwd_err_two_vs_plain"])
    set_pool_counts(saved)  # comparison launches are not the main path's
    return worst


def time_split_pool(card):
    """One shard of the split forward (partials, then finish) at each T of
    MESH_TIMED_T and of the split backward (dM only) at each T of
    MESH_BWD_TIMED_T: device time per call (summed over its launches; each
    entry timed alone as well, and required to be one launch a call),
    CUDA-event time per call, the plain versions' time, the bound (the
    one-call pool's bytes and operations)."""
    saved = pool_counts()
    rows = {"forward": {}, "backward": {}}
    for t in sorted(set(MESH_TIMED_T) | set(MESH_BWD_TIMED_T)):
        args = pool_inputs(t, 3, 1, seed=9)
        a1t = gated_pool.gated_attention_pool(*args)[1]
        dm = torch.randn((3, 1), generator=torch.Generator().manual_seed(3)
                         ).cuda()
        stats = gated_pool.pool_backward_partials(*args, a1t, dm)[0]
        totals = gated_pool.pool_forward_partials(*args)
        cases = {}
        if t in MESH_TIMED_T:
            cases["forward"] = (
                lambda: gated_pool.pool_forward_finish(
                    *args, gated_pool.pool_forward_partials(*args)),
                lambda: gated_pool.pool_forward_finish_reference(
                    *args, gated_pool.pool_forward_partials_reference(*args)),
                pool_bound_ms(t, 3, 1))
        if t in MESH_BWD_TIMED_T:
            cases["backward"] = (
                lambda: gated_pool.pool_backward_finish(
                    *args, gated_pool.pool_backward_partials(
                        *args, a1t, dm)[0], dm),
                lambda: gated_pool.pool_backward_finish_reference(
                    *args, gated_pool.pool_backward_partials_reference(
                        *args, a1t, dm)[0], dm),
                pool_bwd_bound_ms(t, 3, 1))
        for way, (kernel, plain, (bound, bound_by)) in cases.items():
            ms, how = device_ms(kernel, 200, match="gated_pool_")
            wrapper_ms = time_cuda(kernel, 200)
            plain_ms = time_cuda(plain, 100)
            per_entry = {}
            entries = ((
                ("gated_pool_forward_partials",
                 lambda: gated_pool.pool_forward_partials(*args)),
                ("gated_pool_forward_finish",
                 lambda: gated_pool.pool_forward_finish(*args, totals)))
                if way == "forward" else (
                ("gated_pool_backward_partials",
                 lambda: gated_pool.pool_backward_partials(*args, a1t, dm)),
                ("gated_pool_backward_finish",
                 lambda: gated_pool.pool_backward_finish(*args, stats, dm))))
            kernel_name = ("gated_pool_fwd" if way == "forward"
                           else "gated_pool_bwd")
            for entry, fn in entries:
                e_ms, e_how = device_ms(fn, 200, match=kernel_name)
                require_one_launch(entry, t, e_how)
                per_entry[entry] = {"ms": e_ms, **ms_how(e_how)}
            rows[way][t] = {"ms": ms, **ms_how(how), "by_entry": per_entry,
                            "wrapper_ms": wrapper_ms, "plain_ms": plain_ms,
                            "bound_ms": bound, "bound_by": bound_by,
                            "bound_share": bound / ms}
            emit({"phase": "mesh_split_time", "entries": way, "T": t,
                  "blocks": (gated_pool.pool_fwd_partition(t)[1]
                             if way == "forward"
                             else gated_pool.pool_bwd_partition(t)[0]),
                  "kernel_device_us": 1e3 * ms, **ms_how(how),
                  "by_entry": per_entry,
                  "wrapper_us": 1e3 * wrapper_ms, "plain_us": 1e3 * plain_ms,
                  "bound_us": 1e3 * bound, "bound_by": bound_by,
                  "bound_share": bound / ms, "library_us": None, **card})
    set_pool_counts(saved)  # timing launches are not the main path's
    return rows


def mesh_window(builder, device, resolution=300):
    """The mesh checks' training window: the MESH_BAGS tiles of the
    one-pass slide, eval-transformed on ``device`` at ``resolution``, with
    masks of ones, labels (1, 2) and injected noise from numpy (a Gumbel
    score a tile, the dropout keep mask of the subsample)."""
    raw = np.load(builder.params["data_cache"], mmap_mode="r")
    rng = np.random.default_rng(21)
    tiles, masks, scores, keep = [], [], [], []
    for lo, hi in MESH_BAGS:
        t = hi - lo
        tiles.append(transforms.eval_transform(
            torch.from_numpy(raw[lo:hi].copy()).to(device),
            resolution=resolution))
        masks.append(torch.ones(t, device=device))
        scores.append(torch.from_numpy(rng.gumbel(size=t).astype(np.float32)))
        keep.append(torch.from_numpy(
            rng.random((int(t * 0.2), amil.MILConfig().L)) < 0.75))
    return tiles, masks, [1, 2], scores, keep


def mesh_train_step(model, mesh, window):
    """One window step (f32, lr 1e-3) from ``model``'s weights on a fresh
    copy: returns the window's summed gradient (Adam's first moment over
    0.1) and the parameters after the step, as host arrays by name, and
    the metrics with ``step_s``, the seconds of the step call alone
    (between two synchronizations; the copy, the optimizer and the host
    copies are outside it)."""
    work = amil.AttentionMIL(model.cfg, device=next(model.parameters()).device)
    work.load_state_dict(model.state_dict())
    opt = steps.make_optimizer(work)
    tiles, masks, labels, scores, keep = window
    step = steps.make_train_step(work.cfg, mesh=mesh)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    metrics = step(work, opt, tiles, masks, labels, 1e-3, scores=scores,
                   keep=keep)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    grads = {n: (opt.state[p]["exp_avg"] / 0.1).cpu().numpy()
             for n, p in work.named_parameters()}
    params = {n: p.detach().cpu().numpy() for n, p in work.named_parameters()}
    return grads, params, {**{k: np.asarray(v).tolist()
                              for k, v in metrics.items()}, "step_s": step_s}


def split_extract_step(model, window, shares):
    """The window step of :func:`mesh_train_step` on one card with no
    group, the ResNet called on each of the ``shares`` row shares of every
    bag's subsample that the tile ranks of a mesh extract (padded alike
    with zero-mask rows), and the pool and its statistics over the whole
    bag: what splitting the tile axis changes in the extractor, without
    the mesh's collectives."""
    cfg = model.cfg
    device = next(model.parameters()).device
    work = amil.AttentionMIL(cfg, device=device)
    work.load_state_dict(model.state_dict())
    opt = steps.make_optimizer(work)
    tiles, masks, labels, scores, keep = window
    for b in range(len(tiles)):
        idx, sub = amil.subsample_index(masks[b].cpu(),
                                        cfg.train_tile_fraction,
                                        scores[b].cpu())
        pad = -idx.shape[0] % shares
        idx = torch.cat([idx, idx.new_zeros(pad)])
        sub = torch.cat([sub, sub.new_zeros(pad)])
        kp = torch.cat([keep[b], keep[b].new_ones((pad, cfg.L))])
        step = idx.shape[0] // shares

        def extract(cnn, x):
            return torch.cat([resnet.apply_resnet26(
                cnn, x[i * step:(i + 1) * step]) for i in range(shares)])

        outs = amil._bag_forward(work, tiles[b][idx.to(device)], labels[b],
                                 cfg, sub.to(device), kp, None, remat=False,
                                 extractor=extract)
        outs["loss"].backward()
    steps.apply_updates(opt, 1e-3)
    return ({n: (opt.state[p]["exp_avg"] / 0.1).cpu().numpy()
             for n, p in work.named_parameters()},
            {n: p.detach().cpu().numpy() for n, p in work.named_parameters()})


def train_gap(got, want):
    """The worst relative gap of two window steps: the gradient per
    parameter over max(1, max|g|), and the parameters after the step over
    max(1, max|p|) wherever the reference gradient is above 1e-6 (Adam's
    step is lr g / (|g| + eps), whose sign is the rounding's where a
    summed gradient is zero but for rounding)."""
    g_gap = p_gap = 0.0
    for name, g in want[0].items():
        g_gap = max(g_gap, float(np.abs(got[0][name] - g).max())
                    / max(1.0, float(np.abs(g).max())))
        p = want[1][name]
        determined = np.abs(g) > 1e-6
        d = np.abs(got[1][name] - p)[determined]
        p_gap = max(p_gap, float(d.max(initial=0.0))
                    / max(1.0, float(np.abs(p).max())))
    return g_gap, p_gap


def mesh_sharded_pool(model, mesh, seed=31):
    """The explicit sharded pool of a seeded [MESH_POOL_H_T, L] feature
    matrix with a few masked rows, each rank feeding its share; the
    outputs as host arrays."""
    g = torch.Generator().manual_seed(seed)
    H = torch.randn((MESH_POOL_H_T, model.cfg.L), generator=g)
    mask = torch.ones(MESH_POOL_H_T)
    mask[-7:] = 0.0
    h, m = shard_pool.shard_features(mesh, H, mask)
    out = shard_pool.make_sharded_pool(model.cfg, mesh)(model, h, m)
    out["Aterm"] = out["Aterm"][:, :H.shape[0]]  # the pad to the tile axis
    return {k: v.cpu().numpy() for k, v in out.items()}


def time_all_reduce(mesh, iters=200):
    """Host time per call of one all-reduce of the pool's [K, 1+O] table
    on the card over the tile group, synchronised. It calls
    ``torch.distributed`` itself: on a group of one rank the port's own
    sums issue nothing, and this is what each such call used to cost."""
    table = torch.ones((3, 2), device=mesh.device)
    group = mesh.tiles_group
    for _ in range(5):
        dist.all_reduce(table, group=group)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        dist.all_reduce(table, group=group)
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / iters


def _rank_checks(mesh, spec):
    """One rank of a spawned mesh (two on cuda:0 over gloo, or one a card
    over NCCL): the sharded pool, one training window (at MESH_HELD_RES
    and at 300 px) and the 5000-tile slide streamed in f32 (TF32 off), from
    the same seeded weights as the parent's model; returns the results as
    host arrays, the launch counts of each path (keyed ``<label>_pool``,
    ``_train``, ``_streaming``) and the all-reduce's time."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    os.environ["CACHE_DIR"] = spec["cache"]
    label = spec["label"]
    model = amil.init_attention_mil(torch.Generator().manual_seed(0),
                                    amil.MILConfig(), device=mesh.device)
    out, counts = {}, {}
    zero_pool_counts()
    out["pool"] = mesh_sharded_pool(model, mesh)
    counts[f"{label}_pool"] = pool_counts()
    one = roibuilder.RoiBuilder(spec["one"], {"roi_size": 300},
                                device=mesh.device)
    zero_pool_counts()
    out["train"] = mesh_train_step(model, mesh, mesh_window(
        one, mesh.device, MESH_HELD_RES))
    counts[f"{label}_train"] = pool_counts()
    out["train300"] = mesh_train_step(model, mesh, mesh_window(
        one, mesh.device))
    big = roibuilder.RoiBuilder(spec["big"], {"roi_size": 300},
                                device=mesh.device)
    zero_pool_counts()
    probs, outs, _ = inference.classify_slide_streaming(
        model, model.cfg, big, resolution=300, chunk=1024,
        compute_dtype=None, mesh=mesh)
    counts[f"{label}_streaming"] = pool_counts()
    out["streaming"] = (probs, outs["Aterm"])
    out["counts"] = counts
    out["all_reduce_ms"] = time_all_reduce(mesh)
    return out


def world_one(model, one, big, store, shares, card):
    """A world of one over NCCL on cuda:0, in this process: the window step
    at 300 px against the single-card step, the streaming slide against
    the live pass (held to 1e-6, emitted as ``mesh_world1_nccl``), and the
    references of the spawned ranks (the f32 pool, window steps at
    MESH_HELD_RES and 300 px, the f32 streaming slide, and the 300 px step
    with the ResNet on the ``shares`` row shares of a tile axis of that
    size, :func:`split_extract_step`, whose gap to the whole-bag step is
    emitted as ``mesh_tile_split_witness``). Returns the references, the
    world-of-one paths' launches and the all-reduce's time."""
    cfg = model.cfg
    launches = {}
    mesh_mod.init(1, 0, backend="nccl",
                  init_method="file://" + os.path.join(store, "one"))
    try:
        mesh = mesh_mod.make_mesh(1, devices=["cuda:0"])
        window = mesh_window(one, "cuda")
        single = mesh_train_step(model, None, window)
        zero_pool_counts()
        with torch_comm_audit.record_collectives() as first:
            world1 = mesh_train_step(model, mesh, window)
        launches["mesh_world1_train"] = pool_counts()
        # the collectives' time from a second step: the group's first
        # collective sets up NCCL's communicator
        with torch_comm_audit.record_collectives() as warm:
            step_s = mesh_train_step(model, mesh, window)[2]["step_s"]
        set_pool_counts(launches["mesh_world1_train"])
        audit_world1 = world1_audit(first, warm, cfg, step_s, card)
        require_launched("mesh_world1_train", launches["mesh_world1_train"],
                         SPLIT_COUNTS)
        g_gap, p_gap = train_gap(world1, single)
        probs_live, outs_live, _ = inference.classify_slide_streaming(
            model, cfg, big, resolution=300, chunk=1024)
        zero_pool_counts()
        probs_w1, outs_w1, _ = inference.classify_slide_streaming(
            model, cfg, big, resolution=300, chunk=1024, mesh=mesh)
        launches["mesh_world1_streaming"] = pool_counts()
        require_launched("mesh_world1_streaming",
                         launches["mesh_world1_streaming"], ("LAUNCHES",))
        d_stream = float(np.abs(probs_w1 - probs_live).max())
        d_stream_a = float(np.abs(outs_w1["Aterm"] - outs_live["Aterm"]).max())
        # the references of the spawned ranks: f32, TF32 off
        refs = {"pool": mesh_sharded_pool(model, mesh), "train300": world1,
                "train": mesh_train_step(model, mesh, mesh_window(
                    one, "cuda", MESH_HELD_RES)),
                "streaming": inference.classify_slide_streaming(
                    model, cfg, big, resolution=300, chunk=1024,
                    compute_dtype=None, mesh=mesh)}
        ar_world1 = time_all_reduce(mesh)
        # the serving rate in bf16, the live pass and the world of one's
        # (its chunks' shares through the same pinned staging, one gather)
        # in alternate rounds
        rates = {"live": [], "world1": []}
        for _ in range(2):
            for key, m in (("live", None), ("world1", mesh)):
                rates[key].append(big.getsize() / timed(
                    lambda: inference.classify_slide_streaming(
                        model, cfg, big, resolution=300, chunk=1024,
                        mesh=m)))
    finally:
        dist.destroy_process_group()
    refs["train300_split"] = split_extract_step(model, window, shares)
    g_split, p_split = train_gap(refs["train300_split"], single)
    emit({"phase": "mesh_tile_split_witness", "shares": shares,
          "resolution": 300, "split_vs_whole_grad_gap_rel": g_split,
          "split_vs_whole_param_gap_rel": p_split,
          "how": "one card, no group: the ResNet on each share of the "
                 "subsample, the pool and statistics whole"})
    ok = (g_gap <= 1e-6 and p_gap <= 1e-6 and d_stream <= 1e-6
          and d_stream_a <= 1e-6)
    emit({"phase": "mesh_world1_nccl", "train_grad_gap_rel": g_gap,
          "train_param_gap_rel": p_gap, "tol_train_rel": 1e-6,
          "loss_single": single[2]["loss"], "loss_world1": world1[2]["loss"],
          "streaming_probs_gap": d_stream, "streaming_Aterm_gap": d_stream_a,
          "tol_streaming": 1e-6, "launches": launches,
          "streaming_bf16_tiles_per_s": rates, "ok": ok, **card})
    if not ok:
        raise AssertionError("a world of one disagrees with the single-card "
                             "path")
    return refs, launches, ar_world1, audit_world1


# a world of one before its sums over one rank were skipped (run F3 in
# PERF.md, NVIDIA H100 80GB HBM3, 700.00 W): 28 collectives in a 2-bag
# window step call of 64.5 ms
F3_WINDOW_COLLECTIVES, F3_WINDOW_STEP_MS = 28, 64.5


def world1_audit(first, warm, cfg, step_s, card):
    """The world of one's window steps as the collective audit counts them
    (``tools/torch_comm_audit``): the first and a second step's records,
    each held to the port's own pins for a window of len(MESH_BAGS) bags on
    one rank (none: a group of one rank issues nothing), and the second
    step's call time (:func:`mesh_train_step`'s ``step_s``) beside the
    earlier run F3's, with no bound."""
    want = torch_comm_audit.expected_window(1, 1, cfg, bags=len(MESH_BAGS))
    rows = [torch_comm_audit.summarize(
        "classifier_train_world1", records, None, "slides=1,tiles=1",
        "the mesh phase's window step on a world of one over NCCL")
        for records in (first, warm)]
    for row in rows:
        if row["call_sites"] != want["call_sites"]:
            raise AssertionError("the world of one's window step issues "
                                 "other collectives than pinned: "
                                 f"{row['call_sites']}")
    return {"collectives": rows[1]["collectives"],
            "call_sites": rows[1]["call_sites"],
            "collectives_count": len(warm),
            "first_step_collectives_count": len(first),
            "collectives_host_ms": rows[1]["host_ms"],
            "window_step_ms": 1e3 * step_s,
            "earlier_F3": {"collectives_count": F3_WINDOW_COLLECTIVES,
                          "window_step_ms": F3_WINDOW_STEP_MS,
                          "card": "NVIDIA H100 80GB HBM3, 700.00 W"},
            **card}


def comm_audit_phase(ar_world1, ar_gloo2, audit_world1, card):
    """``tools/torch_comm_audit.run_audit`` on two gloo ranks on cuda:0 at
    the CPU test's widths, every family held to the pins the CPU test
    holds (``expected_rows``: counts and bytes do not depend on the
    device); emitted beside the world of one's window step, its
    collectives' host time and the all-reduce times the mesh phase
    measured."""
    t0 = time.perf_counter()
    rows = torch_comm_audit.run_audit(2, full_width=False,
                                      devices=["cuda:0"] * 2)
    secs = time.perf_counter() - t0
    bad = torch_comm_audit.pins_mismatch(
        rows, torch_comm_audit.expected_rows(2, full_width=False))
    emit({"phase": "comm_audit", "ranks": 2, "devices": ["cuda:0"] * 2,
          "backend": "gloo", "rows": rows, "mismatches": bad,
          "world1_nccl_window": audit_world1,
          "all_reduce_table_ms": {"world1_nccl": ar_world1,
                                  "world2_gloo": ar_gloo2},
          "seconds": secs, "ok": not bad, **card})
    if bad:
        raise AssertionError(f"the collective audit on the card differs "
                             f"from the pins: {bad}")


def spawned_ranks(label, n, devices, one, big, refs, store):
    """``n`` spawned ranks on ``devices`` running :func:`_rank_checks`,
    held to the world of one's ``refs`` to 1e-5 (emitted as ``label``):
    the sharded pool, the window step at MESH_HELD_RES and, at 300 px, to
    the split-extractor witness (the gap to the whole-bag step is
    printed), the streaming slide; every rank's parameters after the step
    bit-identical. Returns the ranks' results and rank 0's launches."""
    t0 = time.perf_counter()
    ranks = mesh_mod.launch(
        _rank_checks, n,
        args=({"cache": CACHE, "label": label,
               "one": one.params["fullpath"],
               "big": big.params["fullpath"]},),
        devices=devices, init_method="file://" + os.path.join(store, label))
    secs = time.perf_counter() - t0
    got = ranks[0]
    d_pool = max(float(np.abs(got["pool"][k] - refs["pool"][k]).max())
                 for k in refs["pool"])
    g, p = train_gap(got["train"], refs["train"])
    g300, p300 = train_gap(got["train300"], refs["train300"])
    g300s, p300s = train_gap(got["train300"], refs["train300_split"])
    d = float(np.abs(got["streaming"][0] - refs["streaming"][0]).max())
    d_a = float(np.abs(got["streaming"][1]
                       - refs["streaming"][1]["Aterm"]).max())
    same = all(np.array_equal(r["train"][1][k], got["train"][1][k])
               for r in ranks[1:] for k in got["train"][1])
    launches = got["counts"]
    require_launched(f"{label}_pool", launches[f"{label}_pool"],
                     SPLIT_COUNTS[:2])
    require_launched(f"{label}_train", launches[f"{label}_train"],
                     SPLIT_COUNTS)
    require_launched(f"{label}_streaming", launches[f"{label}_streaming"],
                     ("LAUNCHES",))
    ok = (d_pool <= 1e-5 and g <= 1e-5 and p <= 1e-5 and d <= 1e-5
          and d_a <= 1e-5 and g300s <= 1e-5 and p300s <= 1e-5 and same)
    emit({"phase": label, "ranks": n, "devices": [str(x) for x in devices],
          "pool_gap": d_pool, "train_res": MESH_HELD_RES,
          "train_grad_gap_rel": g, "train_param_gap_rel": p,
          "train_loss": [got["train"][2]["loss"], refs["train"][2]["loss"]],
          "train300_vs_split_witness_grad_gap_rel": g300s,
          "train300_vs_split_witness_param_gap_rel": p300s,
          "train300_vs_whole_grad_gap_rel_reported": g300,
          "train300_vs_whole_param_gap_rel_reported": p300,
          "train300_loss": [got["train300"][2]["loss"],
                            refs["train300"][2]["loss"]],
          "streaming_probs_gap": d, "streaming_Aterm_gap": d_a,
          "tol": 1e-5, "ranks_params_bit_identical": same, "seconds": secs,
          "launches": launches, "ok": ok})
    if not ok:
        raise AssertionError(f"{label}: the ranks disagree with the world "
                             "of one")
    return ranks, launches


def mesh_phase(one, big, card):
    """The mesh phase (see MESH_POOL_T): the split entries, a world of one
    over NCCL against the single-card path, two ranks on cuda:0 over gloo
    against the world of one, their times, all from the seed-0 weights
    that every rank makes alike. Returns the kernels line's additions: the
    mesh paths' launch counts by path, the split entries' worst error and
    their times."""
    t_phase = time.perf_counter()
    split_err = check_split_pool()
    split_times = time_split_pool(card)
    model = amil.init_attention_mil(torch.Generator().manual_seed(0),
                                    amil.MILConfig())
    store = os.path.join(CACHE, "mesh_store")
    os.makedirs(store, exist_ok=True)
    refs, launches, ar_world1, audit_world1 = world_one(model, one, big,
                                                        store, 2, card)
    # two ranks on cuda:0; gloo, since they share the card
    ranks, gloo_launches = spawned_ranks("mesh_gloo2", 2, ["cuda:0"] * 2,
                                         one, big, refs, store)
    launches.update(gloo_launches)
    comm_audit_phase(ar_world1, ranks[0]["all_reduce_ms"], audit_world1,
                     card)
    emit({"phase": "mesh_all_reduce_time", "table": [3, 2],
          "world1_nccl_ms": ar_world1,
          "world2_gloo_ms": ranks[0]["all_reduce_ms"],
          "world2_gloo_ms_rank1": ranks[1]["all_reduce_ms"],
          "how": "host clock around 200 synchronised calls",
          "mesh_phase_seconds": time.perf_counter() - t_phase, **card})
    return launches, split_err, split_times


def mesh_cards(n):
    """``chip_smoke.py --mesh-cards N``, on a machine with N cards: one
    rank a card over NCCL (the axis rule's (slides, tiles) shape), the
    mesh's checks held to a world of one on cuda:0 exactly as the two
    ranks of the mesh phase are, with the all-reduce's time over the
    cards; then ``classify --mesh N`` and ``serve --mesh N`` against the
    same CLI runs on one card (:func:`mesh_cli`). Builds the pool kernel
    and the slides those runs read, and nothing else."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < n:
        sys.exit(f"chip_smoke: --mesh-cards {n} needs {n} CUDA devices")
    name, limit = [x.strip() for x in card_line().split(",", 1)]
    card = {"card": name, "power_limit": limit}
    print(f"{name}, {limit}", flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build("gated_pool")
    os.makedirs(CACHE, exist_ok=True)
    os.environ["CACHE_DIR"] = CACHE
    try:
        one, big = (built(nm, seed) for seed, nm in enumerate(SLIDES)
                    if nm in ("onepass", "stream"))
        slides = [("onepass", one.params["fullpath"]),
                  ("stream", big.params["fullpath"])]
        slides += [(nm, built(nm, 10 + i, spec).params["fullpath"])
                   for i, (nm, spec) in enumerate(SMALL_SLIDES.items())]
        model = amil.init_attention_mil(torch.Generator().manual_seed(0),
                                        amil.MILConfig())
        store = os.path.join(CACHE, "mesh_store")
        os.makedirs(store, exist_ok=True)
        refs, _, ar_world1, _ = world_one(model, one, big, store,
                                          n // mesh_mod.slide_axis(n), card)
        label = f"mesh_nccl{n}"
        ranks, launches = spawned_ranks(label, n, mesh_mod.mesh_devices(n),
                                        one, big, refs, store)
        flags = train_cohort(os.path.join(CACHE, "train"))
        mesh_cli(n, flags, cli_serve_inputs(model, slides), card)
    finally:
        shutil.rmtree(CACHE, ignore_errors=True)
    emit({"phase": "mesh_cards_all_reduce_time", "table": [3, 2],
          "mesh": {"slides": mesh_mod.slide_axis(n),
                   "tiles": n // mesh_mod.slide_axis(n)},
          "world1_nccl_ms": ar_world1,
          "tile_group_nccl_ms": [r["all_reduce_ms"] for r in ranks],
          "how": "host clock around 200 synchronised calls", **card})
    print(f"{name}, {limit}", flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


# ------------------------------------------------ the CLIs with --mesh N
# classify --mesh N and serve --mesh N on the card against the same CLI
# runs on one card. A world of one runs the same tile batches as one card,
# so it is held to 1e-5; more ranks split the ResNet's batches (see
# MESH_BAGS), so their probabilities and window metrics are held to the
# bf16 contract of 1e-3 and their checkpoints' and maps' gaps printed.
CLIS = {"classify": classify, "serve": serve}
CLI_DAEMON_ARGS = ["--roi_size", "300", "--resolution", "300", "--chunk",
                   "1024", "--settle_secs", "0", "--once"]


def cli_serve_inputs(model, slides):
    """The daemon runs' inputs under ``.smoke_cache/mesh_cli``: ``model``
    saved by the port's checkpoint writer, a manifest of the serving
    ``slides`` and one with a tile-less slide first (``--int8`` defers
    its calibration past it)."""
    root = os.path.join(CACHE, "mesh_cli")
    os.makedirs(root, exist_ok=True)
    ckpt = checkpoint.save(checkpoint.checkpoint_path(root, 0), model)
    empty = write_slide("empty", 99, (3, 3, 300, 9, 4))
    os.utime(empty, (1, 1))
    paths = {"all.txt": [p for _, p in slides],
             "int8.txt": [empty] + [p for _, p in slides]}
    for name, lines in paths.items():
        with open(os.path.join(root, name), "w") as f:
            f.write("".join(p + "\n" for p in lines))
    return ckpt, os.path.join(root, "all.txt"), os.path.join(root, "int8.txt")


def cli_calls(root, train_flags, serve_inputs, extra=(), test_ckpt=None):
    """The CLI runs under ``root``, each with ``extra`` (``--mesh N``), as
    (label, CLI, argv): the trainer at full width in bf16 (epoch 0 with
    its validation, epoch 1 resumed with ``--ckpt auto`` from the run's
    epoch-0 checkpoint, ``--test_only`` from ``test_ckpt``, by default
    the run's epoch 1; epoch 0 again in f32) and the daemon with
    ``--once`` over the serving
    manifest, one slide at a time, with ``--batch 4``, and with
    ``--int8`` behind a tile-less slide."""
    runs = os.path.join(root, "runs")
    common = [*TRAIN_ARGS, *train_flags, "--output_root", runs, *extra]
    ckpt, m_all, m_int8 = serve_inputs
    daemon = ["--ckpt", ckpt, *CLI_DAEMON_ARGS, *extra]
    test_ckpt = test_ckpt or checkpoint.checkpoint_path(
        os.path.join(runs, "run_E"), 1)
    return [
        ("train", "classify", ["--tag", "E", "--epoch_start", "0",
                               "--epoch_end", "0", *common]),
        ("train_f32", "classify", ["--tag", "F", "--epoch_start", "0",
                                   "--epoch_end", "0", "--f32", *common]),
        ("train_resume", "classify", ["--tag", "E", "--ckpt", "auto",
                                      "--epoch_start", "1", "--epoch_end",
                                      "1", *common]),
        ("test_only", "classify", ["--tag", "T", "--test_only", "--ckpt",
                                   test_ckpt, "--epoch_start", "1",
                                   *common]),
        ("serve", "serve", ["--manifest", m_all, "--out_root",
                            os.path.join(root, "serve"), *daemon]),
        ("serve_batch4", "serve", ["--manifest", m_all, "--out_root",
                                   os.path.join(root, "serve_batch4"),
                                   "--batch", "4", *daemon]),
        ("serve_int8", "serve", ["--manifest", m_int8, "--out_root",
                                 os.path.join(root, "serve_int8"), "--int8",
                                 *daemon])]


def run_cli_calls(calls):
    """Each call through its CLI's ``main`` on this process's card, its
    prints on stderr; returns the pool's launch counts of each."""
    counts = {}
    for label, cli, argv in calls:
        zero_pool_counts()
        with contextlib.redirect_stdout(sys.stderr):
            rc = CLIS[cli].main(argv)
        counts[label] = pool_counts()
        if rc != 0:
            raise AssertionError(f"{cli}.main({argv}) returned {rc}")
    return counts


def _cli_rank(mesh, calls, cache):
    """One rank of the CLIs' ``--mesh N``: each call in turn through the
    function that the CLI's ``main`` runs on every rank it launches for
    ``--mesh N`` (``classify._mesh_rank``, ``serve._mesh_rank``), with
    TF32 off as in this script, and a barrier after each (rank 0 writes
    what the next call reads). Returns each call's exit code and this
    rank's pool launch counts, zeroed before the call and read after."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    os.environ["CACHE_DIR"] = cache
    out = {}
    for label, cli, argv in calls:
        zero_pool_counts()
        with (contextlib.redirect_stdout(sys.stderr) if mesh.rank == 0
              else contextlib.nullcontext()):
            rc = CLIS[cli]._mesh_rank(mesh, argv)
        out[label] = (rc, pool_counts())
        dist.barrier()
    return out


def moments_gap(ref_run, got_run, epochs):
    """The trained checkpoints of two runs (``epochs``, one Adam step
    each), compared as :func:`train_gap` compares window steps: each
    step's gradient, recovered from Adam's first moment (``mu = 0.9 mu +
    0.1 g``), over max(1, max|g|), and the parameters over max(1, max|p|)
    wherever the reference's gradients of every step so far are above
    1e-6; the elements left out are counted, with their largest gap."""
    out = {}
    prev = None
    for epoch in epochs:
        a, b = (checkpoint.load_raw(checkpoint.checkpoint_path(r, epoch))
                for r in (ref_run, got_run))
        grads = {}
        g_gap = p_gap = free_gap = 0.0
        free = 0
        for key in (k for k in a if k.startswith("classifier/")):
            path = key[len("classifier/"):]
            mu_a, mu_b = (x[f"optimizer/mu/{path}"].astype(np.float64)
                          for x in (a, b))
            if prev is None:
                g_a, g_b = mu_a / 0.1, mu_b / 0.1
            else:
                g_a = (mu_a - 0.9 * prev[0][path]) / 0.1
                g_b = (mu_b - 0.9 * prev[1][path]) / 0.1
            grads[path] = (mu_a, mu_b, g_a)
            g_gap = max(g_gap, float(np.abs(g_b - g_a).max())
                        / max(1.0, float(np.abs(g_a).max())))
            determined = np.abs(g_a) > 1e-6
            if prev is not None:
                determined &= prev[2][path]
            d = np.abs(b[key].astype(np.float64) - a[key])
            scale = max(1.0, float(np.abs(a[key]).max()))
            p_gap = max(p_gap, float(d[determined].max(initial=0.0)) / scale)
            free += int((~determined).sum())
            free_gap = max(free_gap,
                           float(d[~determined].max(initial=0.0)) / scale)
        prev = ({p: v[0] for p, v in grads.items()},
                {p: v[1] for p, v in grads.items()},
                {p: np.abs(v[2]) > 1e-6 for p, v in grads.items()})
        out[f"epoch{epoch}"] = {"grad_gap_rel": g_gap, "param_gap_rel": p_gap,
                                "undetermined_elements": free,
                                "undetermined_param_gap_rel": free_gap,
                                "steps": int(b["optimizer/count"])}
    return out


def dla_gap(dir_a, dir_b, kind):
    """The largest difference between the ``.dla`` maps of ``kind``
    (``ATTN``, the first map min-max normalised, or ``ACTF``, the raw
    maps) of two daemon output directories, which must hold the same
    files."""
    def maps(d):
        return sorted(f for f in os.listdir(d)
                      if f.endswith(".dla") and f"-AGMIL-{kind}" in f)

    names = maps(dir_a)
    if not names or names != maps(dir_b):
        raise AssertionError(f"{dir_a} and {dir_b} hold other .dla maps")
    def table(path):
        with open(path) as fh:
            rows = [ln.split() for ln in fh.read().splitlines() if ln]
        return np.asarray(rows, np.float64).reshape(len(rows), 3)

    gap = 0.0
    for f in names:
        a, b = (table(os.path.join(d, f)) for d in (dir_a, dir_b))
        if a.shape != b.shape:
            raise AssertionError(f"{f}: {a.shape} against {b.shape}")
        if a.size:
            gap = max(gap, float(np.abs(a - b).max()))
    return gap


def mesh_cli(n, train_flags, serve_inputs, card):
    """``classify --mesh n`` and ``serve --mesh n`` (:func:`cli_calls`) on
    n launched ranks, one card each over NCCL, against the same runs on
    this process's card: the checkpoints of epochs 0 and 1 (the resumed
    one), the epoch-0 and ``--test_only`` summaries, and each daemon run's
    rows and ``.dla`` maps; every path's pool launches on rank 0 (the
    split entries in training and in ``--batch``'s groups, the one-call
    pool where every rank's share is gathered first). Returns those
    launches by path, ``mesh<n>_cli_<label>``."""
    root = os.path.join(CACHE, "mesh_cli")
    ref_root, got_root = (os.path.join(root, x) for x in ("one", f"mesh{n}"))
    ref_counts = run_cli_calls(cli_calls(ref_root, train_flags,
                                         serve_inputs))
    calls = cli_calls(got_root, train_flags, serve_inputs,
                      ("--mesh", str(n)), checkpoint.checkpoint_path(
                          os.path.join(ref_root, "runs", "run_E"), 1))
    t0 = time.perf_counter()
    got = mesh_mod.launch(_cli_rank, n, args=(calls, CACHE),
                          devices=mesh_mod.mesh_devices(n),
                          init_method="file://" + os.path.join(
                              root, f"store{n}"))[0]
    secs = time.perf_counter() - t0
    failed = {label: rc for label, (rc, _) in got.items() if rc != 0}
    if failed:
        raise AssertionError(f"--mesh {n}: exit codes {failed}")
    tol = 1e-5 if n == 1 else 1e-3
    ckpt = {tag: moments_gap(*(os.path.join(r, "runs", f"run_{tag}")
                               for r in (ref_root, got_root)), epochs)
            for tag, epochs in (("E", (0, 1)), ("F", (0,)))}

    def summary_gap(run, epoch, prefixes):
        """The worst gap of two runs' summary numbers, each over
        max(1, |reference|) (the KLD terms are sums of squared features
        in the tens), and its key."""
        a, b = (read_summary(os.path.join(r, "runs", run), epoch)
                for r in (ref_root, got_root))
        return max((abs(float(b[k]) - float(a[k]))
                    / max(1.0, abs(float(a[k]))), k) for k in a
                   if k.startswith(prefixes)
                   and isinstance(a[k], (int, float))
                   and not k.endswith(("_secs", "_bags")))

    # held: the window metrics (taken before the step), --test_only (one
    # checkpoint for both) and, on one rank, the f32 epoch's validation;
    # reported: the bf16 epoch's validation, after an Adam step that moves
    # the elements whose gradient is rounding by +-lr either way
    summaries = {"train_epoch0": summary_gap("run_E", 0, "train_"),
                 "f32_epoch0": summary_gap("run_F", 0, ("train_",
                                                        "valid_")),
                 "test_only": summary_gap("run_T", 1, "valid_")}
    valid_bf16 = summary_gap("run_E", 0, "valid_")
    rows = {}
    for label in ("serve", "serve_batch4", "serve_int8"):
        ra, rb = (read_rows(os.path.join(r, label))
                  for r in (ref_root, got_root))
        if sorted(ra) != sorted(rb) or any(
                (ra[k]["pred"], ra[k]["ntiles"])
                != (rb[k]["pred"], rb[k]["ntiles"]) for k in ra):
            raise AssertionError(f"--mesh {n} {label}: rows differ")
        dirs = [os.path.join(r, label) for r in (ref_root, got_root)]
        rows[label] = {"slides": len(rb), "probs_gap": max(
            float(np.abs(row_probs(rb[k]) - row_probs(ra[k])).max())
            for k in ra), "actf_gap": dla_gap(*dirs, "ACTF"),
            "attn_gap": dla_gap(*dirs, "ATTN")}
    launches = {f"mesh{n}_cli_{label}": counts
                for label, (_, counts) in got.items()}
    for label, kernels in (("train", SPLIT_COUNTS + ("LAUNCHES",)),
                           ("train_f32", SPLIT_COUNTS + ("LAUNCHES",)),
                           ("train_resume", SPLIT_COUNTS),
                           ("test_only", ("LAUNCHES",)),
                           ("serve", ("LAUNCHES",)),
                           ("serve_batch4", ("LAUNCHES", "PARTIAL_LAUNCHES",
                                             "FINISH_LAUNCHES")),
                           ("serve_int8", ("LAUNCHES",))):
        require_launched(f"mesh{n}_cli_{label}",
                         launches[f"mesh{n}_cli_{label}"], kernels)
    held = [rows[k]["probs_gap"] for k in rows] + [
        summaries["train_epoch0"][0], summaries["test_only"][0]]
    # more ranks hold the probabilities to the bf16 contract and print the
    # step's gap (see MESH_BAGS) and the maps': min-max normalising a
    # random model's near-uniform attention (ATTN) divides a bf16 change
    # by the attention's small range
    if n == 1:
        held += [rows[k][g] for k in rows for g in ("actf_gap", "attn_gap")]
        held += [summaries["f32_epoch0"][0]] + [
            v for run in ckpt.values() for e in run.values()
            for k, v in e.items() if k in ("grad_gap_rel", "param_gap_rel")]
    ok = max(held) <= tol and all(e["steps"] == i + 1
                                  for run in ckpt.values()
                                  for i, e in enumerate(run.values()))
    emit({"phase": f"mesh{n}_cli", "ranks": n,
          "backend": mesh_mod.backend_for(mesh_mod.mesh_devices(n)),
          "checkpoints": ckpt, "checkpoints_held": n == 1,
          "summaries_gap": summaries,
          "valid_bf16_epoch0_gap_reported": valid_bf16, "rows": rows,
          "tol": tol,
          "launches": launches, "single_card_launches": ref_counts,
          "launch_and_runs_s": secs, "ok": ok, **card})
    if not ok:
        raise AssertionError(f"--mesh {n}: the CLIs disagree with one card")
    return launches


# ------------------------------------------- the figures, the GAN, legacy
GAN_SEL = [0] + [1] * 8          # a style-mixing crossover after block 0
GAN_TRAIN_MAX = 64               # the progressive run: 8 -> 64 px
GAN_TRAIN_ITEMS = 1024           # four batches of 256 at every resolution
GAN_HI = 512                     # a few steps at the schedule's 512 px
GAN_HI_ACCUM = 2                 # batch 100 in two microbatches of 50
GAN_HI_BATCHES = 4
GAN_PARITY_STEPS = (1, 7)        # 8 px and 512 px, card vs CPU
GAN_TOL = 1e-4                   # card vs CPU, f32 with TF32 off


@contextlib.contextmanager
def pool_spy(limit=1, every=1):
    """Record the arguments of ``limit`` calls of the pool's forward and
    backward wrappers, each kind's calls 0, ``every``, 2 ``every``, ...
    (the calls still launch and count)."""
    seen = {"fwd": [], "bwd": []}
    calls = {"fwd": 0, "bwd": 0}
    real_f = gated_pool.gated_attention_pool
    real_b = gated_pool.gated_attention_pool_backward

    def keep(kind, args):
        if len(seen[kind]) < limit and calls[kind] % every == 0:
            seen[kind].append([None if a is None else a.detach().clone()
                               for a in args])
        calls[kind] += 1

    def fwd(*args):
        keep("fwd", args)
        return real_f(*args)

    def bwd(*args):
        keep("bwd", args)
        return real_b(*args)

    gated_pool.gated_attention_pool = fwd
    gated_pool.gated_attention_pool_backward = bwd
    try:
        yield seen
    finally:
        gated_pool.gated_attention_pool = real_f
        gated_pool.gated_attention_pool_backward = real_b


def pool_bwd_scales(a_raw, b, mask, weight_mask, a1t, dm=None, da1t=None,
                    dwrois=None):
    """The size of the pool backward's dA_raw and dw terms before they
    cancel: the plain closed form with dgated = (|dA1| + |sum_T dA1 * A1|)
    / denom in place of the difference, and dw's two gate terms added in
    absolute value. Returns ``(dA_raw scale, None, dw scale)``."""
    a1 = a1t.T
    act, g1, g0, gated = gated_pool._gated(a_raw, mask, weight_mask)
    denom = torch.clamp_min(gated.sum(dim=0, keepdim=True), 1e-12)
    da1 = gated_pool._da1(a1, b, dm, da1t, dwrois)
    m = mask[:, None]
    dgated = (da1.abs() + (da1 * a1).sum(dim=0, keepdim=True).abs()) / denom
    da_raw = dgated * g1 * m * torch.sigmoid(a_raw)
    dw = ((dgated * act * m).sum(dim=0) * 10.0 * g1 * (1.0 - g1)
          + (dgated * m).sum(dim=0) * 10.0 * g0 * (1.0 - g0))
    return da_raw, None, dw


def _equal_rows(args):
    """Whether every row of a pool call's A_raw and of its B is the same."""
    return all(bool((x == x[:1]).all()) for x in args[:2])


def hold_spied(label, seen):
    """The spied calls' kernels against the plain versions on the same
    inputs (the forward to 1e-5 / 1e-6, the backward to 1e-5 x max|ref|);
    these launches do not count. Where every row of A_raw and of B is the
    same (integrated gradients' zero baseline), the backward's dA_raw and
    dw are 0 in exact arithmetic and the kernel and the plain version each
    return their own float32 rounding of a cancelled difference: there
    they are held to 16 float32 epsilons of the size of their terms
    (``pool_bwd_scales``). Returns the worst absolute error."""
    counts = pool_counts()
    worst = 0.0
    for args in seen["fwd"]:
        got = gated_pool.gated_attention_pool(*args)
        want = gated_pool.gated_attention_pool_reference(*args)
        errs = [float((g - w).abs().max()) for g, w in zip(got, want)]
        if errs[0] > 1e-5 or max(errs[1:]) > 1e-6:
            raise AssertionError(f"{label}: the pool kernel disagrees "
                                 f"with its plain version: {errs}")
        worst = max(worst, *errs)
    for args in seen["bwd"]:
        got = gated_pool.gated_attention_pool_backward(*args)
        want = gated_pool.gated_attention_pool_backward_reference(*args)
        scales = pool_bwd_scales(*args) if _equal_rows(args) else (None,) * 3
        for g, w, sc in zip(got, want, scales):
            err = float((g - w).abs().max())
            bound = 1e-5 * max(float(w.abs().max()), 1e-30)
            if sc is not None:
                bound = max(bound, 16 * F32_EPS * float(sc.abs().max()))
            if err > bound:
                raise AssertionError(f"{label}: the pool backward kernel "
                                     "disagrees with its plain version: "
                                     f"{err} > {bound}")
            worst = max(worst, err)
    torch.cuda.synchronize()
    set_pool_counts(counts)
    return worst


def figures_phase(flags, one, card):
    """The figures' data on the card: ``Driver.visualize``'s whole-slide
    forward on the one-pass slide (its pool launch counted and held to
    the plain pool on the same inputs), ``activation_summary`` and
    ``activation_grids`` of 8 tiles at 300 px (held to the CPU's), and
    ``--peak`` / ``--n_vis 1``: refused naming matplotlib where it is
    missing, their files written where it is present."""
    root = os.path.join(CACHE, "figures")
    args = classify.build_argparser().parse_args(
        TRAIN_ARGS + flags + ["--output_root", root])
    driver = classify.Driver(args, classify.make_config(args), root)
    one.update_resolution_and_buffer(300)
    zero_pool_counts()
    with pool_spy() as seen:
        d = driver.visualize_data(one)
    launches = pool_counts()["LAUNCHES"]
    require_launched("figures_visualize", {"LAUNCHES": launches},
                     ("LAUNCHES",))
    err = hold_spied("figures_visualize", seen)
    finite = all(bool(np.isfinite(d[k]).all()) for k in ("A", "M", "F"))
    tiles = one.get_inference_data()[0][:8]
    stats = helpers.activation_summary(driver.model.cnn, tiles)
    grids = helpers.activation_grids(driver.model.cnn, tiles)
    cpu_cnn = resnet.ResNet26(embed_dim=driver.cfg.L, device="cpu")
    cpu_cnn.load_state_dict(driver.model.cnn.state_dict())
    cpu_grids = helpers.activation_grids(cpu_cnn, tiles.cpu())
    grid_gap = max(float(np.abs(grids[k] - cpu_grids[k]).max()
                         / max(np.abs(cpu_grids[k]).max(), 1e-30))
                   for k in grids)
    have = helpers.have_matplotlib()
    cli = {}
    for flag in (["--peak"], ["--n_vis", "1", "--epoch_end", "0"]):
        argv = TRAIN_ARGS + flags + ["--output_root", root, "--tag",
                                     "FIG", *flag]
        if have:
            run_trainer(argv)
            cli[flag[0]] = "ran"
        else:
            try:
                with contextlib.redirect_stdout(sys.stderr):
                    classify.main(argv)
            except SystemExit as e:
                if "matplotlib" not in str(e):
                    raise
                cli[flag[0]] = f"refused: {e}"
            else:
                raise AssertionError(f"{flag} ran without matplotlib")
    written = sorted(os.listdir(os.path.join(root, "run_FIG"))) if have \
        else []
    ok = finite and grid_gap <= 1e-4 and (not have or any(
        n.startswith("kernels-") for n in written))
    emit({"phase": "figures", "visualize_tiles": int(d["A"].shape[1]),
          "launches": launches, "pool_err_vs_plain": err,
          "finite": finite, "activation_layers": sorted(stats),
          "activation_grid_card_vs_cpu_rel": grid_gap, "tol_grid": 1e-4,
          "matplotlib": have, "cli": cli, "files": written[:20], "ok": ok,
          **card})
    if not ok:
        raise AssertionError("the figures' data is wrong")
    return launches, err


def _gan_nets(width=1.0, code=512, seed=0):
    init = torch.Generator().manual_seed(seed)
    g = sg.init_styled_generator(init, style_dim=code, width_mult=width)
    d = sg.init_discriminator(init, width_mult=width)
    return g, d


def _rel(a, b):
    a, b = a.detach().float().cpu(), b.detach().float().cpu()
    return float((a - b).abs().max() / max(float(b.abs().max()), 1e-30))


def gan_parity(card):
    """The full-width StyleGAN (code 512, the 8-layer MLP) on the card
    against the same modules on the CPU, f32 with TF32 off: G and D at
    8 and 512 px with alpha 0.5 and 1; one d_step and one g_step with the
    same draws at 8 px (losses, the critic's gradients through the
    gradient penalty, the parameters after Adam and the EMA); and a world
    of one over NCCL against the one card."""
    import copy

    g, d = _gan_nets()
    gc, dc = copy.deepcopy(g).cpu(), copy.deepcopy(d).cpu()
    gen = torch.Generator().manual_seed(1)
    fwd = {}
    with torch.no_grad():
        for step in GAN_PARITY_STEPS:
            zs = torch.randn((2, 2, 512), generator=gen)
            noise = sg.make_noise(gen, 2, step)
            x = torch.rand((2, 3, 4 * 2 ** step, 4 * 2 ** step),
                           generator=gen) * 2 - 1
            for alpha in (0.5, 1.0):
                want = sg.apply_styled_generator(gc, zs, noise, step=step,
                                                 alpha=alpha,
                                                 style_sel=GAN_SEL)
                got = sg.apply_styled_generator(
                    g, zs.cuda(), [n.cuda() for n in noise], step=step,
                    alpha=alpha, style_sel=GAN_SEL)
                dw = sg.apply_discriminator(dc, x, step=step, alpha=alpha)
                dg = sg.apply_discriminator(d, x.cuda(), step=step,
                                            alpha=alpha)
                fwd[f"step{step}_alpha{alpha}"] = [_rel(got, want),
                                                   _rel(dg, dw)]
    # one d_step and one g_step, the same draws on both devices
    step, B = 1, 8
    draws_d = gan.draw_d(gen, dc, B, step)
    draws_g = gan.draw_g(gen, dc, B, step)
    real = torch.rand((B, 3, 8, 8), generator=gen) * 2 - 1
    zs = torch.randn((2, B, 512), generator=gen)

    def on(tree, dev):
        return gan._rows(tree, slice(None)) if dev == "cpu" else \
            mesh_mod._to(tree, dev)

    def critic_grads(gm, dm, dev):
        terms = []
        _, aux = gan.d_loss(gm, dm, real.to(dev), zs.to(dev), GAN_SEL, 0.5,
                            on(draws_d, dev), step=step, sink=terms.append)
        grads = torch.autograd.grad(sum(terms), list(dm.parameters()),
                                    allow_unused=True)
        return aux, [torch.zeros_like(p) if gr is None else gr
                     for p, gr in zip(dm.parameters(), grads)]

    aux_c, grad_c = critic_grads(gc, dc, "cpu")
    aux_g, grad_g = critic_grads(g, d, "cuda")
    scale = max(1.0, max(float(x.abs().max()) for x in grad_c))
    grad_gap = max(float((a.cpu() - b).abs().max())
                   for a, b in zip(grad_g, grad_c)) / scale
    loss_gap = max(abs(float(aux_g[k]) - float(aux_c[k]))
                   / max(1.0, abs(float(aux_c[k]))) for k in aux_c)

    def steps_on(gm, dm, dev, mesh=None):
        """One d_step and one g_step; returns the critic's and the EMA's
        parameters, the generator's, each step's gradients (captured as
        Adam takes them) and the losses."""
        ema = copy.deepcopy(gm).requires_grad_(False)
        g_opt, d_opt = gan.make_optimizers(gm, dm)
        grads, real_step = [], gan._adam_step

        def capture(opt, lr):
            grads.append([torch.zeros_like(q) if q.grad is None
                          else q.grad.detach().cpu().clone()
                          for grp in opt.param_groups for q in grp["params"]])
            real_step(opt, lr)

        gan._adam_step = capture
        try:
            aux = gan.make_d_step(step, mesh=mesh)(
                gm, dm, d_opt, real.to(dev), zs.to(dev), GAN_SEL, 0.5, 1e-3,
                on(draws_d, dev))
            gl = gan.make_g_step(step, ema_decay=0.9, mesh=mesh)(
                gm, dm, g_opt, ema, zs.to(dev), GAN_SEL, 0.5, 1e-3,
                on(draws_g, dev))
        finally:
            gan._adam_step = real_step
        cpu = [[p.detach().cpu() for p in m.parameters()]
               for m in (dm, ema, gm)]
        # the generator's groups list the progression, then the style MLP:
        # the order of gm.parameters()
        return cpu, grads, float(aux["grad_penalty"]), float(gl)

    def gap(a, b, masks):
        return max(float((x - y).abs()[m].max()) if m.any() else 0.0
                   for x, y, m in zip(a, b, masks))

    pc = steps_on(copy.deepcopy(gc), copy.deepcopy(dc), "cpu")
    pg = steps_on(copy.deepcopy(g), copy.deepcopy(d), "cuda")
    # Adam's first step is lr x g / (|g| + eps): held where |g| > 1e-6,
    # where the gradient and not its rounding sets the sign
    det_d = [(x.abs() > 1e-6) | (x == 0) for x in pc[1][0]]
    det_g = [(x.abs() > 1e-6) | (x == 0) for x in pc[1][1]]
    param_gap = max(gap(pg[0][0], pc[0][0], det_d),
                    gap(pg[0][2], pc[0][2], det_g))
    ema_gap = gap(pg[0][1], pc[0][1], det_g)
    step_loss_gap = max(abs(pg[2] - pc[2]) / max(1.0, abs(pc[2])),
                        abs(pg[3] - pc[3]) / max(1.0, abs(pc[3])))
    undetermined = sum(int((~m).sum()) for m in det_d + det_g)
    if undetermined > 0.01 * sum(m.numel() for m in det_d + det_g):
        raise AssertionError(f"{undetermined} gradient elements at rounding "
                             "level")
    # a world of one over NCCL against the one card: the same steps
    store = os.path.join(CACHE, "gan_world1")
    os.makedirs(store, exist_ok=True)
    mesh_mod.init(1, 0, backend="nccl",
                  init_method="file://" + os.path.join(store, "one"))
    try:
        pw = steps_on(copy.deepcopy(g), copy.deepcopy(d), "cuda",
                      mesh=mesh_mod.data_mesh(device="cuda:0"))
    finally:
        dist.destroy_process_group()
    world1_gap = max(gap(pw[0][0], pg[0][0], det_d),
                     gap(pw[0][2], pg[0][2], det_g),
                     gap(pw[0][1], pg[0][1], det_g))
    fwd_worst = max(max(v) for v in fwd.values())
    ok = (fwd_worst <= GAN_TOL and grad_gap <= GAN_TOL
          and loss_gap <= GAN_TOL and param_gap <= 1e-5
          and ema_gap <= 1e-5 and step_loss_gap <= GAN_TOL
          and world1_gap <= 1e-6)
    emit({"phase": "gan_parity", "width_mult": 1.0, "code_size": 512,
          "n_mlp": 8, "tf32": False,
          "forward_rel_G_D_card_vs_cpu": fwd, "tol_forward_rel": GAN_TOL,
          "d_loss_gap_rel": loss_gap, "critic_grad_gap_rel": grad_gap,
          "gp_card": float(aux_g["grad_penalty"]),
          "steps_param_gap": param_gap, "steps_ema_gap": ema_gap,
          "steps_loss_gap_rel": step_loss_gap, "tol_steps": 1e-5,
          "steps_undetermined_elements": undetermined,
          "world1_nccl_vs_card_param_gap": world1_gap, "tol_world1": 1e-6,
          "ok": ok, **card})
    if not ok:
        raise AssertionError("the StyleGAN on the card disagrees with the "
                             "CPU or the world of one")


def instance_norm_bits(card):
    """``stylegan.instance_norm`` (one saved copy of x - mu) against the
    formula written out (``instance_norm_plain``), bit for bit: the output
    and x's gradient for a random cotangent, at every instance norm the
    full-width generator runs at 8 and 512 px (batch 2; its inputs
    captured in that forward), in f32 and under the bf16 autocast of the
    trainer's ``--compute_dtype bf16``. Also the bytes autograd keeps for
    the largest of them, each way."""
    t0 = time.perf_counter()
    g, _ = _gan_nets()
    gen = torch.Generator().manual_seed(3)
    real_norm, rows = sg.instance_norm, []

    def saved_bytes(fn, x):
        storages = {}

        def pack(t):
            st = t.untyped_storage()
            storages[st.data_ptr()] = st.nbytes()
            return t

        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            fn(x)
        return sum(storages.values())

    for step in GAN_PARITY_STEPS:
        for dtype in ("f32", "bf16"):
            seen = []

            def capture(x, eps=1e-5):
                seen.append(x.detach().clone())
                return real_norm(x, eps)

            zs = torch.randn((2, 2, 512), generator=gen).cuda()
            noise = [n.cuda() for n in sg.make_noise(gen, 2, step)]
            sg.instance_norm = capture
            try:
                with torch.no_grad(), gan._autocast(
                        "cuda", torch.bfloat16 if dtype == "bf16" else None):
                    sg.apply_styled_generator(g, zs, noise, step=step,
                                              alpha=1.0, style_sel=GAN_SEL)
            finally:
                sg.instance_norm = real_norm
            same = 0
            for x0 in seen:
                outs = []
                for fn in (sg.instance_norm_plain, sg.instance_norm):
                    x = x0.clone().requires_grad_(True)
                    with gan._autocast("cuda", torch.bfloat16
                                       if dtype == "bf16" else None):
                        y = fn(x)
                    cot = torch.randn(y.shape, generator=torch.Generator(
                        device="cuda").manual_seed(7), device="cuda",
                        dtype=y.dtype)
                    (gx,) = torch.autograd.grad(y, x, cot)
                    outs.append((y.detach(), gx))
                same += (torch.equal(outs[0][0], outs[1][0])
                         and torch.equal(outs[0][1], outs[1][1]))
            big = max(seen, key=lambda t: t.numel())
            x = big.clone().requires_grad_(True)
            with gan._autocast("cuda", torch.bfloat16
                               if dtype == "bf16" else None):
                kept = (saved_bytes(sg.instance_norm_plain, x),
                        saved_bytes(sg.instance_norm, x))
            rows.append({"px": 4 * 2 ** step, "dtype": dtype,
                         "norms": len(seen), "bit_identical": same,
                         "input_dtype": str(big.dtype).split(".")[-1],
                         "largest": list(big.shape),
                         "saved_bytes_plain_new": kept})
    ok = all(r["bit_identical"] == r["norms"] and r["norms"] > 0
             for r in rows)
    emit({"phase": "gan_instance_norm_bits", "rows": rows, "ok": ok,
          "seconds": time.perf_counter() - t0, **card})
    if not ok:
        raise AssertionError(f"instance_norm differs from its plain formula "
                             f"on the card: {rows}")


def _smooth_images(n, size, seed):
    """``n`` uint8 RGB images of a few low-frequency colour waves."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    base = torch.rand((n, 3, 8, 8), generator=g, device="cuda")
    img = F.interpolate(base, size=(size, size), mode="bicubic",
                        align_corners=False)
    img = (img.clamp(0, 1) * 255).round().to(torch.uint8)
    return img.permute(0, 2, 3, 1).contiguous().cpu().numpy()


def gan_store(name, n, size, seed):
    src = os.path.join(CACHE, f"{name}_src")
    os.makedirs(src)
    np.save(os.path.join(src, "tiles.npy"), _smooth_images(n, size, seed))
    out = os.path.join(CACHE, name)
    with contextlib.redirect_stdout(sys.stderr):
        gan_dataset._main(["--src", src, "--out", out, "--min-size", "8",
                           "--max-size", str(size)])
    return out


def run_gan(argv):
    with contextlib.redirect_stdout(sys.stderr):
        rc = gan.main(argv)
    torch.cuda.synchronize()
    if rc != 0:
        raise AssertionError(f"gan.main({argv}) returned {rc}")


def read_stats(out):
    with open(os.path.join(out, "train_stats.jsonl")) as f:
        return [json.loads(line) for line in f]


def gan_train(card):
    """The trainer CLI at full width (TF32 convolutions, PyTorch's default
    for cuDNN): 8 -> 64 px through --step_every 1 at the schedule's batch
    256, four batches an epoch, on a store the script writes; the resume
    of the last epoch from the previous epoch's checkpoint, bit-identical;
    four batches at 512 px (batch 100, --grad_accum 2); gan_generate from
    the 64 px checkpoint; export-gan then import-gan, bit-exact. Prints
    imgs/s, the critic and generator step times (median of the three
    steps after the first, timed with the trace of --profile left out)
    and the peak memory per resolution. Returns the 64 px checkpoint."""
    from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.utils import (
        profiling,
    )

    tf32, trace = torch.backends.cudnn.allow_tf32, profiling.trace
    torch.backends.cudnn.allow_tf32 = True
    profiling.trace = lambda *a, **kw: contextlib.nullcontext()
    try:
        t0 = time.perf_counter()
        store = gan_store("gan_store", GAN_TRAIN_ITEMS, GAN_TRAIN_MAX, 5)
        # a checkpoint at epoch 2 (the resume's start) and at the last
        common = ["--data_dir", store, "--init_size", "8", "--max_size",
                  str(GAN_TRAIN_MAX), "--step_every", "1", "--max_batches",
                  "4", "--mixing", "--profile", "--ckpt_every", "3"]
        out = os.path.join(CACHE, "gan_run")
        run_gan(common + ["--epochs", "4", "--output_dir", out])
        ckpt_dir = os.path.join(out, "checkpoint")
        resumed = os.path.join(CACHE, "gan_resume")
        run_gan(common + ["--epochs", "4", "--epoch_start", "3", "--ckpt",
                          os.path.join(ckpt_dir, "train_step-2.model"),
                          "--output_dir", resumed])
        a = checkpoint.load_raw(os.path.join(ckpt_dir, "train_step-3.model"))
        b = checkpoint.load_raw(os.path.join(resumed, "checkpoint",
                                             "train_step-3.model"))
        resume_same = sorted(a) == sorted(b) and all(
            np.array_equal(a[k], b[k]) for k in a)
        hi_store = gan_store("gan_store_hi", 100 * GAN_HI_BATCHES, GAN_HI, 6)
        hi = os.path.join(CACHE, "gan_hi")
        run_gan(["--data_dir", hi_store, "--init_size", str(GAN_HI),
                 "--max_size", str(GAN_HI), "--epochs", "1", "--max_batches",
                 str(GAN_HI_BATCHES), "--grad_accum", str(GAN_HI_ACCUM),
                 "--profile", "--output_dir", hi])
        gen_out = os.path.join(CACHE, "gan_generate")
        with contextlib.redirect_stdout(sys.stderr):
            gan_generate.main([os.path.join(ckpt_dir, "train_step-3.model"),
                               "--size", str(GAN_TRAIN_MAX), "--n_mixing",
                               "2", "--output_dir", gen_out])
        generated = sorted(os.listdir(gen_out))
        ckpt = os.path.join(ckpt_dir, "train_step-3.model")
        pt, back = os.path.join(CACHE, "gan_ref.pt"), \
            os.path.join(CACHE, "gan_back.model")
        with contextlib.redirect_stdout(sys.stderr):
            torch_interop.main(["export-gan", ckpt, pt])
            torch_interop.main(["import-gan", pt, back])
        c = checkpoint.load_raw(back)
        params = [k for k in a if k.split("/")[0] in
                  ("generator", "discriminator", "g_running")]
        round_trip = (sorted(params) == sorted(
            k for k in c if not k.startswith("extra/"))
            and all(np.array_equal(a[k], c[k]) for k in params))
        rows = []
        for stats in (read_stats(out), read_stats(hi)):
            for r in stats:
                timed_s = r["step_s"][1:]
                d_s = r["d_step_s"][1:]
                g_s = [t - u for t, u in zip(timed_s, d_s)]
                rows.append({
                    "resolution": r["resolution"], "batch": r["batch"],
                    "grad_accum": r["grad_accum"],
                    "imgs_per_s": r["batch"] / statistics.median(timed_s),
                    "d_step_ms": 1e3 * statistics.median(d_s),
                    "g_step_ms": 1e3 * statistics.median(g_s),
                    "step_ms": 1e3 * statistics.median(timed_s),
                    "peak_mem_gb": r["peak_mem_bytes"] / 1e9})
        ok = (resume_same and round_trip and "sample.png" in generated
              and len(rows) == 5
              and all(np.isfinite(r["imgs_per_s"]) for r in rows))
        emit({"phase": "gan_train", "width_mult": 1.0, "code_size": 512,
              "conv_tf32": True, "compute_dtype": "f32",
              "cudnn_deterministic": True, "by_resolution": rows,
              "resume_bit_identical": resume_same,
              "export_import_gan_bit_exact": round_trip,
              "generated": generated,
              "seconds": time.perf_counter() - t0, "ok": ok, **card})
        if not ok:
            raise AssertionError("the GAN trainer's run failed its checks")
        return ckpt
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
        profiling.trace = trace


def _kind(name):
    n = name.lower()
    for kind, keys in (("conv_gemm", ("conv", "xmma", "gemm", "implicit",
                                      "winograd", "cutlass", "dgrad",
                                      "wgrad")),
                       ("copy", ("memcpy", "memset", "copy")),
                       ("reduce", ("reduce",)),
                       ("elementwise", ("elementwise", "vectorized",
                                        "unrolled"))):
        if any(k in n for k in keys):
            return kind
    return "other"


def _gan_steps(step, B):
    """A full-width critic step and a critic + generator step (Adam and the
    EMA, as the trainer takes them) at ``step``'s resolution, on a seeded
    random batch of ``B``, drawing each step's latents and noise."""
    g, d = _gan_nets()
    gen = torch.Generator(device="cuda").manual_seed(7)
    size = 4 * 2 ** step
    real = torch.rand((B, 3, size, size), generator=gen,
                      device="cuda") * 2 - 1
    g_opt, d_opt = gan.make_optimizers(g, d)
    ema = copy.deepcopy(g).requires_grad_(False)
    d_step, g_step = gan.make_d_step(step), gan.make_g_step(step)

    def critic():
        zs = torch.randn((2, B, 512), generator=gen, device="cuda")
        d_step(g, d, d_opt, real, zs, GAN_SEL, 1.0, 1e-3,
               gan.draw_d(gen, d, B, step))

    def both():
        critic()
        zs = torch.randn((2, B, 512), generator=gen, device="cuda")
        g_step(g, d, g_opt, ema, zs, GAN_SEL, 1.0, 1e-3,
               gan.draw_g(gen, d, B, step))

    return critic, both


def gan_step_costs(card):
    """One full-width 32 px step (batch 256, critic then generator) timed
    in turns in three settings: the trainer's on the card (TF32
    convolutions, cuDNN's deterministic algorithms), strict f32, and TF32
    without the determinism; then one traced critic step of the trainer's
    setting: its device time by kernel kind, the double backward's share
    (the device time under ``ConvolutionBackwardBackward0``) and the
    device's busy share of the step's wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    B = 256
    critic, step_both = _gan_steps(3, B)

    def both():
        step_both()
        torch.cuda.synchronize()

    cudnn = torch.backends.cudnn
    settings = {"tf32_deterministic": (True, True),
                "f32_deterministic": (False, True),
                "tf32_nondeterministic": (True, False)}
    times = {k: [] for k in settings}
    saved = (cudnn.allow_tf32, cudnn.deterministic)
    try:
        for _ in range(2):  # in turns, each after a warm step
            for key, (tf32, det) in settings.items():
                cudnn.allow_tf32, cudnn.deterministic = tf32, det
                both()
                t0 = time.perf_counter()
                both()
                times[key].append(time.perf_counter() - t0)
        cudnn.allow_tf32, cudnn.deterministic = True, True
        both()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            critic()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        cudnn.allow_tf32, cudnn.deterministic = saved
    by_kind = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            k = _kind(e.name)
            by_kind[k] = by_kind.get(k, 0.0) + (
                e.time_range.end - e.time_range.start) / 1e3
    busy = sum(by_kind.values())
    dbl = sum(getattr(e, "device_time_total", None)
              or getattr(e, "cuda_time_total", 0.0)
              for e in prof.key_averages()
              if e.key == "ConvolutionBackwardBackward0") / 1e3
    emit({"phase": "gan_step_costs", "resolution": 32, "batch": B,
          "width_mult": 1.0, "step_s": times,
          "critic_trace": {"wall_ms": wall * 1e3, "device_busy_ms": busy,
                           "device_busy_share": busy / (wall * 1e3),
                           "by_kind_ms": by_kind,
                           "double_backward_conv_ms": dbl},
          **card})
    if busy <= 0:
        raise AssertionError("the traced critic step ran nothing on the "
                             "card")


def legacy_phase(flags, gan_ckpt, card):
    """``classify_legacy.main`` on the training cohort at 64 px over the
    64 px run's critic (--gan_ckpt, cut at 6 blocks: the whole 64 px
    critic, 512 features): one epoch, then --test_only from its
    checkpoint; the pool's forward and backward launches counted, the
    first of each held to the plain pool, and the .dla maps written."""
    root = os.path.join(CACHE, "legacy")
    common = flags + ["--roi_size", str(TRAIN_ROI), "--resolution", "64",
                      "--gan_ckpt", gan_ckpt, "--output_root", root]
    t0 = time.perf_counter()
    zero_pool_counts()
    with pool_spy() as seen, contextlib.redirect_stdout(sys.stderr):
        rc = classify_legacy.main(common + ["--epoch_start", "0",
                                            "--epoch_end", "1"])
    train_counts = pool_counts()
    if rc != 0:
        raise AssertionError(f"classify_legacy returned {rc}")
    require_launched("legacy_train", train_counts,
                     ("LAUNCHES", "BWD_LAUNCHES"))
    err = hold_spied("legacy_train", seen)
    (run,) = [n for n in os.listdir(root) if n.startswith("run_")]
    ckpt = os.path.join(root, run, "train_step-000.model")
    zero_pool_counts()
    with contextlib.redirect_stdout(sys.stderr):
        rc = classify_legacy.main(common + ["--test_only", "--ckpt", ckpt])
    test_counts = pool_counts()
    if rc != 0:
        raise AssertionError(f"classify_legacy --test_only returned {rc}")
    require_launched("legacy_test", test_counts, ("LAUNCHES",))
    maps = [n for n in os.listdir(os.path.join(root, "test_data"))
            if n.endswith(".dla")]
    blob = checkpoint.load_raw(ckpt)
    finite = all(np.isfinite(v).all() for k, v in blob.items()
                 if k.startswith("classifier/"))
    ok = finite and len(maps) == 4 * len(TRAIN_COHORT)
    emit({"phase": "legacy", "resolution": 64, "disc_cutoff": 6,
          "features": int(blob["classifier/context/gamma"].shape[0]),
          "launches": {"legacy_train": train_counts,
                       "legacy_test": test_counts},
          "pool_err_vs_plain": err, "dla_maps": len(maps),
          "adam_count": int(blob["optimizer/count"]), "finite": finite,
          "seconds": time.perf_counter() - t0, "ok": ok, **card})
    if not ok:
        raise AssertionError("the legacy classifier's run failed its checks")
    return train_counts, test_counts, err


# ------------------------------------------------------- the auxiliary modules
AUX_TOL = 1e-4                   # card vs CPU, relative, f32 with TF32 off
AUX_TARGET = 0                   # the fc output (of embed_dim) explained
AUX_IG_STEPS = 100
AUX_SG_DRAWS = 50
AUX_HEAD_IG_STEPS = 20
AUX_ASCEND_STEPS = 3             # the optimisers' loops held card vs CPU
AUX_ALT = (("resnet18", alt_resnet.resnet18),
           ("resnet34", alt_resnet.resnet34))
AUX_ALT_BATCH, AUX_ALT_PX = 32, 224
AUX_WAE_BATCH, AUX_WAE_PX = 4, 512
# the reference's LatentUNet: 1024*8*8 -> 1024 at 128 px, depth 5
AUX_UNET = {"depth": 5, "start_filts": 64, "input_size": 128,
            "latent_dim": 1024}
AUX_UNET_BATCH = 8
AUX_CLUSTERS = 10


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _check_close(label, gaps, tol=AUX_TOL):
    bad = {k: v for k, v in gaps.items() if not v <= tol}
    if bad:
        raise AssertionError(f"{label}: card vs CPU beyond {tol}: {bad}")


def _once(fn):
    """``fn()`` and its seconds, the card synchronised around it."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _grad_gap(model, ref):
    """The worst parameter gradient's max abs gap from ``ref``'s, over the
    largest max |gradient| of ``ref``'s parameters (one scale for the
    model: a leaf whose gradient is near zero is not held relative to
    itself). An unused parameter's gradient counts as zero."""
    def grads(m):
        return [torch.zeros_like(p) if p.grad is None else p.grad
                for p in m.parameters()]

    got, want = grads(model), grads(ref)
    scale = max(float(w.abs().max()) for w in want)
    return max(float((g.cpu() - w).abs().max()) for g, w in zip(got, want)
               ) / max(scale, 1e-30)


def _rel64(a, b):
    """``_rel`` in float64 (its float32 cast would floor a float64 gap at
    float32's rounding)."""
    a, b = a.detach().double().cpu(), b.detach().double().cpu()
    return float((a - b).abs().max() / max(float(b.abs().max()), 1e-300))


def _f64_row(card64, cpu64, card32, cpu32, gap=_rel64):
    """An output that float32 cannot hold card vs CPU: the card's float64
    result against the CPU's (held to ``AUX_TOL`` by ``_check_f64``), and
    each float32 result's distance from the CPU's float64 (printed)."""
    return {"card_vs_cpu_f64": gap(card64, cpu64),
            "card_f32_vs_f64": gap(card32, cpu64),
            "cpu_f32_vs_f64": gap(cpu32, cpu64)}


def _check_f64(label, rows):
    bad = {k: v for k, v in rows.items()
           if not v["card_vs_cpu_f64"] <= AUX_TOL}
    if bad:
        raise AssertionError(f"{label}: card vs CPU in float64 beyond "
                             f"{AUX_TOL}: {bad}")


def aux_interpret(cnn, raw, card):
    """The interpretability kit through the trained full-width ResNet-26 on
    one 300 px tile of the serving slide's cache, TF32 off, on the card
    and on the CPU (the same module copied there): Grad-CAM at the five
    taps, guided Grad-CAM, guided backprop and its layer variant, vanilla
    backprop and grad x image, in float32, held to ``AUX_TOL``; integrated
    gradients (100 steps), smooth-grad (50 draws from one CPU generator,
    so every run adds the same noise) and the four optimisers' loops after
    ``AUX_ASCEND_STEPS`` steps from one start, held to ``AUX_TOL`` in
    float64 on both devices (``_f64_row``), their float32 results printed
    beside; the optimisers also run on the card in float32 at their
    default steps (finite histories).

    Why float64 there: a LeakyReLU input within rounding of 0 routes a
    float32 gradient by the summation order, on either device. Along
    integrated gradients' path and under smooth-grad's noise (std 4 /
    range) the CPU's own float32 result lies 1e-3..1e-2 from float64, and
    one such flip in an optimiser's lr-6 or lr-12 step moved its image by
    19 % after three steps on an H100 against the CPU."""
    cpu = copy.deepcopy(cnn).cpu()
    card64, cpu64 = copy.deepcopy(cnn).double(), copy.deepcopy(cpu).double()
    tile = transforms.eval_transform(torch.from_numpy(raw).cuda(),
                                     resolution=300)
    tile_cpu = tile.cpu()
    gaps, to_f64, secs = {}, {}, {}

    def score(m):
        return saliency.class_score_fn(resnet.apply_resnet26, m, AUX_TARGET)

    def on_card(name, fn):
        out, secs[name] = _once(lambda: fn(cnn, tile))
        if not bool(torch.isfinite(out).all()):
            raise AssertionError(f"aux {name}: not finite")
        return out

    def held(name, fn):
        gaps[name] = _rel(on_card(name, fn), fn(cpu, tile_cpu))

    def held_f64(name, fn):
        to_f64[name] = _f64_row(fn(card64, tile.double()),
                                fn(cpu64, tile_cpu.double()),
                                on_card(name, fn), fn(cpu, tile_cpu))

    for layer in gradcam.LAYER_ORDER:
        held(f"gradcam_{layer}", lambda m, x, layer=layer: gradcam.gradcam(
            m, x, AUX_TARGET, layer))
    held("guided_gradcam", lambda m, x: gradcam.guided_gradcam(
        m, x, AUX_TARGET))
    held("guided_backprop", lambda m, x: guided.guided_backprop(
        m, x, AUX_TARGET))
    held("layer_activation_guided_backprop",
         lambda m, x: guided.layer_activation_guided_backprop(
             m, x, "stage2", 3))
    held("vanilla_backprop", lambda m, x: saliency.vanilla_backprop(
        score(m), x))
    held("grad_times_image", lambda m, x: saliency.grad_times_image(
        score(m), x))
    held_f64("integrated_gradients",
             lambda m, x: saliency.integrated_gradients(
                 score(m), x, steps=AUX_IG_STEPS))
    held_f64("smooth_grad", lambda m, x: saliency.smooth_grad(
        lambda v: saliency.vanilla_backprop(score(m), v), x, _gen(5),
        param_n=AUX_SG_DRAWS))
    gradcam_ms = time_cuda(lambda: gradcam.gradcam(cnn, tile, AUX_TARGET), 10)

    # the optimisers' loops, the same start on both devices
    img = misc.preprocess_image(raw[0])
    target_x = torch.from_numpy(img)
    with torch.no_grad():
        target = resnet.apply_resnet26(cpu, target_x, taps=True)[1]["stage2"]
    loops = {
        "cnn_layer_visualization": (
            lambda m, t: optimize.filter_loss(m, "stage1", 2), 1.0,
            optimize._uniform(_gen(6), (1, 56, 56, 3), -0.14, 0.14, "cpu")),
        "deep_dream": (lambda m, t: optimize.filter_loss(m, "stage3", 1),
                       12.0, target_x),
        "inverted_representation": (
            lambda m, t: optimize.inversion_loss(
                m, t, "stage2", alpha_reg_alpha=6.0, alpha_reg_lambda=1e-2,
                tv_reg_beta=3.0, tv_reg_coeff=1e-2), 1e-2,
            0.1 * optimize._uniform(_gen(7), tuple(target_x.shape), 0.0,
                                    1.0, "cpu")),
        "class_specific_image_generation": (
            lambda m, t: optimize.class_loss(m, AUX_TARGET, 1e-4,
                                             resnet.apply_resnet26), 6.0,
            optimize._uniform(_gen(8), (1, 56, 56, 3), -1.0, 1.0, "cpu")),
    }
    for name, (loss, lr, x0) in loops.items():
        runs = [optimize._ascend(loss(m, t), x, steps=AUX_ASCEND_STEPS, lr=lr)
                for m, t, x in (
                    (card64, target.double().cuda(), x0.double().cuda()),
                    (cpu64, target.double(), x0.double()),
                    (cnn, target.cuda(), x0.cuda()), (cpu, target, x0))]
        to_f64[f"{name}_x"] = _f64_row(*(x for x, _ in runs))
        to_f64[f"{name}_loss"] = _f64_row(*(torch.tensor(h)
                                            for _, h in runs))
    del card64, cpu64
    defaults = {}
    for name, fn in (
            ("cnn_layer_visualization",
             lambda: optimize.cnn_layer_visualization(cnn, "stage1", 2)),
            ("deep_dream", lambda: optimize.deep_dream(cnn, raw[0],
                                                       "stage3", 1)),
            ("inverted_representation",
             lambda: optimize.inverted_representation(cnn, raw[0],
                                                      "stage2")),
            ("class_specific_image_generation",
             lambda: optimize.class_specific_image_generation(
                 cnn, AUX_TARGET))):
        (image, hist), secs[name] = _once(fn)
        if not np.isfinite(hist).all() or image.dtype != np.uint8:
            raise AssertionError(f"aux {name}: non-finite loss history")
        defaults[name] = {"steps": len(hist), "first_loss": hist[0],
                          "last_loss": hist[-1], "shape": list(image.shape)}
    emit({"phase": "aux_interpret", "tile_px": 300, "target": AUX_TARGET,
          "ig_steps": AUX_IG_STEPS, "smooth_grad_draws": AUX_SG_DRAWS,
          "ascend_steps_held": AUX_ASCEND_STEPS,
          "card_vs_cpu_rel": gaps, "f64_rows": to_f64, "tol": AUX_TOL,
          "gradcam_ms_a_tile": gradcam_ms,
          "integrated_gradients_s": secs["integrated_gradients"],
          "smooth_grad_s": secs["smooth_grad"], "seconds": secs,
          "optimisers_at_defaults": defaults, **card})
    _check_close("aux_interpret", gaps)
    _check_f64("aux_interpret", to_f64)
    return gaps, to_f64


def aux_head_saliency(model, cfg, one, card):
    """``saliency.vanilla_backprop`` and ``integrated_gradients``
    (``AUX_HEAD_IG_STEPS``) of ``attention_pool(model, H, cfg)["logits"][0,
    c]`` with respect to ``H``, the trained extractor's f32 features of the
    2000-tile one-pass slide: each call launches the gated pool's forward
    and backward kernels. Every launch is held to the plain pool on its
    inputs; the saliencies to the CPU's; the pool kernels' device time in
    one saliency call. Returns the launch counts and the worst kernel
    error."""
    one.update_resolution_and_buffer(300)
    tiles = one.get_inference_data()[0]
    with torch.no_grad():
        H = resnet.apply_resnet26(model.cnn, tiles).float()
    del tiles

    def score(m):
        return lambda h: amil.attention_pool(m, h, cfg)["logits"][
            0, AUX_TARGET]

    calls = 1 + AUX_HEAD_IG_STEPS
    zero_pool_counts()
    with pool_spy(limit=calls) as seen:
        (g, ig), secs = _once(lambda: (
            saliency.vanilla_backprop(score(model), H),
            saliency.integrated_gradients(score(model), H,
                                          steps=AUX_HEAD_IG_STEPS)))
    counts = pool_counts()
    if counts["LAUNCHES"] != calls or counts["BWD_LAUNCHES"] != calls:
        raise AssertionError(f"aux_head_saliency: {counts} launches for "
                             f"{calls} saliency calls")
    err = hold_spied("aux_head_saliency", seen)
    flat = sum(map(_equal_rows, seen["bwd"]))
    cpu = copy.deepcopy(model).cpu()
    Hc = H.cpu()
    gaps = {"vanilla_backprop": _rel(g, saliency.vanilla_backprop(
        score(cpu), Hc)),
        "integrated_gradients": _rel(ig, saliency.integrated_gradients(
            score(cpu), Hc, steps=AUX_HEAD_IG_STEPS))}
    ms, how = device_ms(lambda: saliency.vanilla_backprop(score(model), H),
                        20, match="gated_pool_")
    set_pool_counts(counts)
    emit({"phase": "aux_head_saliency", "T": int(H.shape[0]),
          "L": int(H.shape[1]), "calls": calls, "launches": counts,
          "pool_err_vs_plain": err, "backward_calls_with_equal_rows": flat,
          "card_vs_cpu_rel": gaps, "tol": AUX_TOL,
          "seconds": secs, "pool_device_us_a_call": 1e3 * ms,
          **ms_how(how, "pool_device"), **card})
    _check_close("aux_head_saliency", gaps)
    return counts, err


def aux_models(card):
    """The auxiliary models at the reference's sizes, seeded, on the card
    against the same modules on the CPU (f32, TF32 off): resnet18 and
    resnet34 (1000 classes) at 224 px, batch 32; the WAE encoder and
    decoder at 512 px (latent 8, six pooling levels), batch 4, and the
    critic on the 512-d latents; the LatentUNet at 128 px (depth 5,
    start_filts 64: the 1024*8*8 -> 1024 latent), batch 8, full and
    ``early_stop``, with a cluster layer on its latents; one backward of a
    reconstruction loss through the WAE and through the LatentUNet, whose
    gradients (and the LatentUNet's output) are held in float64 on both
    devices (``_f64_row``). Each forward is timed on the card (imgs/s)."""
    gaps, rates = {}, {}

    def forward(name, model, x, fn=None):
        fn = fn or (lambda m, v: m(v))
        cpu = copy.deepcopy(model).cpu()
        xc = x.cuda()
        with torch.no_grad():
            out, ref = fn(model, xc), fn(cpu, x)
            ms = time_cuda(lambda: fn(model, xc), 3, warmup=1)
        rates[name] = x.shape[0] / (ms / 1e3)
        return out, ref, cpu

    for name, build in AUX_ALT:
        m = build(_gen(1))
        x = torch.randn((AUX_ALT_BATCH, AUX_ALT_PX, AUX_ALT_PX, 3),
                        generator=_gen(2))
        out, ref, _ = forward(name, m, x)
        gaps[name] = _rel(out, ref)
        del m

    enc, dec = wae.init_encoder(_gen(3)), wae.init_decoder(_gen(4))
    crit = wae.init_wae_discriminator(_gen(5))
    x = torch.randn((AUX_WAE_BATCH, AUX_WAE_PX, AUX_WAE_PX, 3),
                    generator=_gen(6))
    z, z_ref, enc_cpu = forward("wae_encoder", enc, x)
    img, img_ref, dec_cpu = forward("wae_decoder", dec, z.cpu())
    score, score_ref, crit_cpu = forward("wae_discriminator", crit, z.cpu())
    gaps.update(wae_encoder=_rel(z, z_ref), wae_decoder=_rel(img, img_ref),
                wae_discriminator=_rel(score, score_ref))
    # the reconstruction losses' gradients through batch-statistics BNs,
    # and the LatentUNet's output after its ten BNs, cancel: the CPU's own
    # float32 lies 1e-4..2e-2 from float64 at these sizes: held in
    # float64 on both devices (``_f64_row``)
    to_f64 = {}
    nets = {"card64": (copy.deepcopy(enc).double(),
                       copy.deepcopy(dec).double(), x.double().cuda()),
            "cpu64": (copy.deepcopy(enc_cpu).double(),
                      copy.deepcopy(dec_cpu).double(), x.double()),
            "card32": (enc, dec, x.cuda()), "cpu32": (enc_cpu, dec_cpu, x)}
    for e, d, v in nets.values():
        ((d(e(v)) - v) ** 2).mean().backward()
    for i, part in enumerate(("wae_encoder_backward",
                              "wae_decoder_backward")):
        to_f64[part] = _f64_row(*(n[i] for n in nets.values()),
                                gap=_grad_gap)
    del enc, dec, crit, enc_cpu, dec_cpu, crit_cpu, nets

    net = unet.init_latent_unet(_gen(7), **AUX_UNET)
    px = AUX_UNET["input_size"]
    x = torch.randn((AUX_UNET_BATCH, px, px, 3), generator=_gen(8))
    (_, latent, _), (_, latent_r, _), net_cpu = forward(
        "latent_unet", net, x, unet.apply_latent_unet)
    (bottom, _, _), (bottom_r, _, _), _ = forward(
        "latent_unet_early_stop", net, x,
        lambda m, v: unet.apply_latent_unet(m, v, early_stop=True))
    nets = {"card64": (copy.deepcopy(net).double(), x.double().cuda()),
            "cpu64": (copy.deepcopy(net_cpu).double(), x.double()),
            "card32": (net, x.cuda()), "cpu32": (net_cpu, x)}
    with torch.no_grad():
        to_f64["latent_unet"] = _f64_row(*(
            unet.apply_latent_unet(m, v)[0] for m, v in nets.values()))
    gaps.update(latent_unet_latent=_rel(latent, latent_r),
                latent_unet_early_stop=_rel(bottom, bottom_r))
    clusters = unet.init_cluster_layer(_gen(9), AUX_CLUSTERS,
                                       dim=AUX_UNET["latent_dim"])
    with torch.no_grad():
        inertia, xe, cl = unet.apply_cluster_layer(clusters, latent)
        inertia_r, xe_r, cl_r = unet.apply_cluster_layer(
            copy.deepcopy(clusters).cpu(), latent_r)
    gaps.update(cluster_inertia=_rel(inertia, inertia_r),
                cluster_cross_term=_rel(xe, xe_r))
    same_assignments = bool(torch.equal(cl.cpu(), cl_r))
    for m, v in nets.values():
        ((unet.apply_latent_unet(m, v)[0] - v) ** 2).mean().backward()
    to_f64["latent_unet_backward"] = _f64_row(*(m for m, _ in nets.values()),
                                              gap=_grad_gap)
    emit({"phase": "aux_models", "card_vs_cpu_rel": gaps, "tol": AUX_TOL,
          "f64_rows": to_f64,
          "imgs_per_s": rates, "cluster_assignments_equal": same_assignments,
          "sizes": {"alt_resnet": [AUX_ALT_BATCH, AUX_ALT_PX],
                    "wae": [AUX_WAE_BATCH, AUX_WAE_PX],
                    "latent_unet": [AUX_UNET_BATCH, AUX_UNET]},
          **card})
    _check_close("aux_models", gaps)
    _check_f64("aux_models", to_f64)
    if not same_assignments:
        raise AssertionError("aux_models: the cluster assignments differ")
    return gaps


def _cell_tree(root):
    """Three synthetic IHC cells (96 px RGB JPEGs with a cell mask and a
    nucleus mask as PNGs, Pillow-written) and a driver CSV in pandas'
    ``to_csv`` layout (an unnamed index column first)."""
    from PIL import Image

    os.makedirs(root, exist_ok=True)
    rng = np.random.default_rng(0)
    paths = []
    for i in range(3):
        stem = os.path.join(root, f"c77_{10 + i}_{20 + i}_30_40_")
        raw = rng.integers(0, 256, (96, 96, 3), np.uint8)
        cell = np.full((96, 96), 255, np.uint8)
        cell[:, :40] = 0
        nucleus = np.zeros((96, 96), np.uint8)
        nucleus[50:70, 50:70] = 255
        Image.fromarray(raw).save(stem + "wholecell-raw.png.jpg")
        Image.fromarray(cell).save(stem + "wholecell-mask.png")
        Image.fromarray(nucleus).save(stem + "nucleus-mask.png")
        paths.append(stem + "wholecell-raw.png.jpg")
    driver = os.path.join(root, "driver.csv")
    with open(driver, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["", "image_path", "label"])
        for i, (path, label) in enumerate(zip(paths + paths[:1],
                                              (0, 1, 0, 1))):
            w.writerow([i, path, label])
    return root + os.sep, paths, driver


def aux_cells(card):
    """Stain deconvolution and the four cell / IHC datasets on the card's
    machine, which has neither cv2 nor pandas: Pillow reads the images,
    the ``csv`` module the driver CSV. A masked cell equals the mask
    applied by hand to Pillow's decode; two datasets of one seed give the
    same items; ``apply_colormap_on_image`` runs where matplotlib is
    installed and is refused, naming it, where it is not; ``save_image``
    writes through Pillow."""
    from PIL import Image

    t0 = time.perf_counter()
    root, paths, driver = _cell_tree(os.path.join(CACHE, "aux_cells"))
    rng = np.random.default_rng(1)
    rgb = rng.random((64, 64, 3)) * 0.9 + 0.05
    roundtrip = float(np.abs(stain.hed2rgb(stain.rgb2hed(rgb)) - rgb).max())
    ds = cell_datasets.CellImageDataset(root)
    by_hand = {}
    for p in paths:
        raw = np.asarray(Image.open(p).convert("RGB"))
        keep = np.zeros((96, 96), bool)
        keep[:, 40:] = True
        keep[50:70, 50:70] = False
        by_hand[p] = np.where(keep[..., None], raw, 0).astype(np.uint8)
    order = glob.glob(root + "*wholecell-raw.png.jpg")   # the order read
    masked_ok = len(ds) == 3 and all(
        np.array_equal(ds.data_store[i], by_hand[p])
        for i, p in enumerate(order))
    he_a = cell_datasets.CellImageDatasetHE(root, seed=0)
    he_b = cell_datasets.CellImageDatasetHE(root, seed=0)
    items_a, items_b = [he_a[i] for i in range(3)], [he_b[i] for i in range(3)]
    he_ok = all(np.array_equal(a[k], b[k]) for a, b in zip(items_a, items_b)
                for k in a) and items_a[0]["image"].shape == (64, 64, 1) \
        and all(float(it["xy"][0]) > 0 for it in items_a)
    spot = cell_datasets.CellImageDatasetRandomSpot(
        root + "*raw.png.jpg", size=2, seed=1)
    raw_s, dab_s, xy = spot[0]
    spot_ok = raw_s.shape == (512, 512, 3) and dab_s.shape == (512, 512, 1)
    bags = cell_datasets.IHCMixedBagDataset(driver, mini_batch_size=4)
    b_rgb, b_dab, b_xy, b_lab = bags[0]
    bags_ok = (len(bags) == 4 and b_rgb.shape == (4, 256, 256, 3)
               and b_dab.shape == (4, 256, 256, 1) and b_lab.shape == (4, 1))
    dab = stain.dab_channel(by_hand[paths[0]])
    absent = [m for m in ("cv2", "pandas") if m in sys.modules]
    colormap = "ran"
    try:
        heat, overlay = misc.apply_colormap_on_image(by_hand[paths[0]],
                                                     dab)
        colormap_ok = heat.shape == (96, 96, 4) and overlay.dtype == np.uint8
    except RuntimeError as e:
        if helpers.have_matplotlib() or "matplotlib" not in str(e):
            raise
        colormap, colormap_ok = f"refused: {e}", True
    saved = misc.save_image(by_hand[paths[0]],
                            os.path.join(root, "saved", "cell.png"))
    saved_ok = np.array_equal(np.asarray(Image.open(saved)),
                              by_hand[paths[0]])
    ok = (masked_ok and he_ok and spot_ok and bags_ok and saved_ok
          and colormap_ok and not absent and roundtrip < 1e-6
          and 0.0 <= float(dab.min()) and float(dab.max()) <= 1.0)
    emit({"phase": "aux_cells", "stain_roundtrip": roundtrip,
          "masked_cells_by_hand": masked_ok, "he_same_seed_same_items": he_ok,
          "random_spot": spot_ok, "ihc_bags": len(bags), "bags_ok": bags_ok,
          "cv2_or_pandas_imported": absent, "matplotlib":
          helpers.have_matplotlib(), "apply_colormap_on_image": colormap,
          "save_image_roundtrip": saved_ok,
          "seconds": time.perf_counter() - t0, "ok": ok, **card})
    if not ok:
        raise AssertionError("the stain / cell datasets failed their checks")


def leaky_relu_ab(cnn, one, card, rounds=2, bag=500):
    """The cost of the port's LeakyReLU under autograd (``ops/nn.py``'s
    ``_LeakyReLU``: the JAX package's derivative 1 at 0) against
    PyTorch's own (the slope at 0) on a training bag's extractor forward
    and backward: the 500-tile subsample of a 2500-tile bag at 300 px in
    bf16, CUDA events, interleaved torch, port, port, torch a round."""
    tiles = one.get_inference_data()[0][:bag]
    ours = N.leaky_relu

    def torch_own(x, negative_slope=N.LEAKY_SLOPE):
        return F.leaky_relu(x, negative_slope)

    def step():
        cnn.zero_grad(set_to_none=True)
        resnet.apply_resnet26(cnn, tiles, compute_dtype=torch.bfloat16
                              ).float().sum().backward()

    times = {"torch": [], "port": []}
    try:
        for _ in range(rounds):
            for name in ("torch", "port", "port", "torch"):
                N.leaky_relu = torch_own if name == "torch" else ours
                times[name].append(time_cuda(step, 3, warmup=1))
    finally:
        N.leaky_relu = ours
        cnn.zero_grad(set_to_none=True)
    emit({"phase": "leaky_relu_ab", "tiles": bag, "px": 300,
          "compute_dtype": "bfloat16", "ms_torch_leaky_relu": times["torch"],
          "ms_port_leaky_relu": times["port"],
          "median_ms": {k: statistics.median(v) for k, v in times.items()},
          **card})


def aux_phase(ckpt, one, card):
    """The auxiliary modules (ROADMAP A.13) on the card, f32 with TF32 off:
    the interpretability kit through the epoch-1 checkpoint's extractor,
    the saliency through its head (the pool's kernels), the auxiliary
    models at the reference's sizes, the stain and cell datasets. Returns
    the head saliency's pool counts and the worst kernel error."""
    t0 = time.perf_counter()
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        cfg = amil.MILConfig()
        model = amil.init_attention_mil(_gen(0), cfg)
        checkpoint.restore_params(model, ckpt, strict=True)
        raw = np.load(one.params["data_cache"], mmap_mode="r")[:1].copy()
        aux_interpret(model.cnn, raw, card)
        counts, err = aux_head_saliency(model, cfg, one, card)
        leaky_relu_ab(model.cnn, one, card)
        del model
        aux_models(card)
        aux_cells(card)
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = tf32
    emit({"phase": "aux", "seconds": time.perf_counter() - t0, **card})
    return counts, err



def gan_lrelu_ab(card, cases=((3, 256, 2), (7, 16, 1))):
    """The cost of the StyleGAN's LeakyReLU(0.2) with the JAX package's
    derivative 1 at 0 (``ops/nn.leaky_relu`` under autograd, ROADMAP C.2)
    against PyTorch's own (the slope at 0), on one full-width critic +
    generator step at 32 px (batch 256) and at 512 px (batch 16), the
    trainer's setting (TF32 convolutions, cuDNN's deterministic
    algorithms): CUDA events, torch, port, port, torch a round, each
    measurement one warm step and the mean of two."""
    ours = sg.leaky_relu

    def torch_own(x, negative_slope):
        return F.leaky_relu(x, negative_slope)

    cudnn = torch.backends.cudnn
    saved = (cudnn.allow_tf32, cudnn.deterministic)
    cudnn.allow_tf32, cudnn.deterministic = True, True
    rows = []
    try:
        for step, B, rounds in cases:
            _, both = _gan_steps(step, B)
            times = {"torch": [], "port": []}
            for _ in range(rounds):
                for name in ("torch", "port", "port", "torch"):
                    sg.leaky_relu = torch_own if name == "torch" else ours
                    times[name].append(time_cuda(both, 2, warmup=1))
            sg.leaky_relu = ours
            med = {k: statistics.median(v) for k, v in times.items()}
            rows.append({"resolution": 4 * 2 ** step, "batch": B,
                         "ms_torch_leaky_relu": times["torch"],
                         "ms_port_leaky_relu": times["port"],
                         "median_ms": med,
                         "port_over_torch": med["port"] / med["torch"]})
            del both
            torch.cuda.empty_cache()
    finally:
        sg.leaky_relu = ours
        cudnn.allow_tf32, cudnn.deterministic = saved
    emit({"phase": "gan_leaky_relu_ab", "width_mult": 1.0,
          "conv_tf32": True, "cudnn_deterministic": True,
          "step": "critic + generator", "by_resolution": rows, **card})


LEARN_EPOCHS = 30                # the JAX convergence run's epochs
LEARN_SPY = (10, 128)            # hold 10 pool calls, every 128th, to plain


def trained_bf16_gap(run_dir, card):
    """The bf16 serving contract on a trained classifier: each held-out
    slide of the run (its saved split) through
    ``classify_slide_streaming`` in bf16 and in f32 (TF32 off) from the
    run's last checkpoint; the largest probability gap must be below 1e-3
    (JAX's on its trained checkpoint: 2.7e-4, ``PARITY.md``)."""
    t0 = time.perf_counter()
    split, = glob.glob(os.path.join(run_dir,
                                    "training_validation_testing_data*.json"))
    with open(split) as f:
        paths = json.load(f)["validation_paths"]
    cfg = amil.MILConfig()
    model = amil.init_attention_mil(torch.Generator().manual_seed(0), cfg)
    ckpt = checkpoint.checkpoint_path(run_dir, LEARN_EPOCHS - 1)
    checkpoint.restore_params(model, ckpt)
    model.eval()
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        gaps = []
        for path in paths:
            builder = roibuilder.RoiBuilder(path, {"roi_size": 300})
            p = {dtype: inference.classify_slide_streaming(
                model, cfg, builder, resolution=300, chunk=1024,
                compute_dtype=dtype)[0] for dtype in (torch.bfloat16, None)}
            gaps.append(float(np.abs(p[torch.bfloat16] - p[None]).max()))
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    gap = max(gaps)
    emit({"phase": "learn_trained_bf16_gap", "ckpt": os.path.basename(ckpt),
          "heldout_slides": len(paths), "bf16_vs_f32_max": gap,
          "by_slide": gaps, "tol": 1e-3, "jax_trained_figure": 2.7e-4,
          "seconds": time.perf_counter() - t0, **card})
    if not paths or gap >= 1e-3:
        raise AssertionError(f"the trained classifier's bf16 gap {gap} "
                             "breaks the 1e-3 contract")
    return gap


def learn_phase(card):
    """ROADMAP A.15 and A.18 on the card, through the port's convergence
    tools under PyTorch's defaults (TF32 convolutions), as a user runs
    them: the classifier at full width (``tools/torch_convergence_run``:
    30 epochs at 300 px on the JAX run's grating bags, bf16), which must
    end with its last train loss below its first and held-out slide
    accuracy 1.0, its pool launches counted and a sample of them held to
    the plain pool; then the StyleGAN (``tools/torch_gan_convergence_run``:
    2048 two-band images at 8 px, 30 epochs, batch 64, full width) in f32,
    which must meet the JAX tool's band-distance criteria, and in bf16,
    whose distance is recorded with the criteria met or not. Returns the
    classifier run's pool counts and the worst held error."""
    from tools import torch_convergence_run, torch_gan_convergence_run

    t0 = time.perf_counter()
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    cache_dir = os.environ["CACHE_DIR"]  # the classifier tool sets its own
    try:
        zero_pool_counts()
        limit, every = LEARN_SPY
        with pool_spy(limit, every) as seen, \
                contextlib.redirect_stdout(sys.stderr):
            report = torch_convergence_run.run([
                "--epochs", str(LEARN_EPOCHS),
                "--out", os.path.join(CACHE, "learn_classifier")])
        counts = pool_counts()
        require_launched("learn_classifier", counts,
                         ("LAUNCHES", "BWD_LAUNCHES"))
        err = hold_spied("learn_classifier", seen)
        trained_gap = trained_bf16_gap(report["run_dir"], card)
        emit({"phase": "learn_classifier", **report,
              "criteria": "last train loss < first; held-out accuracy 1.0",
              "pool_forward_launches": counts["LAUNCHES"],
              "pool_backward_launches": counts["BWD_LAUNCHES"],
              "held_calls": {k: len(v) for k, v in seen.items()},
              "held_max_abs_err": err, "conv_tf32": True, **card})
        gans = {}
        for dtype in ("f32", "bf16"):
            with contextlib.redirect_stdout(sys.stderr):
                rec = torch_gan_convergence_run.run([
                    "--compute_dtype", dtype,
                    "--keep", os.path.join(CACHE, f"learn_gan_{dtype}")])
            gans[dtype] = rec
            emit({"phase": f"learn_gan_{dtype}", **rec,
                  "criteria": "band_dist_generator < 0.15 and < 0.5 x "
                              "band_dist_init",
                  "criteria_met": rec["converged"],
                  "secs_per_epoch": (rec["train_wall_secs"] / rec["epochs"]
                                     if "train_wall_secs" in rec else None),
                  "conv_tf32": True, **card})
        if not gans["f32"]["converged"]:
            raise AssertionError("the f32 StyleGAN missed the band-distance "
                                 f"criteria: {gans['f32']}")
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = tf32
        os.environ["CACHE_DIR"] = cache_dir
    emit({"phase": "learn", "seconds": time.perf_counter() - t0, **card})
    return counts, err


EXAMPLES_SPY = (12, 3)           # hold 12 pool calls, every 3rd, to plain
# the walkthrough's steps that pool, and whether each trains (backward)
EXAMPLES_POOLED = {"5": ("examples_legacy", True),
                   "6": ("examples_train", True),
                   "6i": ("examples_interface", False),
                   "6b": ("examples_daemon", False)}


def examples_live_gap(out, devices=("cuda", "cpu")):
    """The live driver's epoch-0 checkpoint through ``classify_slide`` on
    the card and on the CPU (``devices``), f32 with TF32 off, on every
    slide of the walkthrough's tree: the worst gap of the probabilities
    and of ``Aterm``. Comparison launches: the counts are restored."""
    counts = pool_counts()
    cfg = classify.make_config(classify.build_argparser().parse_args(
        ["--arch", "tiny"]))
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cache_dir = os.environ["CACHE_DIR"]
    os.environ["CACHE_DIR"] = out["cache"]
    try:
        gaps = []
        models = {}
        for dev in devices:
            m = amil.AttentionMIL(cfg, device=dev)
            checkpoint.restore_params(m, out["ckpt"], strict=True)
            models[len(models)] = m.eval()
        for name in sorted(os.listdir(out["slides"])):
            path = os.path.join(out["slides"], name)
            got = []
            for dev, m in zip(devices, models.values()):
                builder = roibuilder.RoiBuilder(path, {"roi_size": 32},
                                                device=dev)
                probs, outs, _ = inference.classify_slide(
                    m, cfg, builder, resolution=16, compute_dtype=None)
                got.append((probs, outs["Aterm"]))
            gaps.append(max(float(np.abs(got[0][i] - got[1][i]).max())
                            for i in (0, 1)))
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = tf32
        os.environ["CACHE_DIR"] = cache_dir
    torch.cuda.synchronize()
    set_pool_counts(counts)
    return max(gaps), len(gaps)


def examples_phase(card):
    """ROADMAP A.19 on the card: ``examples/torch_full_pipeline_demo.py``
    in this process on cuda, the JAX walkthrough's eight steps through the
    port's CLIs. Checks the artifacts (where matplotlib is missing, that
    step 7 and the overlay say so), counts the pool's forward and backward
    launches in each step (the legacy classifier and the live trainer
    must launch both, ``--interface`` and the int8 daemon the forward),
    holds a sample of the pool calls to the plain pool, and holds the
    live driver's checkpoint through ``classify_slide`` on the card to the
    CPU (f32, TF32 off, 1e-5). Returns the forward and backward launches
    by path and the worst held error."""
    from examples import torch_full_pipeline_demo as demo

    t0 = time.perf_counter()
    wd = os.path.join(CACHE, "examples")
    steps = {}

    @contextlib.contextmanager
    def counted(name):
        zero_pool_counts()
        yield
        steps[name] = pool_counts()

    text = io.StringIO()
    limit, every = EXAMPLES_SPY
    try:
        with pool_spy(limit, every) as seen, \
                contextlib.redirect_stdout(text):
            out = demo.run(wd, device="cuda", step_hook=counted)
    finally:
        sys.stderr.write(text.getvalue())
    fwd, bwd = {}, {}
    for step, (path, trains) in EXAMPLES_POOLED.items():
        c = steps[step]
        require_launched(path, c, ("LAUNCHES", "BWD_LAUNCHES") if trains
                         else ("LAUNCHES",))
        fwd[path] = c["LAUNCHES"]
        if trains:
            bwd[path] = c["BWD_LAUNCHES"]
    err = hold_spied("examples", seen)
    live_gap, n_slides = examples_live_gap(out)
    have = helpers.have_matplotlib()
    expected = [os.path.join(wd, *p) for p in (
        ("gan_store", "meta.json"),
        ("gan_run", "checkpoint", "train_step-1.model"),
        ("gan_run", "sample.png"), ("gan_run", "sample_mixing_0.png"),
        ("runs", "run_DEMO", "train_step-000.model"),
        ("serve_out", "results.csv"), ("gradcam_tile.npy",))]
    if have:
        expected.append(out["gradcam_png"])
    missing = [p for p in expected if not os.path.exists(p)]
    printed = text.getvalue()
    named = have or (out["skipped"] == ["7"]
                     and "step 7: utils.plots draws with matplotlib"
                     in printed
                     and "step 8: the colour overlay needs matplotlib"
                     in printed)
    legacy = any(f.startswith("train_step-") for _, _, fs
                 in os.walk(out["legacy"]) for f in fs)
    manifests = os.path.exists(os.path.join(
        out["runs"], "interface_data", "manifest_img.csv"))
    cam = out["gradcam"]["cam"]
    ok = (not missing and named and legacy and manifests
          and bool(np.isfinite(cam).all()) and live_gap <= 1e-5)
    secs = time.perf_counter() - t0
    emit({"phase": "examples", "steps": {k: {"pool_forward": v["LAUNCHES"],
                                             "pool_backward":
                                             v["BWD_LAUNCHES"]}
                                         for k, v in steps.items()},
          "missing": missing, "matplotlib": have,
          "skipped_for_a_package": out["skipped"],
          "gradcam_range": [float(cam.min()), float(cam.max())],
          "held_calls": {k: len(v) for k, v in seen.items()},
          "held_max_abs_err": err,
          "live_ckpt_card_vs_cpu": live_gap, "live_slides": n_slides,
          "tol_live": 1e-5, "seconds": secs, "ok": ok, **card})
    if not ok:
        raise AssertionError("the walkthrough on the card is wrong: "
                             f"missing {missing}, named {named}, legacy "
                             f"{legacy}, manifests {manifests}, live gap "
                             f"{live_gap}")
    return fwd, bwd, err


TOOLS_TIMEOUT = 240              # seconds a tool's run may take
TOOLS_SHARE_MAX = 1.05           # a segment above the calibration is a misreading
# the 1024 px d+g step pair: the largest configuration the tools' sweep
# found to fit with margin on the H100 (PERF.md §6)
TOOLS_GAN_1024 = ("f32", 16)


def run_tool(label, argv, card, ok_rcs=(0,), quiet=False):
    """``python tools/<argv>`` in a subprocess with a time limit; its JSON
    lines (the last one the tool's result). An exit code outside
    ``ok_rcs`` or a time-out fails the phase. The record of the run is
    printed, or with ``quiet`` returned for the caller to print:
    ``(rows, record)``."""
    cmd = [sys.executable, os.path.join(ROOT, "tools", argv[0]), *argv[1:]]
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, cwd=ROOT,
                              timeout=TOOLS_TIMEOUT)
    except subprocess.TimeoutExpired as e:
        raise AssertionError(f"tools: {label} exceeded {TOOLS_TIMEOUT} s: "
                             f"{(e.stderr or b'')[-2000:]}") from None
    secs = time.perf_counter() - t0
    rows = [json.loads(ln) for ln in proc.stdout.splitlines()
            if ln.startswith("{")]
    if proc.returncode not in ok_rcs or not rows:
        raise AssertionError(f"tools: {label} exited {proc.returncode}: "
                             f"{proc.stdout[-1500:]}\n{proc.stderr[-3000:]}")
    record = {"phase": f"tools_{label}", "argv": argv[1:], "seconds": secs,
              "result": rows[-1] if len(rows) == 1 else rows, **card}
    if quiet:
        return rows, record
    emit(record)
    return rows


def tools_phase(card):
    """The port's measuring tools (``tools/torch_*.py``), each in a
    subprocess at a small real size, as a user runs them: the card's
    health probe, alone (its probes have time budgets); then, side by
    side (``run_side_by_side``), the ResNet-26 per-stage profile at batch
    64 with the cuDNN stem and with the stem kernel, whose every segment
    and whole forward must stay at or below ``TOOLS_SHARE_MAX`` of the
    calibration taken in the same process; the single-bag training step
    at 500 tiles (the pool's forward and backward kernels at its
    subsample); the GAN's piece medians at 32 px; one full-width 1024 px
    d+g step pair (``TOOLS_GAN_1024``), whose losses must be finite and
    whose peak memory is printed; the serving daemon over four 64-tile
    slides; and the last twins (``last_twins``). Each kernel must have
    launched in the tools that run it, and every T the tools pooled must
    be one that phase 2 held to the plain pool. Returns the launches by
    tool: ``{"fwd": ..., "bwd": ..., "stem": ...}``."""
    gc_collect()
    t0 = time.perf_counter()
    health = run_tool("chip_health", ["torch_chip_health.py"], card)[-1]
    dtype, batch = TOOLS_GAN_1024
    jobs = {f"profile_stages_{stem}": (["torch_profile_stages.py",
                                        "--batch", "64", "--iters", "3",
                                        "--stem", stem, "--json"], (0,))
            for stem in ("cudnn", "kernel")}
    jobs.update({
        "profile_train": (["torch_profile_stages.py", "--train",
                           "--tiles-per-bag", str(TOOLS_TRAIN_BAG),
                           "--iters", "2", "--json"], (0,)),
        "profile_gan": (["torch_profile_gan.py", "--res", "32", "--batch",
                         "16", "--rounds", "2"], (0,)),
        "exp_gan512_1024px": (["torch_exp_gan512.py", "--probe", "--res",
                               "1024", "--batch", str(batch), "--dtype",
                               dtype, "--iters", "1"], (0,)),
        "exp_serve": (["torch_exp_serve.py", "--slides", "4", "--tiles",
                       str(TOOLS_SERVE_TILES), "--batch", "2", "--keep",
                       os.path.join(CACHE, "tools_serve")], (0,)),
        **LAST_TWINS})
    rows = run_side_by_side(jobs, card)
    stages = {}
    for stem in ("cudnn", "kernel"):
        row = rows[f"profile_stages_{stem}"][-1]
        shares = {s["name"]: s["share_of_calibration"]
                  for s in row["segments"]}
        shares["full"] = row["full_share_of_calibration"]
        if max(shares.values()) > TOOLS_SHARE_MAX:
            raise AssertionError(f"tools: a segment at {max(shares.values())}"
                                 f" of the calibration (stem {stem}): "
                                 f"{shares}")
        stages[stem] = row
    if stages["kernel"]["stem_pool_launches"] < 1:
        raise AssertionError("tools: --stem kernel never launched the "
                             "pooled stem kernel")
    train = rows["profile_train"][-1]
    gan_1024 = rows["exp_gan512_1024px"][-1]
    if not (gan_1024["fit"] and math.isfinite(gan_1024["disc_loss"])
            and math.isfinite(gan_1024["g_loss"])
            and gan_1024["peak_mem_gb"] > 0):
        raise AssertionError(f"tools: the 1024 px step pair failed: "
                             f"{gan_1024}")
    serve_rows = rows["exp_serve"]
    late = last_twins(rows)
    pooled = [train] + serve_rows + late["pooled"]
    fwd = {"tools_profile_train": train["pool_launches"],
           "tools_exp_serve": sum(r["pool_launches"] for r in serve_rows),
           **late["fwd"]}
    bwd = {"tools_profile_train": train["pool_bwd_launches"]}
    stem = {"tools_profile_stages_kernel": stages["kernel"]["stem_launches"],
            **late["stem"]}
    stem_pool = {"tools_profile_stages_kernel":
                 stages["kernel"]["stem_pool_launches"], **late["stem_pool"]}
    if min(*fwd.values(), *bwd.values()) < 1:
        raise AssertionError(f"tools: the pool's kernels never launched: "
                             f"{fwd} {bwd}")
    fwd_t = set().union(*(r["pool_T"] for r in pooled))
    bwd_t = set().union(*(r["pool_bwd_T"] for r in pooled))
    unchecked = {"forward": sorted(fwd_t - {t for t, k, o in POOL_SHAPES
                                            + POOL_LATE_SHAPES
                                            if (k, o) == (3, 1)}),
                 "backward": sorted(bwd_t - {t for t, k, o in POOL_BWD_SHAPES
                                             if (k, o) == (3, 1)})}
    emit({"phase": "tools", "seconds": time.perf_counter() - t0,
          "healthy": health["healthy"],
          "marginal_tflops": health.get("marginal_tflops"),
          "calibration_tflops": {k: r["calibration_tflops"]
                                 for k, r in stages.items()},
          "gan_1024": {k: gan_1024[k] for k in (
              "dtype", "batch", "imgs_per_sec", "peak_mem_gb", "disc_loss",
              "g_loss")},
          "side_by_side": list(jobs),
          "pool_T": sorted(fwd_t), "pool_bwd_T": sorted(bwd_t),
          "unchecked_T": unchecked, "launches": {"forward": fwd,
                                                 "backward": bwd,
                                                 "stem": stem,
                                                 "stem_pool": stem_pool},
          **card})
    if unchecked["forward"] or unchecked["backward"]:
        raise AssertionError(f"tools: pooled T never held to the plain "
                             f"pool: {unchecked}")
    return {"fwd": fwd, "bwd": bwd, "stem": stem, "stem_pool": stem_pool}


TOOLS_WORKERS = 5                # tools running at once after the health probe


def run_side_by_side(jobs, card, workers=TOOLS_WORKERS):
    """``{label: (tool argv, accepted exit codes)}`` through ``run_tool``,
    ``workers`` processes at a time on the card, their records printed
    in the jobs' order once all have ended. The tools check paths here,
    and their times, taken beside each other, are not measurements
    (``tools/torch_tools_runs.py`` runs them one at a time). Returns each
    label's JSON rows."""
    with concurrent.futures.ThreadPoolExecutor(workers) as pool:
        done = dict(zip(jobs, pool.map(
            lambda j: run_tool(j[0], j[1][0], card, ok_rcs=j[1][1],
                               quiet=True), jobs.items())))
    for rows, record in done.values():
        emit({**record, "side_by_side": True})
    return {label: rows for label, (rows, _) in done.items()}


TOOLS_MEGABATCH = "1x256,2x256"  # K x B, the extractor's dispatch sweep
# two epochs across one transition (8 -> 16 px) of the GAN tool's schedule
TOOLS_GAN_SCHEDULE = ["--res", "8", "--max_res", "16", "--epochs", "2",
                      "--step_every", "1", "--n_images", "256"]
# the twins of the JAX side's last experiment tools, at cut sizes: the
# extractor's K x B sweep with both stems, the daemon's --io_depth A/B on
# three cold 2000 px slides, the mixed-size cohort without and with
# --prewarm, the GAN tool across one transition (two epochs are not meant
# to converge, so its exit 1 is taken)
LAST_TWINS = {
    "exp_megabatch": (["torch_exp_megabatch.py", "--configs",
                       TOOLS_MEGABATCH, "--rounds", "2", "--stem",
                       "cudnn,kernel"], (0,)),
    "exp_serve_io": (["torch_exp_serve_io.py", "--n", str(TOOLS_IO["n"]),
                      "--px", str(TOOLS_IO["px"]), "--roi",
                      str(TOOLS_IO["roi"]), "--reps", "1"], (0,)),
    "exp_serve_hetero": (["torch_exp_serve_hetero.py", "--max_tiles",
                          str(TOOLS_HETERO_MAX)], (0,)),
    "gan_convergence_schedule": (["torch_gan_convergence_run.py",
                                  *TOOLS_GAN_SCHEDULE], (0, 1))}


def _probs_gap(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max())


def last_twins(rows):
    """The checks on the last twins' runs (``LAST_TWINS``; ``rows`` by
    label): the pooled stem kernel launched in the K x B sweep; the io twin's
    variants each pooled every slide, their probabilities within 1e-6;
    the hetero twin saw one chunk shape a distinct tile count, pooled
    each slide (and the prewarm chunk), its variants' probabilities
    within 1e-6; the GAN tool's record has one transition and finite
    distances at both resolutions. Returns their launches of the pool and
    of each stem kernel, and their pooled rows."""
    mega, io_rows, hetero = (rows[k] for k in (
        "exp_megabatch", "exp_serve_io", "exp_serve_hetero"))
    gan_rec = rows["gan_convergence_schedule"][-1]
    kernel_rows = [r for r in mega if r["stem"] == "kernel"]
    io_variants = [r for r in io_rows if "io_depth" in r
                   and "slides" in r]
    sizes = torch_exp_serve_hetero.cohort_sizes(TOOLS_HETERO_MAX)
    bad = []
    if min(r["stem_pool_launches"] for r in kernel_rows) < 1:
        bad.append("the megabatch sweep never launched the pooled stem "
                   "kernel")
    if (len(io_variants) != 2
            or any(r["pool_launches"] != TOOLS_IO["n"] for r in io_variants)
            or _probs_gap(*([s["probs"] for s in r["slides"]]
                            for r in io_variants)) > 1e-6):
        bad.append(f"the io twin's variants: {io_variants}")
    for r in hetero:
        # the prewarm variant pools one zero chunk first
        if (r["rc"] != 0 or r["n_shapes"] != len(sizes)
                or sorted(r["slide_tiles"]) != sorted(sizes)
                or r["pool_launches"] != len(sizes) + (r["variant"]
                                                      == "prewarm")):
            bad.append(f"the hetero twin's {r['variant']} variant: {r}")
    if _probs_gap(*(r["slide_probs"] for r in hetero)) > 1e-6:
        bad.append("the hetero twin's variants' rows differ")
    if not (gan_rec.get("res_transitions") == 1
            and gan_rec.get("max_res") == 16
            and all(math.isfinite(gan_rec.get(k, math.nan)) for k in (
                "band_dist_generator", "band_dist_pre_transition"))):
        bad.append(f"the GAN tool's schedule run: {gan_rec}")
    if bad:
        raise AssertionError("tools: " + "; ".join(bad))
    return {"fwd": {"tools_exp_serve_io": sum(r["pool_launches"]
                                              for r in io_variants),
                    "tools_exp_serve_hetero": sum(r["pool_launches"]
                                                  for r in hetero)},
            "stem": {"tools_exp_megabatch": sum(r["stem_launches"]
                                                for r in kernel_rows)},
            "stem_pool": {"tools_exp_megabatch": sum(r["stem_pool_launches"]
                                                     for r in kernel_rows)},
            "pooled": [{"pool_T": r["pool_T"], "pool_bwd_T": []}
                       for r in io_variants + hetero]}


def gc_collect():
    """Give the card's cached memory back before a tool's process needs
    it (the 1024 px step pair takes most of the card)."""
    gc.collect()
    torch.cuda.empty_cache()
    emit({"phase": "tools_memory",
          "parent_allocated_gb": torch.cuda.memory_allocated() / 1e9,
          "parent_reserved_gb": torch.cuda.memory_reserved() / 1e9})


def split_row(way, mesh_launches, max_err, times):
    """The kernels line's row of the split entries of the pool's forward or
    backward: their launches on the mesh paths (each path's own count,
    rank 0's for the two-rank paths) and their times at the first of
    MESH_TIMED_T."""
    key = "PARTIAL_LAUNCHES" if way == "forward" else "BWD_PARTIAL_LAUNCHES"
    by_path = {path: c[key] for path, c in mesh_launches.items() if c[key]}
    t = MESH_TIMED_T[0]
    return {
        "name": ("gated_attention_pool_split" if way == "forward"
                 else "gated_attention_pool_backward_split"),
        "route": "cuda", "source": f"{PORT}/csrc/gated_pool.cu",
        "replaces": f"{JAX_PKG}/ops/pallas_pool.py:"
                    + ("43" if way == "forward" else "118"),
        "launches": sum(by_path.values()), "max_abs_err": max_err,
        **{k: times[t][k] for k in ("ms", "ms_source", "ms_records",
                                    "ms_calls", "plain_ms", "bound_ms",
                                    "bound_by")},
        "library_ms": None,
        "shape": {"T": t, "K": 3, "O": 1, "shards": 1,
                  "entries": ("partials + finish" if way == "forward"
                              else "bwd partials + bwd finish, dM only")},
        "ms_by_T": {tt: r["ms"] for tt, r in times.items()},
        "bound_share_by_T": {tt: r["bound_share"] for tt, r in times.items()},
        "launches_per_call_by_T": {tt: r["ms_launches_per_call"]
                                   for tt, r in times.items()},
        "by_entry_ms_by_T": {tt: {e: v["ms"] for e, v in r["by_entry"].items()}
                             for tt, r in times.items()},
        "launches_by_path": by_path}


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
    bwd_ptxas = ptxas_report(_build.BUILD_LOG["gated_pool"], "gated_pool_bwd")
    emit({"phase": "ptxas_backward", "kernels": bwd_ptxas})
    require_no_spill(bwd_ptxas)
    fwd_ptxas = ptxas_report(_build.BUILD_LOG["gated_pool"], "gated_pool_fwd")
    emit({"phase": "ptxas_forward", "kernels": fwd_ptxas})
    require_no_spill(fwd_ptxas)
    hmma = tensor_core_instructions(libs["u8_stem"])
    # the pool's library carries its forward and its backward
    entries = [gated_pool._kernel(e).__name__
               for e in ("gated_pool_forward", "gated_pool_backward")]
    emit({"phase": "build", "kernels": sorted(_build.BUILD_LOG),
          "gated_pool_entries": entries, "seconds": build_s,
          "u8_stem_tensor_core_sass": hmma})
    if hmma < 1:
        raise AssertionError("the u8_stem kernel has no tensor-core "
                             "(HMMA/HGMMA) instruction")

    # phase 2: each kernel against its plain version, on the card
    cfg = amil.MILConfig()
    model = amil.init_attention_mil(torch.Generator().manual_seed(0), cfg)
    max_err = check_pool_kernel()
    bwd_err = check_pool_backward()
    stem_err, stem_pool_err = check_stem_kernel(model.cnn.conv1)

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
        (stem_launches, stem_pool_launches,
         launches["classify_slide_streaming_u8_stem"]) = serve_u8_stem(
            model, cfg, big, p_big, p32_big, card)
        stem_row, stem_pool_row = stem_ab(model.cnn, card)

        # training at full width through the trainer's CLI, on a cohort
        # that reuses the serving slides' caches (the daemon built the
        # small ones)
        train_root = os.path.join(CACHE, "train")
        flags = train_cohort(train_root)
        runs = os.path.join(train_root, "runs")
        launches["train_classify"], bwd_launches = train_main_path(
            flags, runs, card)
        train_grad_card_vs_cpu(one)
        train_times(flags, runs, card)
        bwd_times = time_pool_backward(card)

        # the trainer's serving and instrumentation modes, from the
        # trained epoch-1 checkpoint
        ckpt = checkpoint.checkpoint_path(os.path.join(runs, "run_U"), 1)
        iface, f32_table = interface_phase(flags, runs, ckpt, card)
        launches["interface_bf16"] = iface["bfloat16"]
        launches["interface_f32"] = iface["float32"]
        # the AOT tier: reference-checkpoint interchange, bundles, the
        # daemon's --bundle
        launches.update(bundle_phase(ckpt, one, big, hi, slides, card))
        launches.update(int8_phase(model, cfg, one, slides, p_one, p32_one,
                                   flags, runs, ckpt, f32_table, card))
        launches["train_profile"], bwd_profile = profile_phase(flags, runs,
                                                               card)
        build_caches_phase(slides, card)
        # the figures, the GAN family and the legacy classifier
        launches["figures_visualize"], fig_err = figures_phase(flags, one,
                                                               card)
        gan_parity(card)
        instance_norm_bits(card)
        gan_ckpt = gan_train(card)
        gan_step_costs(card)
        gan_lrelu_ab(card)
        legacy_train, legacy_test, legacy_err = legacy_phase(flags, gan_ckpt,
                                                             card)
        launches["legacy_train"] = legacy_train["LAUNCHES"]
        launches["legacy_test"] = legacy_test["LAUNCHES"]
        bwd_launches_legacy = legacy_train["BWD_LAUNCHES"]
        # the auxiliary modules: interpret, the saliency through the head
        aux_counts, aux_err = aux_phase(ckpt, one, card)
        launches["aux_head_saliency"] = aux_counts["LAUNCHES"]
        bwd_launches_aux = aux_counts["BWD_LAUNCHES"]
        # the classifier and the StyleGAN trained to convergence
        learn_counts, learn_err = learn_phase(card)
        launches["learn_classifier"] = learn_counts["LAUNCHES"]
        bwd_launches_learn = learn_counts["BWD_LAUNCHES"]
        # the JAX walkthrough's eight steps through the port's CLIs
        examples_fwd, examples_bwd, examples_err = examples_phase(card)
        launches.update(examples_fwd)
        # the measuring tools, each in its own process
        tool_counts = tools_phase(card)
        launches.update(tool_counts["fwd"])
        max_err = max(max_err, fig_err, legacy_err, aux_err, learn_err,
                      examples_err)
        mesh_launches, split_err, split_times = mesh_phase(one, big, card)
        mesh_launches.update(mesh_cli(1, flags, cli_serve_inputs(model,
                                                                 slides),
                                      card))
        for path, counts in mesh_launches.items():
            if counts["LAUNCHES"]:
                launches[path] = counts["LAUNCHES"]
    finally:
        shutil.rmtree(CACHE, ignore_errors=True)

    t_main = POOL_TIMED_T[0]
    t_bwd = max(TRAIN_POOL_T)  # the largest training bag's subsample
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
        "launches_per_call_by_T": {t: r["ms_launches_per_call"]
                                   for t, r in pool_times.items()},
        "cut_by_T": {t: r["cut"] for t, r in pool_times.items()},
        "launches_by_path": launches}, {
        "name": "stem_u8_conv", "route": "cuda",
        "source": f"{PORT}/csrc/u8_stem.cu",
        "replaces": f"{JAX_PKG}/ops/pallas_stem.py:69",
        "launches": stem_launches + sum(tool_counts["stem"].values()),
        "max_abs_err": stem_err, **stem_row,
        "shape": {"B": STEM_AB_TILES, "H": 300, "W": 300, "C": 3},
        "launches_by_path": {"classify_slide_streaming_u8_stem":
                             stem_launches, **tool_counts["stem"]}}, {
        "name": "stem_u8_pool", "route": "cuda",
        "source": f"{PORT}/csrc/u8_stem.cu",
        "replaces": f"{JAX_PKG}/ops/pallas_stem.py:69",
        "launches": (stem_pool_launches
                     + sum(tool_counts["stem_pool"].values())),
        "max_abs_err": stem_pool_err, **stem_pool_row,
        "shape": {"B": STEM_AB_TILES, "H": 300, "W": 300, "C": 3},
        "launches_by_path": {"classify_slide_streaming_u8_stem":
                             stem_pool_launches,
                             **tool_counts["stem_pool"]}}, {
        "name": "gated_attention_pool_backward", "route": "cuda",
        "source": f"{PORT}/csrc/gated_pool.cu",
        "replaces": f"{JAX_PKG}/ops/pallas_pool.py:118",
        "launches": (bwd_launches + bwd_profile + bwd_launches_legacy
                     + bwd_launches_aux + bwd_launches_learn
                     + sum(examples_bwd.values())
                     + sum(tool_counts["bwd"].values())),
        "max_abs_err": max(bwd_err, legacy_err, aux_err, learn_err,
                           examples_err),
        **bwd_times[t_bwd], "library_ms": None,
        "shape": {"T": t_bwd, "K": 3, "O": 1, "cotangents": "dM"},
        "ms_by_T": {t: r["ms"] for t, r in bwd_times.items()},
        "bound_share_by_T": {t: r["bound_share"]
                             for t, r in bwd_times.items()},
        "launches_by_path": {"train_classify": bwd_launches,
                             "train_profile": bwd_profile,
                             "legacy_train": bwd_launches_legacy,
                             "aux_head_saliency": bwd_launches_aux,
                             "learn_classifier": bwd_launches_learn,
                             **examples_bwd, **tool_counts["bwd"]}},
        *[split_row(way, mesh_launches, split_err, split_times[way])
          for way in ("forward", "backward")]]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    if sys.argv[1:2] == ["--bundle-child"]:
        bundle_child(*sys.argv[2:])
    elif sys.argv[1:2] == ["--mesh-cards"]:
        mesh_cards(int(sys.argv[2]))
    else:
        main()
