"""On-card smoke run of the PyTorch/CUDA port (one NVIDIA H100).

    python3 chip_smoke.py

Builds every CUDA kernel of the serving path from the sources in this
checkout, holds each against its plain PyTorch version on the card, drives
full-width slide serving (``classify_slide`` and
``classify_slide_streaming``) on synthetic slides written and cached by
the port's own RoiBuilder, checks the outputs, and times the paths with CUDA
events and the kernels with torch.profiler's device durations. Progress goes to stderr; results go to stdout as
JSON lines, each timing beside the card's name and power limit. The
second-to-last line lists the kernels, the last line is the device record.

Exits non-zero, with no result, when there is no CUDA device, when the
port's package is not beside this file, or when any phase fails. Slides
and caches are written under ``.smoke_cache/`` in the checkout and deleted
at the end. Imports nothing of JAX.
"""

import json
import os
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.data import (  # noqa: E402
    roibuilder,
    slide_io,
    transforms,
)
from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.models import (  # noqa: E402
    attention_mil as amil,
)
from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.ops import (  # noqa: E402
    _build,
    gated_pool,
)
from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.parallel import (  # noqa: E402
    inference,
)

PORT = "deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch"
CACHE = os.path.join(ROOT, ".smoke_cache")
HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
F32_OPS_PER_S = 67e12          # H100 SXM data sheet, non-tensor float32
# the main path's pool shapes (the three slides below) and more
POOL_SHAPES = [(8, 3, 1), (2000, 3, 1), (5000, 3, 1), (64, 3, 1),
               (100, 3, 1), (7, 5, 2), (2048, 3, 1), (2560, 3, 1),
               (50000, 3, 1)]
# timed: the one-pass slide (the kernels line), the streaming slide, and a
# 50k-tile slide
POOL_TIMED_T = (2000, 5000, 50000)
# synthetic slides: name -> (raster rows, cols, roi px, white tiles, pool of
# distinct tissue tiles). 2000 tiles go through the one-pass path; 5000
# stream in 1024-tile chunks; the roi-1200 slide runs the live 1200 -> 300
# anti-aliased resize. Both paths run at the slide's exact tile count.
SLIDES = {"onepass": (45, 45, 300, 25, 32),
          "stream": (71, 71, 300, 41, 32),
          "roi1200": (3, 3, 1200, 1, 4)}


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
    return worst


def device_ms(fn, iters, match=None):
    """Mean device time per call of ``fn`` over ``iters`` calls: the sum of
    the durations of the card's activities (those whose name holds
    ``match``, if given) that torch.profiler records, over ``iters``. Host
    time between launches does not count."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    spans = [e.time_range.end - e.time_range.start for e in prof.events()
             if e.device_type == DeviceType.CUDA
             and (match is None or match in e.name)]
    if not spans or (match is not None and len(spans) != iters):
        raise AssertionError(f"the profiler recorded {len(spans)} device "
                             f"activities for {iters} calls")
    return sum(spans) / 1e3 / iters


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
    serving path pays) and the plain version (``plain_ms``)."""
    rows = {}
    fn = gated_pool._kernel()
    for t in POOL_TIMED_T:
        args = pool_inputs(t, 3, 1, seed=7)
        outs = [args[0].new_empty(s) for s in ((3, 1), (3, t), (3, t))]
        ptrs = [x.data_ptr() for x in args + outs]
        stream = torch.cuda.current_stream().cuda_stream

        def raw():
            return fn(*ptrs, t, 3, 1, stream)

        def plain():
            return gated_pool.gated_attention_pool_reference(*args)

        ms = device_ms(raw, 200, match="gated_pool_kernel")
        host_ms = time_cuda(raw, 500)
        n = gated_pool.LAUNCHES
        wrapper_ms = time_cuda(
            lambda: gated_pool.gated_attention_pool(*args), 200)
        gated_pool.LAUNCHES = n  # timing launches are not the main path's
        plain_device = device_ms(plain, 50)
        plain_ms = time_cuda(plain, 200)
        bound, bound_by = pool_bound_ms(t, 3, 1)
        rows[t] = {"ms": ms, "host_ms": host_ms, "wrapper_ms": wrapper_ms,
                   "plain_ms": plain_ms, "plain_device_ms": plain_device,
                   "bound_ms": bound, "bound_by": bound_by}
        emit({"phase": "pool_time", "T": t, "K": 3, "O": 1,
              "kernel_device_us": 1e3 * ms, "kernel_host_us": 1e3 * host_ms,
              "wrapper_us": 1e3 * wrapper_ms, "plain_us": 1e3 * plain_ms,
              "plain_device_us": 1e3 * plain_device, "bound_us": 1e3 * bound,
              "bound_by": bound_by, "library_us": None, **card})
    return rows


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


def built(name, seed):
    rows, cols, roi, n_background, n_pool = SLIDES[name]
    t0 = time.perf_counter()
    path = synthetic_slide(os.path.join(CACHE, f"{name}_H&E.npy"), rows,
                           cols, roi, n_background, seed, n_pool)
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
    _build.build("gated_pool")
    build_s = time.perf_counter() - t0
    for kernel, text in _build.BUILD_LOG.items():
        log(f"nvcc {kernel}:\n{text.strip()}")
    emit({"phase": "build", "kernels": sorted(_build.BUILD_LOG),
          "seconds": build_s})

    # phase 2: each kernel against its plain version, on the card
    max_err = check_pool_kernel()

    # phase 3: full-width serving on synthetic slides
    os.makedirs(CACHE, exist_ok=True)
    os.environ["CACHE_DIR"] = CACHE
    try:
        cfg = amil.MILConfig()
        model = amil.init_attention_mil(torch.Generator().manual_seed(0), cfg)
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
        d_paths = float(np.abs(p32_one - p32_str).max())
        d_bf16 = float(np.abs(p_one - p32_one).max())
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
    finally:
        shutil.rmtree(CACHE, ignore_errors=True)

    t_main = POOL_TIMED_T[0]
    print(f"{name}, {limit}", flush=True)
    emit({"kernels": [{
        "name": "gated_attention_pool", "route": "cuda",
        "source": f"{PORT}/csrc/gated_pool.cu",
        "replaces": "deep_convolutional_neural_network_resnet_26_and_"
                    "attention_network_tpu/ops/pallas_pool.py:43",
        "launches": sum(launches.values()), "max_abs_err": max_err,
        **pool_times[t_main], "library_ms": None,
        "shape": {"T": t_main, "K": 3, "O": 1},
        "launches_by_path": launches}]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
