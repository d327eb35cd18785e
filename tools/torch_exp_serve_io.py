"""Does the daemon's ``--io_depth`` pay on cold slides? The twin of
``tools/exp_serve_io.py`` for the PyTorch port.

``<port>/train/serve.py`` prepares each slide on the host (``_prepare``:
the RoiBuilder's cache build, that is the slide's decode and tissue
filter, then the transform's arming and a readahead of the raw cache). With
``--io_depth N`` that runs up to N slides ahead on a producer thread
(``data/loader.prefetch_iter``) while the card classifies the slide
before. On prebuilt caches (``tools/torch_exp_serve.py``) the preparation
is nearly free, so this tool drains a cohort of cold full-slide ``.npy``
files: every slide pays its build before it can be classified.

Method, the JAX tool's: the page cache is touched for every slide file
first; the variants run in this process, interleaved ``0, N, 0, N`` (for
``--reps 2``); each variant gets a fresh cache directory, so it pays every
build, and is warmed first on one slide of its own (cuDNN's first calls at
the chunk shape land there). One JSON line a variant: the drain's wall,
each slide's build (``_prepare``) and infer (the ``results.csv`` secs
column: classify and map) seconds and its wall (from the previous slide's
row to its own) and probabilities, the gated pool's launches, and the
card's name and power limit; then a summary line. Overlap can save at
most min(build, infer) a slide.

Usage:
    python tools/torch_exp_serve_io.py                  # card, 6 x 6000 px
    python tools/torch_exp_serve_io.py --roi 300        # inference weighs more
    python tools/torch_exp_serve_io.py --device cpu --arch tiny --res 16 \\
        --roi 64 --px 320 --n 3                         # CPU smoke

Runs on the card unless ``--device cpu``; imports nothing of JAX.
"""

import argparse
import json
import os
import shutil
import statistics
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))  # repo root, for `python tools/...`

from tools import torch_measure as TM  # noqa: E402


def build_slides(root: str, n: int, px: int, seed: int = 0,
                 prefix: str = "GHP") -> str:
    """``n`` cold full-slide ``.npy`` files (tissue-coloured noise, no
    caches), the JAX tool's."""
    slides = os.path.join(root, "slides")
    os.makedirs(slides, exist_ok=True)
    rng = np.random.default_rng(seed)
    for i in range(n):
        img = np.clip(np.array([150, 90, 160], np.int16)
                      + rng.integers(-50, 50, (px, px, 3)),
                      0, 255).astype(np.uint8)
        np.save(os.path.join(slides, f"{prefix}_{i:03d}_A_H&E.npy"), img)
    return slides


def serve_argv(slides_dir, out_root, args, io_depth):
    return ["--watch_dir", slides_dir, "--out_root", out_root,
            "--arch", args.arch, "--resolution", str(args.res),
            "--roi_size", str(args.roi), "--settle_secs", "0",
            "--io_depth", str(io_depth), "--once"]


def read_rows(out_root):
    with open(os.path.join(out_root, "results.csv")) as f:
        return [ln.split(",") for ln in f.read().splitlines()[1:] if ln]


def drain(slides_dir, warm_slide, out_root, cache_dir, args, io_depth,
          device):
    """One variant: a fresh cache dir and server, warmed on
    ``warm_slide``, then the cohort drained. Returns the record, with the
    cohort's ``results.csv`` rows under ``rows``."""
    from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.train import (  # noqa: E501
        serve,
    )

    os.makedirs(cache_dir, exist_ok=True)
    os.environ["CACHE_DIR"] = cache_dir
    srv = serve.SlideServer(serve.build_argparser().parse_args(
        serve_argv(slides_dir, out_root, args, io_depth)), device=device)
    if srv._drain([warm_slide]) != (1, 0):
        raise RuntimeError(f"the warm-up slide {warm_slide} failed")
    TM.sync(device)
    build, done_at = {}, {}
    prepare, process = srv._prepare, srv.process

    def timed_prepare(path):
        t = time.perf_counter()
        try:
            return prepare(path)
        finally:
            build[os.path.basename(path).split(".")[0]] = (
                time.perf_counter() - t)

    def timed_process(path, builder=None):
        ok = process(path, builder=builder)
        done_at[os.path.basename(path).split(".")[0]] = time.perf_counter()
        return ok

    srv._prepare, srv.process = timed_prepare, timed_process
    with TM.kernel_record() as rec:
        t0 = time.perf_counter()
        done, failed = srv._drain(srv.pending())
        TM.sync(device)
        wall = time.perf_counter() - t0
    if (done, failed) != (args.n, 0):
        raise RuntimeError(f"{done} of {args.n} slides classified, "
                           f"{failed} failed")
    warm_name = os.path.basename(warm_slide).split(".")[0]
    rows = [r for r in read_rows(out_root) if r[0] != warm_name]
    slides, last = [], t0
    for r in rows:
        name = r[0]
        slides.append({"name": name, "build_s": build[name],
                       "infer_s": float(r[-1]),
                       "wall_s": done_at[name] - last,
                       "probs": [float(v) for v in r[1:4]]})
        last = done_at[name]
    return {"io_depth": io_depth, "wall_s": wall,
            "build_s": sum(s["build_s"] for s in slides),
            "infer_s": sum(s["infer_s"] for s in slides),
            "slides_per_min": 60 * args.n / wall, "slides": slides,
            **TM.launches_json(rec), "rows": rows}


def run(args, device):
    """The interleaved variants and the summary; returns both."""
    card = TM.card_record(device)
    root = tempfile.mkdtemp(prefix="torch_exp_serve_io_")
    try:
        slides_dir = build_slides(root, args.n, args.px)
        warm_dir = build_slides(os.path.join(root, "warm"), 1, args.px,
                                seed=99, prefix="WARM")
        warm_slide = os.path.join(warm_dir, os.listdir(warm_dir)[0])
        for d in (slides_dir, warm_dir):
            for f in sorted(os.listdir(d)):
                np.load(os.path.join(d, f), mmap_mode="r").sum()
        results = []
        for rep, depth in enumerate([0, args.io_depth] * args.reps):
            cache = os.path.join(root, f"cache_{rep}")
            rec = drain(slides_dir, warm_slide,
                        os.path.join(root, f"out_{rep}"), cache, args,
                        depth, device)
            shutil.rmtree(cache)  # the next variant rebuilds every slide
            results.append(rec)
            print(json.dumps({k: v for k, v in rec.items() if k != "rows"}
                             | {"px": args.px, "roi": args.roi,
                                "device": device.type, **card}),
                  flush=True)
        serial = [r for r in results if r["io_depth"] == 0]
        piped = [r for r in results if r["io_depth"] > 0]

        def med(rs, f):
            return statistics.median(f(r) for r in rs)

        summary = {
            "experiment": "serve_io_pipeline", "n_slides": args.n,
            "px": args.px, "roi": args.roi, "res": args.res,
            "arch": args.arch, "io_depth": args.io_depth,
            "serial_wall_s": [r["wall_s"] for r in serial],
            "pipelined_wall_s": [r["wall_s"] for r in piped],
            "median_speedup": (med(serial, lambda r: r["wall_s"])
                               / med(piped, lambda r: r["wall_s"])),
            # what of the build stayed on the critical path
            "serial_overhead_s": med(serial,
                                     lambda r: r["wall_s"] - r["infer_s"]),
            "pipelined_overhead_s": med(piped,
                                        lambda r: r["wall_s"] - r["infer_s"]),
            "build_s_per_slide": med(results, lambda r: r["build_s"]) / args.n,
            "infer_s_per_slide": med(results, lambda r: r["infer_s"]) / args.n,
            "device": device.type, **card}
        print(json.dumps(summary), flush=True)
        return results, summary
    finally:
        shutil.rmtree(root, ignore_errors=True)


def build_argparser():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=6, help="cohort size")
    ap.add_argument("--px", type=int, default=6000, help="slide side")
    ap.add_argument("--roi", type=int, default=1200)
    ap.add_argument("--res", type=int, default=300)
    ap.add_argument("--arch", default="full", choices=["full", "tiny"])
    ap.add_argument("--io_depth", type=int, default=2,
                    help="the pipelined variant's depth")
    ap.add_argument("--reps", type=int, default=2,
                    help="interleaved repetitions of each variant")
    ap.add_argument("--device", default=None, help="the card unless 'cpu'")
    return ap


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    run(args, TM.resolve(args.device, "torch_exp_serve_io"))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
