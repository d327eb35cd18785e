"""A cohort whose slides all differ in tile count, through the PyTorch
port's daemon: the twin of ``tools/exp_serve_hetero.py``.

The JAX tool counts XLA compilations: before its bucketed pool every
distinct slide size compiled a pool program. Eager PyTorch compiles
nothing per shape, so the count that stands in for it is the number of
distinct extractor chunk shapes the run saw (``<port>/parallel/
inference.streaming_chunk_for`` streams a slide smaller than the chunk at
its own size, so each new tile count is a new shape for cuDNN). The JAX
tool's ``--old_tree`` A/B (the commit before its bucketed pool) has no
counterpart: the port never had per-size pool programs.

The cohort is the JAX tool's: one slide per size of its list up to
``--max_tiles``, every tile count distinct, written as prebuilt caches in
``tools/torch_exp_serve.py``'s layout. It is drained through
``<port>/train/serve.py --once`` without and with ``--prewarm
max_tiles``, each variant in a fresh interpreter, which then drains the
same cohort a second time into another output root: there every shape
has been seen. One JSON line a variant: the distinct chunk shapes, the
drain's wall (the daemon's start included) and the prewarm's share of it,
the worst slide, the warm per-slide latency (the median of
the last five), the median latency of a slide whose shape is new (the
first pass, the first slide left out) against the same slides repeated
(the second pass), each slide's tile count and probabilities, the gated
pool's launches and the T it pooled, and the card's name and power limit.

Usage:
    python tools/torch_exp_serve_hetero.py                 # card, 24 slides
    python tools/torch_exp_serve_hetero.py --device cpu --arch tiny \\
        --res 16 --roi 32 --max_tiles 31                   # CPU smoke

Runs on the card unless ``--device cpu``; imports nothing of JAX.
"""

import argparse
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _ROOT)  # repo root, for `python tools/...`

from tools import torch_exp_serve, torch_measure as TM  # noqa: E402

# the JAX tool's sizes: every slide a distinct tile count, six a ladder
# bucket of its pool
SIZES = (17, 21, 26, 29, 24, 31, 40, 52, 57, 61, 48, 63,
         70, 90, 101, 120, 96, 127, 130, 170, 201, 240, 150, 250)


def cohort_sizes(max_tiles: int):
    return [s for s in SIZES if s <= max_tiles]


def build_hetero_cohort(root, sizes, roi, seed=0):
    """One slide a size, prebuilt caches in ``torch_exp_serve``'s layout."""
    slides = torch_exp_serve.build_cohort(root, 0, 0, roi)  # dirs, CACHE_DIR
    cache = os.path.join(root, "cache")
    for i, n in enumerate(sizes):
        rng = np.random.default_rng(seed + i)
        name = f"GHP_{i:03d}_A_H&E.scn"
        with open(os.path.join(slides, name), "wb") as f:
            f.write(b"synthetic")
        base = name.split(".")[0]
        tiles = np.clip(np.array([140, 60, 170], np.int16)
                        + rng.integers(-40, 40, (n, roi, roi, 3)),
                        0, 255).astype(np.uint8)
        coords = np.stack([[(j % 8) * roi, (j // 8) * roi]
                           for j in range(n)])
        np.save(os.path.join(cache,
                             f"data_{base}_rois_size{roi}_hsvcut_v3.npy"),
                tiles)
        np.save(os.path.join(cache,
                             f"coor_{base}_rois_size{roi}_hsvcut_v3.npy"),
                coords)
    return slides


def serve_argv(slides, out_root, args, extra):
    return ["--watch_dir", slides, "--out_root", out_root,
            "--arch", args.arch, "--resolution", str(args.res),
            "--roi_size", str(args.roi), "--chunk", str(args.chunk),
            "--once", "--settle_secs", "0", "--seed", "0"] + extra


def child(argv, device) -> dict:
    """In the variant's interpreter: ``serve.main(argv)`` twice (the second
    into ``<out_root>_repeat``), recording each extractor call's chunk
    shape and the pool's launches. Returns the record the parent reads."""
    from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.parallel import (  # noqa: E501
        inference,
    )
    from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.train import (  # noqa: E501
        serve,
    )

    shapes = set()
    make = inference.make_transform_extract

    def counting(*a, **k):
        extract = make(*a, **k)

        def run(cnn, raw_u8):
            shapes.add(tuple(raw_u8.shape))
            return extract(cnn, raw_u8)
        return run

    inference.make_transform_extract = counting
    prewarm, prewarm_secs = serve.SlideServer.prewarm, []

    def timed_prewarm(self):
        t = time.perf_counter()
        prewarm(self)
        TM.sync(self.device)
        prewarm_secs.append(time.perf_counter() - t)

    serve.SlideServer.prewarm = timed_prewarm
    out_root = argv[argv.index("--out_root") + 1]
    with TM.kernel_record() as rec:
        t0 = time.perf_counter()
        rc = serve.main(argv, device=device)
        TM.sync(device or "cuda")
        wall = time.perf_counter() - t0
    rec = TM.launches_json(rec)
    n_shapes = len(shapes)
    repeat = list(argv)
    repeat[repeat.index("--out_root") + 1] = out_root + "_repeat"
    rc_repeat = serve.main(repeat, device=device)
    return {"rc": rc, "rc_repeat": rc_repeat, "wall_s": wall,
            "prewarm_secs": prewarm_secs[0], "n_shapes": n_shapes,
            "n_shapes_after_repeat": len(shapes), **rec}


# a fresh interpreter running ``child``
_CHILD = ("import json, sys; sys.path.insert(0, {root!r}); "
          "from tools import torch_exp_serve_hetero as H; "
          "print(json.dumps(H.child(sys.argv[1:], {device!r})))")


def run_variant(tag, slides, out_root, args, extra, card):
    device = "cpu" if args.device == "cpu" else None
    argv = serve_argv(slides, out_root, args, extra)
    proc = subprocess.run(
        [sys.executable, "-c", _CHILD.format(root=_ROOT, device=device)]
        + argv, capture_output=True, text=True, timeout=args.timeout)
    rows = torch_exp_serve.read_results(out_root)
    again = {r[0]: float(r[-1])
             for r in torch_exp_serve.read_results(out_root + "_repeat")}
    if proc.returncode != 0 or not rows:
        print(proc.stdout[-2000:], proc.stderr[-2000:], sep="\n",
              file=sys.stderr)
        res = {"variant": tag, "rc": proc.returncode, "n_slides": len(rows)}
        print(json.dumps(res), flush=True)
        return res
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    secs = [float(r[-1]) for r in rows]
    new = [float(r[-1]) for r in rows[1:]]
    res = {
        "variant": tag, "rc": got["rc"], "rc_repeat": got["rc_repeat"],
        "n_slides": len(rows), "slide_tiles": [int(r[6]) for r in rows],
        "slide_probs": [[float(v) for v in r[1:4]] for r in rows],
        "distinct_sizes": len({r[6] for r in rows}),
        "n_shapes": got["n_shapes"],
        "n_shapes_after_repeat": got["n_shapes_after_repeat"],
        "drain_wall_secs": got["wall_s"],
        "prewarm_secs": got["prewarm_secs"], "sum_slide_secs": sum(secs),
        "max_slide_secs": max(secs),
        "warm_last5_median_secs": statistics.median(secs[-5:]),
        "new_shape_median_secs": statistics.median(new or secs),
        "repeat_shape_median_secs": statistics.median(
            again[r[0]] for r in rows[1:] or rows),
        **{k: got[k] for k in ("pool_launches", "pool_T", "stem_launches",
                                "stem_pool_launches")},
        "rows": rows, "device": device or "cuda", **card}
    print(json.dumps({k: v for k, v in res.items() if k != "rows"}),
          flush=True)
    return res


def run(args):
    device = TM.resolve(args.device, "torch_exp_serve_hetero")
    card = TM.card_record(device)
    sizes = cohort_sizes(args.max_tiles)
    workdir = (os.path.abspath(args.keep) if args.keep
               else tempfile.mkdtemp(prefix="torch_serve_hetero_"))
    try:
        slides = build_hetero_cohort(workdir, sizes, args.roi)
        print(f"# cohort: {len(sizes)} slides, sizes {min(sizes)}.."
              f"{max(sizes)} ({workdir})", file=sys.stderr)
        results = []
        for tag, extra in (("plain", []),
                           ("prewarm", ["--prewarm", str(args.max_tiles)])):
            out = os.path.join(workdir, f"out_{tag}")
            for d in (out, out + "_repeat"):
                shutil.rmtree(d, ignore_errors=True)
            results.append(run_variant(tag, slides, out, args, extra, card))
        return sizes, results
    finally:
        if not args.keep:
            shutil.rmtree(workdir, ignore_errors=True)


def build_argparser():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="full", choices=["full", "tiny"])
    ap.add_argument("--res", default=300, type=int)
    ap.add_argument("--roi", default=300, type=int)
    ap.add_argument("--chunk", default=256, type=int)
    ap.add_argument("--max_tiles", default=250, type=int,
                    help="the largest slide: the cohort is the JAX tool's "
                         "sizes up to it")
    ap.add_argument("--timeout", default=3600, type=int)
    ap.add_argument("--keep", default=None,
                    help="keep the cohort and outputs in this dir")
    ap.add_argument("--device", default=None, help="the card unless 'cpu'")
    return ap


def main(argv=None) -> int:
    _, results = run(build_argparser().parse_args(argv))
    return 0 if all(r["rc"] == 0 for r in results) else 1


if __name__ == "__main__":
    raise SystemExit(main())
