"""Serving-daemon steady-state throughput of the PyTorch port on the card.

The twin of ``tools/exp_serve.py``. Builds a synthetic cohort of
pre-cached slides (the cache names ``<port>/data/roibuilder.py`` reads),
then drains it through ``<port>/train/serve.py --once`` in each variant and
reports the cold first slide, the WARM per-slide latency (the median of
the per-slide ``secs`` column of ``results.csv`` after the first slide, or
the first group under ``--batch``), the slides a minute and the drain
wall. Every slide's bag runs the gated pool's forward kernel; the
in-process variants count its launches and the tile counts it pooled.

Variants: live bf16 (``serial_bf16``), ``--batch`` (``batched_x<N>``) and
``--int8`` (``serial_int8``) in this process; with ``--bundle`` first an
AOT bundle is exported (``<port>/deploy.py``) and the cohort drained in
fresh interpreters through ``serve --bundle`` and through the live path
(without and with ``--prewarm``), as the twin runs them.

Usage:
  python tools/torch_exp_serve.py                 # full arch, 300 px, card
  python tools/torch_exp_serve.py --cpu --arch tiny --res 16 --roi 32 \\
      --tiles 24 --slides 6                        # CPU smoke

One JSON line per variant, with the card's name and power limit. Runs on
the card unless ``--cpu``. Imports nothing of JAX.
"""

from __future__ import annotations

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

from tools import torch_measure as TM  # noqa: E402

# a fresh interpreter serving on the caller's device
_CHILD = ("import sys; from {pkg}.train import serve; "
          "sys.exit(serve.main(sys.argv[1:], device={device!r}))")


def build_cohort(root: str, n_slides: int, ntiles: int, roi: int,
                 seed: int = 0) -> str:
    """Synthetic slides + prebuilt roi caches (tissue-like RGB noise), the
    twin's: the same names, tiles and coordinates."""
    cache = os.path.join(root, "cache")
    slides = os.path.join(root, "slides")
    os.makedirs(cache, exist_ok=True)
    os.makedirs(slides, exist_ok=True)
    os.environ["CACHE_DIR"] = cache
    rng = np.random.default_rng(seed)
    for i in range(n_slides):
        name = f"GHP_{i:03d}_A_H&E.scn"
        with open(os.path.join(slides, name), "wb") as f:
            f.write(b"synthetic")
        base = name.split(".")[0]
        tiles = np.clip(
            np.array([140, 60, 170], np.int16)
            + rng.integers(-40, 40, (ntiles, roi, roi, 3)),
            0, 255).astype(np.uint8)
        coords = np.stack(
            [[(j % 8) * roi, (j // 8) * roi] for j in range(ntiles)])
        np.save(os.path.join(
            cache, f"data_{base}_rois_size{roi}_hsvcut_v3.npy"), tiles)
        np.save(os.path.join(
            cache, f"coor_{base}_rois_size{roi}_hsvcut_v3.npy"), coords)
    return slides


def read_results(out_root: str) -> list:
    """``results.csv``'s rows, split on commas."""
    path = os.path.join(out_root, "results.csv")
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [ln.split(",") for ln in f.read().splitlines()[1:] if ln]


def run_variant(tag: str, slides_dir: str, out_root: str, args,
                extra: list, group: int = 1, fresh: bool = False,
                card: dict | None = None) -> dict:
    """Drain the cohort once through ``serve --once``: in this process, or
    with ``fresh`` in its own interpreter."""
    from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.train import (  # noqa: E501
        serve,
    )

    device = "cpu" if args.cpu else None
    argv = ["--watch_dir", slides_dir, "--out_root", out_root,
            "--arch", args.arch, "--resolution", str(args.res),
            "--roi_size", str(args.roi), "--chunk", str(args.chunk),
            "--once", "--settle_secs", "0", "--seed", "0"] + extra
    launches = None
    t0 = time.perf_counter()
    if fresh:
        env = dict(os.environ)
        env["PYTHONPATH"] = _ROOT + os.pathsep + env.get("PYTHONPATH", "")
        rc = subprocess.run(
            [sys.executable, "-c",
             _CHILD.format(pkg=TM.PORT, device=device)] + argv,
            env=env).returncode
    else:
        with TM.kernel_record() as rec:
            rc = serve.main(argv, device=device)
        TM.sync("cpu" if args.cpu else "cuda")
        launches = TM.launches_json(rec)
    wall = time.perf_counter() - t0
    rows = read_results(out_root)
    if not rows:
        res = {"variant": tag, "rc": rc, "n_slides": 0,
               "error": "no results.csv rows"}
        print(json.dumps(res), flush=True)
        return res
    secs = [float(r[-1]) for r in rows]
    # rows append in processing order; the first slide (or, batched, the
    # whole first group, whose members share one figure) carries the
    # first-call costs. Warm = median of everything after it.
    cold = secs[0]
    warm = secs[group:] or secs
    warm_med = float(statistics.median(warm))
    res = {
        "variant": tag, "rc": rc, "n_slides": len(rows),
        "tiles_per_slide": args.tiles, "resolution": args.res,
        "cold_first_slide_secs": round(cold, 3),
        "warm_secs_per_slide": round(warm_med, 4),
        "warm_slides_per_min": (round(60.0 / warm_med, 2)
                                if warm_med > 0 else None),
        "drain_wall_secs": round(wall, 2),
        "device": "cpu" if args.cpu else "gpu", **(card or {}),
    }
    if launches is not None:
        res.update(launches)
    print(json.dumps(res), flush=True)
    return res


def build_argparser():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--slides", default=24, type=int)
    p.add_argument("--tiles", default=64, type=int,
                   help="tiles per slide (biopsy-sized default)")
    p.add_argument("--res", default=300, type=int)
    p.add_argument("--roi", default=300, type=int)
    p.add_argument("--arch", default="full", choices=["full", "tiny"])
    p.add_argument("--chunk", default=1024, type=int)
    p.add_argument("--batch", default=8, type=int,
                   help="group size for the batched variant (0 = skip)")
    p.add_argument("--skip_int8", action="store_true")
    p.add_argument("--bundle", action="store_true",
                   help="add the fresh-host A/B: export an AOT bundle, "
                        "then drain the cohort via `serve --bundle` and "
                        "via the live path, each in its own interpreter")
    p.add_argument("--skip_live", action="store_true",
                   help="with --bundle: skip the live fresh-host variants")
    p.add_argument("--keep", default=None,
                   help="reuse/keep this cohort+output dir")
    p.add_argument("--cpu", action="store_true",
                   help="serve on the host instead of the card")
    return p


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    device = TM.resolve("cpu" if args.cpu else None, "torch_exp_serve",
                        cpu_flag="--cpu")
    card = TM.card_record(device)

    root = args.keep or tempfile.mkdtemp(prefix="torch_exp_serve_")
    slides_dir = build_cohort(root, args.slides, args.tiles, args.roi)
    if args.batch and args.slides % args.batch:
        print(f"WARNING: {args.slides} slides not divisible by batch "
              f"{args.batch}: the tail group is smaller than the others and "
              "moves the batched warm median", file=sys.stderr)
    results = []
    try:
        if args.bundle:
            from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch import (  # noqa: E501
                deploy,
            )

            bundle_dir = os.path.join(root, "bundle")
            t0 = time.perf_counter()
            rc = deploy.main([
                "export", "--out", bundle_dir, "--arch", args.arch,
                "--resolution", str(args.res), "--roi_size", str(args.roi),
                "--chunk", str(args.chunk),
                "--tiles", str(max(args.tiles, args.chunk))],
                device=device.type)
            print(json.dumps({"variant": "bundle_export", "rc": rc,
                              "export_secs": round(time.perf_counter() - t0,
                                                   2), **card}), flush=True)
            fresh_variants = [("bundle_fresh_host", ["--bundle", bundle_dir],
                               1)]
            if not args.skip_live:
                fresh_variants.append(("live_fresh_host", [], 1))
                fresh_variants.append(
                    ("live_fresh_host_prewarm",
                     ["--prewarm", str(max(args.tiles, args.chunk))], 1))
            for tag, extra, group in fresh_variants:
                out_root = os.path.join(root, f"out_{tag}")
                results.append(run_variant(tag, slides_dir, out_root, args,
                                           extra, group, fresh=True,
                                           card=card))
        variants = [("serial_bf16", [], 1)]
        if args.batch:
            variants.append((f"batched_x{args.batch}",
                             ["--batch", str(args.batch)], args.batch))
        if not args.skip_int8:
            variants.append(("serial_int8", ["--int8"], 1))
        for tag, extra, group in variants:
            out_root = os.path.join(root, f"out_{tag}")
            results.append(run_variant(tag, slides_dir, out_root, args,
                                       extra, group, card=card))
    finally:
        if not args.keep:
            shutil.rmtree(root, ignore_errors=True)
    return 0 if all(r["rc"] == 0 for r in results) else 1


if __name__ == "__main__":
    raise SystemExit(main())
