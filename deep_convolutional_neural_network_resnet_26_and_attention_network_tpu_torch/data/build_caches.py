"""Offline tile-cache builder CLI.

Counterpart of ``data/build_caches.py`` in the JAX package. The reference
built tile caches lazily inside the first training run (RoiBuilder.build()
on a cache miss mid-epoch, reference: RoiBuilder.py:128-177), a
multi-hour surprise on a fresh cohort. This makes the preprocessing stage
explicit: scan a slide directory, run the tissue filter on the host (the
native C++ filter, ``data/native.py``, where ``g++`` builds it, else the
torch filter on the CPU, ``data/tissue.py``; both keep the same tiles),
and persist the same ``{data,coor}_*_rois_size*_hsvcut_v3.npy`` caches the
datasets, the trainer and the daemon read.

    CACHE_DIR=/path/to/cache python -m ...data.build_caches \\
        --data_root /slides_root --image_dir All_HE_scans_GBM_AN

``--workers N`` builds N slides at once in spawned worker processes: a
cohort's cold start is decode and tissue-filter bound on the host, and
every slide is independent (each cache pair is written tmp +
``os.replace``, so concurrent builders never leave a torn pair). Serial or
parallel, every builder runs on the CPU, so no process opens a CUDA
context, and both write the same bytes.
"""

import argparse
import glob
import multiprocessing as mp
import os
import sys
import time

from . import native
from .roibuilder import RoiBuilder


def _build_one(path: str, params: dict):
    """Build one slide's cache; returns (name, ntiles, was_cached, secs,
    err). Module-level so spawned pool workers can pickle it; must not
    raise (a corrupt slide must not sink the cohort)."""
    t0 = time.perf_counter()
    try:
        b = RoiBuilder(path, dict(params), device="cpu")
        was_cached = "VALID" in b.params["status"]
        b.build()
        return (b.getname(), b.getsize(), was_cached,
                time.perf_counter() - t0, None)
    except Exception as e:  # noqa: BLE001 - reported per slide
        return (os.path.basename(path), 0, False,
                time.perf_counter() - t0, f"{type(e).__name__}: {e}")


class _StarBuild:
    """Picklable single-argument adapter binding the builder params for
    ``Pool.imap_unordered`` (a lambda would not pickle under spawn)."""

    def __init__(self, params: dict):
        self.params = params

    def __call__(self, path: str):
        return _build_one(path, self.params)


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Prebuild RoiBuilder tile caches for a slide directory")
    ap.add_argument("--data_root", required=True)
    ap.add_argument("--image_dir", default="All_HE_scans_GBM_AN")
    ap.add_argument("--glob", default="*H&E.scn,*.svs",
                    help="comma-separated slide patterns "
                         "(reference: gbm/GlioblastomaDS.py:130,177)")
    ap.add_argument("--roi_size", default=None, type=int,
                    help="tile size on the slide (default: RoiBuilder's "
                         "1200; cache filenames encode it)")
    ap.add_argument("--workers", default=1, type=int,
                    help="parallel slide builders (spawned processes; "
                         "slides are independent and cache writes are "
                         "atomic). Every builder filters on the host, "
                         "never on the card")
    args = ap.parse_args(argv)
    if args.workers < 1:
        ap.error(f"--workers must be >= 1, got {args.workers}")

    root = os.path.join(args.data_root, args.image_dir)
    files = sorted(f for pat in args.glob.split(",")
                   for f in glob.glob(os.path.join(root, pat.strip())))
    if not files:
        print(f"no slides match {args.glob} under {root}", file=sys.stderr)
        return 2

    params = {"roi_size": args.roi_size} if args.roi_size else {}
    # build the native filter once here rather than in every worker
    native.available()
    pool = None
    if args.workers == 1:
        results = (_build_one(p, params) for p in files)
    else:
        # spawn, not fork: the parent has threads (and may hold a CUDA
        # context), which fork does not carry over safely; the workers
        # import the package afresh, which touches no device
        pool = mp.get_context("spawn").Pool(min(args.workers, len(files)))
        results = pool.imap_unordered(_StarBuild(params), files, chunksize=1)

    built = cached = failed = done = 0
    try:
        for name, ntiles, was_cached, secs, err in results:
            done += 1
            if err:
                failed += 1
                print(f"[{done}/{len(files)}] FAILED {name}: {err}")
                continue
            cached += was_cached
            built += not was_cached
            print(f"[{done}/{len(files)}] {name}: {ntiles} tiles "
                  f"({'cached' if was_cached else f'{secs:.1f}s'})")
    finally:
        if pool is not None:
            pool.close()
            pool.join()
    print(f"done: {built} built, {cached} already cached, {failed} failed")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
