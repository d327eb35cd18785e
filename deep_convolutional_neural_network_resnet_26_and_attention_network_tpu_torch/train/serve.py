"""Persistent slide-inference service (serving daemon).

Counterpart of ``train/serve.py`` in the JAX package, with the same flags
and artifacts: a long-running process that watches a directory (or
re-reads a manifest) for whole-slide images, builds or reuses the
RoiBuilder tile cache, classifies each slide with the attention-MIL model
on the card, and appends one ``results.csv`` row plus caMicroscope ``.dla``
attention maps per slide (reference: gbm/classify_combined.py:221-298,
reshaped into a restartable service).

  * every slide goes through ``parallel.inference.classify_slide_streaming``
    (exact for any bag size, one chunk plus the [T, L] features resident);
    ``--batch N`` groups up to N small slides (``--batch_tile_cap``) into
    one extractor call, then pools each on its own rows;
  * ``--io_depth N`` prepares up to N slides ahead (cache build, transform
    arming, a readahead hint on the raw cache) on a background thread while
    the card classifies the current one;
  * idempotent restarts: processed basenames persist to ``processed.txt``
    (append + fsync per slide), and startup adopts any ``results.csv`` row
    whose marker is missing; a crash mid-slide redoes only that slide;
  * SIGTERM drains: the slide in flight finishes and is recorded, then the
    daemon exits 0;
  * ``--prewarm TILES`` builds the pool kernel's library and runs one zero
    chunk of min(``--chunk``, TILES) tiles through the extractor and the
    pool, so the first slide of at least that many tiles pays neither
    ``nvcc`` nor cuDNN's first call at the chunk shape;
  * ``--int8`` serves the W8A8 int8 extractor (``ops/quant.py``): it
    quantizes the weights and calibrates the activation scales on the
    first slide that has tiles (a daemon has no cohort up front), then the
    streaming per-chunk program and the ``--batch`` group's extractor are
    the quantized ones;
  * ``--bundle DIR`` serves an AOT bundle (``deploy.py export``): the
    programs and weights come from the bundle, no model is built in the
    daemon, ``--ckpt`` is ignored, the resolution and roi size follow the
    bundle's manifest, and ``--prewarm`` runs each bundle program once. A
    tile-less slide fails (a bundle has no zero-bag program) and is
    retried like any bad slide.

``--mesh N`` serves on N cards, one rank each (``parallel/mesh.py``):
rank 0 polls the manifest or the directory, prepares each slide and sends
its path (or a ``--batch`` group's paths) to the other ranks; every rank
then takes its share of the slide's tiles (the streaming path spreads each
chunk over every rank; a batch spreads its slides and tiles over the mesh),
and rank 0 writes the row and the ``.dla`` maps. Every rank must succeed
on a slide, or all of them count it as failed. ``--int8`` calibrates on
rank 0 and sends the scales to the others; ``--prewarm`` warms each card;
``--bundle`` refuses ``--mesh``, as in the JAX package. The device is an
argument of :class:`SlideServer` and :func:`main` (the card by default),
not a flag.

Run::

    python -m deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.train.serve \\
        --ckpt run_R1/train_step-340.model --manifest slides.txt --once
"""

import argparse
import glob as globmod
import os
import signal
import sys
import threading
import time

import numpy as np
import torch

from .._device import resolve_device
from ..data.loader import prefetch_iter
from ..data.roibuilder import EMPTY_BAG_TILES, ROI_SIZE, RoiBuilder
from ..models import attention_mil as amil
from ..ops import _build
from ..parallel import inference
from ..parallel import mesh as M
from ..utils import helpers
from . import checkpoint
from .classify import make_config

SLIDE_EXTS = (".scn", ".svs", ".tif", ".tiff", ".npy")
CSV_HEADER = ("name,prob_0,prob_1,prob_2,pred,Aterm_var,ntiles,secs\n")


def build_argparser():
    p = argparse.ArgumentParser(
        description="watch-folder / manifest slide classification service")
    p.add_argument("--ckpt", default=None,
                   help="train_step-NNN.model checkpoint (random init with "
                        "a warning if unset: smoke tests only)")
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--watch_dir",
                     help="directory to poll for new slide files")
    src.add_argument("--manifest",
                     help="text file of slide paths (one per line); "
                          "re-read every poll, so it may grow")
    p.add_argument("--out_root", default="serve_data")
    p.add_argument("--resolution", default=300, type=int)
    p.add_argument("--roi_size", default=None, type=int)
    p.add_argument("--arch", default="full", choices=["full", "tiny"])
    p.add_argument("--stem", default="conv7", choices=["conv7", "s2d"])
    p.add_argument("--f32", action="store_true",
                   help="float32 convs and matmuls instead of bf16")
    p.add_argument("--int8", action="store_true",
                   help="serve the W8A8 int8 extractor (ops/quant.py); "
                        "activation scales calibrate on the first slide "
                        "with tiles")
    p.add_argument("--bundle", default=None,
                   help="serve an AOT deployment bundle (deploy.py "
                        "export): programs and weights come from the "
                        "bundle, no model is built and --ckpt is ignored; "
                        "resolution/roi_size follow the bundle manifest. "
                        "Mutually exclusive with --int8/--batch/--mesh "
                        "(those recompose the live program)")
    p.add_argument("--int8_calib", default=256, type=int,
                   help="calibration tiles for the --int8 activation scales")
    p.add_argument("--chunk", default=1024, type=int,
                   help="streaming chunk (tiles per extractor call)")
    p.add_argument("--batch", default=1, type=int,
                   help="group up to N small slides into ONE extractor "
                        "call (then one pool launch per slide); slides "
                        "over --batch_tile_cap still stream individually")
    p.add_argument("--batch_tile_cap", default=1024, type=int,
                   help="slides with more tiles than this take the "
                        "streaming path instead of a batch")
    p.add_argument("--mesh", default=0, type=int,
                   help="serve on N cards, one rank each: each streamed "
                        "chunk's tiles (and each --batch group's slides "
                        "and tiles) spread over the ranks; rank 0 polls "
                        "and writes")
    p.add_argument("--io_depth", default=1, type=int,
                   help="prepare (cache build / readahead) up to N slides "
                        "ahead on a background thread while the card "
                        "classifies the current one; 0 disables the "
                        "overlap")
    p.add_argument("--poll_secs", default=5.0, type=float)
    p.add_argument("--settle_secs", default=2.0, type=float,
                   help="skip files modified more recently than this "
                        "(mid-copy uploads)")
    p.add_argument("--prewarm", default=0, type=int, metavar="TILES",
                   help="before watching, build the pool kernel's library "
                        "and run one zero chunk of min(--chunk, TILES) "
                        "tiles through the extractor and the pool, so the "
                        "first slide of at least that many tiles pays "
                        "neither nvcc nor cuDNN's first call at the chunk "
                        "shape. Shapes follow --roi_size and --chunk; under "
                        "--int8 the extractor is left out (it is built "
                        "after calibration)")
    p.add_argument("--once", action="store_true",
                   help="process the current backlog, then exit")
    p.add_argument("--seed", default=0, type=int)
    return p


def _refuse_bundle_mix(args):
    if args.bundle and (args.int8 or args.batch > 1 or args.mesh):
        raise SystemExit(
            "serve: --bundle serves the exported programs as-is; "
            "--int8/--batch/--mesh recompose the live program and "
            "cannot apply — re-export a bundle with the variant you "
            "need")


class SlideServer:
    """The daemon's state: model, output files, processed set, retries.
    ``device`` is where the model runs and bags are built (the card unless
    ``"cpu"`` is asked for). With ``mesh`` this is one rank of a mesh:
    rank 0 leads (:meth:`run`) and owns the files, the others follow it
    (:meth:`follow`)."""

    MAX_ATTEMPTS = 3
    GIVEUP_BACKOFF_SECS = 300.0

    def __init__(self, args, *, device=None, mesh=None):
        _refuse_bundle_mix(args)
        self.args = args
        self.device = resolve_device(device)
        self.mesh = mesh
        self.cfg = make_config(args)
        self.compute_dtype = None if args.f32 else torch.bfloat16
        if mesh is None or mesh.rank == 0:
            os.makedirs(args.out_root, exist_ok=True)
        self.results_path = os.path.join(args.out_root, "results.csv")
        self.processed_path = os.path.join(args.out_root, "processed.txt")
        # graceful-stop latch (SIGTERM from a supervisor, see main()):
        # finish the slide in flight, record it, exit 0
        self._stop_event = threading.Event()

        self.bundle = self.model = None
        if args.bundle:
            from .. import deploy

            self.bundle = deploy.DeployedClassifier(args.bundle,
                                                    device=self.device)
            m = self.bundle.manifest
            # the builders' tiling and resolution must be what the
            # extractor program was traced for
            args.resolution = int(m["resolution"])
            args.roi_size = int(m["roi_size"])
            print(f"serve: AOT bundle {args.bundle} "
                  f"({len(m['programs'])} programs, res {m['resolution']}, "
                  f"roi {m['roi_size']}, max_tiles {m['max_tiles']})"
                  + ("; --ckpt ignored" if args.ckpt else ""))
        else:
            self.model = amil.init_attention_mil(
                torch.Generator().manual_seed(args.seed), self.cfg,
                device=self.device)
            if args.ckpt:
                _, loaded, skipped = checkpoint.restore_params(self.model,
                                                               args.ckpt)
                print(f"serve: loaded {len(loaded)} tensors "
                      f"({len(skipped)} skipped) from {args.ckpt}")
            else:
                print("serve: WARNING: no --ckpt, classifying with random "
                      "weights (smoke-test mode)")
        # --int8 calibrates lazily on the first slide with tiles; until
        # then (and without --int8) the default extractor serves
        self._transform_extract = None
        self._int8_extractor = None
        self._int8_pending = bool(args.int8)
        self._binfer = None  # (extractor, batched fn) for --batch

        # per-name failure tracking (in memory): after MAX_ATTEMPTS a name
        # backs off for GIVEUP_BACKOFF_SECS instead of burning a rebuild
        # every poll, and is retried after that. name -> (count, last_ts)
        self.attempts = {}

        self.processed = set()
        if mesh is not None and mesh.rank != 0:
            return  # a follower writes nothing and keeps no backlog
        if os.path.isfile(self.processed_path):
            with open(self.processed_path) as f:
                self.processed = {ln.strip() for ln in f if ln.strip()}
        if not os.path.isfile(self.results_path):
            with open(self.results_path, "w") as f:
                f.write(CSV_HEADER)
        else:
            # reconcile: a crash between the results.csv append and the
            # processed.txt marker leaves a row without a marker; its .dla
            # maps were written before the row, so adopt it as processed
            with open(self.results_path) as f:
                in_csv = {ln.split(",", 1)[0]
                          for ln in f.read().splitlines()[1:] if ln}
            for name in sorted(in_csv - self.processed):
                print(f"serve: reconciled {name} (results row present, "
                      "marker missing)")
                self._mark_processed(name)

    # ------------------------------------------------------------------
    def _ensure_int8(self, builder):
        """Arm the int8 extractor on ``builder``'s first ``--int8_calib``
        tiles (a capped read off the memory-mapped cache), unless armed. A
        tile-less slide defers it to the next slide: calibrating on the
        zeros fallback would floor every activation scale."""
        if not self._int8_pending:
            return
        from ..ops import quant

        cnn = self.model.cnn
        qp_sc, n, err = None, 0, None
        if self.mesh is None or self.mesh.rank == 0:
            try:
                calib = quant.calib_tiles_from_builder(
                    builder, max(int(self.args.int8_calib), 1),
                    self.args.resolution)
                if calib is not None:
                    qp_sc = quant.quantize_and_calibrate(cnn, calib)
                    n = int(calib.shape[0])
            except Exception as e:
                if self.mesh is None:
                    raise
                err = e
        if self.mesh is not None:
            # rank 0 calibrates and sends every rank its scales, or its
            # error: then every rank fails the slide together
            qp_sc, n, failed = M.broadcast_object(
                (qp_sc, n, None if err is None else repr(err)), self.mesh)
            if failed:
                raise err or RuntimeError(f"int8 calibration failed on "
                                          f"rank 0: {failed}")
        if qp_sc is None:
            print(f"serve: int8 calibration deferred: {builder.getname()} "
                  "has no tiles")
            return
        self._transform_extract = quant.make_int8_transform_extract(
            cnn, None, self.args.resolution, qp_sc=qp_sc)
        self._int8_extractor = quant.make_int8_extractor(cnn, None,
                                                         qp_sc=qp_sc)
        self._int8_pending = False
        print(f"serve: int8 W8A8 extractor armed ({n} calibration tiles "
              f"from {builder.getname()})")

    def _mark_processed(self, name: str):
        self.attempts.pop(name, None)
        self.processed.add(name)
        with open(self.processed_path, "a") as f:
            f.write(name + "\n")
            f.flush()
            os.fsync(f.fileno())

    def _make_builder(self, path: str) -> RoiBuilder:
        params = {"roi_size": self.args.roi_size} if self.args.roi_size \
            else {}
        return RoiBuilder(path, params, device=self.device)

    def _write_row(self, name, probs, pred, aterm_var, ntiles, secs):
        with open(self.results_path, "a") as f:
            f.write("{0},{1},{2},{3},{4},{5},{6},{7:.3f}\n".format(
                name, *[f"{p:.6f}" for p in probs[:3]], int(pred),
                float(aterm_var), ntiles, secs))
            f.flush()

    def process(self, path: str, builder: RoiBuilder | None = None
                ) -> bool | None:
        """Classify one slide. True = classified, False = failed (cache
        build), None = already processed (skip, not a failure)."""
        t0 = time.perf_counter()
        builder = builder or self._make_builder(path)
        name = builder.getname()
        if name in self.processed:
            return None
        if "MISSING" in builder.params["status"] and not builder.build():
            print(f"serve: {name}: cache build failed, skipped",
                  file=sys.stderr)
            return False
        builder.update_resolution_and_buffer(self.args.resolution)
        if self.bundle is not None:
            # a bundle has no zero-bag program (that fallback needs the
            # one-pass forward): fail, and the retry and backoff report it
            # like any bad slide
            if builder.getsize() == 0:
                print(f"serve: {name}: tile-less slide — AOT bundles "
                      "serve tiled slides only, skipped", file=sys.stderr)
                return False
            probs, outs, raster = self.bundle.classify_builder(builder)
        else:
            probs, outs, raster = self._lead(("slide", path),
                                             lambda: builder,
                                             self._classify_slide)
        T = raster.shape[0]
        helpers.write_map(builder.getmeta(), 0, np.asarray(raster),
                          np.asarray(outs["Aterm"])[:, :T],
                          output_dir=self.args.out_root)
        secs = time.perf_counter() - t0
        self._write_row(name, probs, outs["y_pred_hat"], outs["Aterm_var"],
                        builder.getsize(), secs)
        self._mark_processed(name)
        print(f"serve: {name}: probs={np.round(probs, 4)} "
              f"pred={int(outs['y_pred_hat'])} "
              f"({builder.getsize()} tiles, {secs:.2f}s)")
        return True

    def _classify_slide(self, builder):
        """One slide through the streaming path, on every rank of the
        mesh together when there is one."""
        self._ensure_int8(builder)
        return inference.classify_slide_streaming(
            self.model, self.cfg, builder, resolution=self.args.resolution,
            chunk=self.args.chunk, compute_dtype=self.compute_dtype,
            transform_extract=self._transform_extract, mesh=self.mesh)

    def _together(self, prepare, run):
        """``run(prepare())`` on this rank, in step with the others: every
        rank first settles whether its ``prepare`` (host work, no
        collective) succeeded, so that no rank enters the collectives of
        ``run`` while another has dropped out, then whether ``run``
        succeeded. ``run`` keeps the ranks in step through a failure
        itself: the int8 calibration sends rank 0's error with its result,
        and the serving paths settle their local work before their first
        collective (``parallel/inference.py``). A failure on any rank
        raises on every rank (one per slide: the daemon's retry and
        backoff see it on rank 0)."""
        state = M.run_together(prepare, self.mesh, what="preparing a slide")
        return M.run_together(lambda: run(state), self.mesh,
                              what="classifying a slide")

    def _lead(self, cmd, prepare, run):
        """Rank 0 (or the only rank): send ``cmd`` to the other ranks,
        then :meth:`_together`."""
        if self.mesh is None:
            return run(prepare())
        M.broadcast_object(cmd, self.mesh)
        return self._together(prepare, run)

    def _follower_builder(self, path):
        builder = self._make_builder(path)
        builder.update_resolution_and_buffer(self.args.resolution)
        return builder

    def follow(self) -> int:
        """A mesh rank other than 0: do what rank 0 sends, a slide or a
        ``--batch`` group, in step with it, until it stops (``--once``
        drained, or a stop request)."""
        if self.args.prewarm:
            self.prewarm()
        while True:
            kind, payload = M.broadcast_object(None, self.mesh)
            if kind == "stop":
                return 0
            if kind == "poll":
                continue
            try:
                if kind == "slide":
                    self._together(lambda: self._follower_builder(payload),
                                   self._classify_slide)
                elif kind == "group":
                    self._together(
                        lambda: self._group_bags(
                            [self._follower_builder(p) for p in payload]),
                        self._classify_group)
            except Exception as e:  # rank 0 records the failure
                print(f"serve: rank {self.mesh.rank}: {kind} failed: {e}",
                      file=sys.stderr)

    def _batched_infer(self):
        """The batched forward of ``--batch``, rebuilt when the extractor
        changes (``--int8`` arms after the first slide with tiles). The
        eval transform runs on the card, so a group ships raw uint8."""
        ex = self._int8_extractor
        if self._binfer is None or self._binfer[0] is not ex:
            self._binfer = (ex, inference.make_batched_infer(
                self.cfg, mesh=self.mesh, compute_dtype=self.compute_dtype,
                extractor=ex, transform_resolution=self.args.resolution))
        return self._binfer[1]

    def _group_bags(self, builders):
        """The group's builders, raw tile stacks and rasters (host work)."""
        bags, rasters = [], []
        for b in builders:
            raw, coords = b._load_cache(with_coords=True, mmap=True)
            if raw.shape[0] == 0:  # the router sends tile-less slides to
                # the serial path; this guards a cache emptied since
                rs = b.params["roi_size"]
                raw = np.zeros((EMPTY_BAG_TILES, rs, rs, 3), np.uint8)
                coords = np.zeros((0, 2), np.int64)
            bags.append(raw)
            rasters.append(np.asarray(coords))
        return builders, bags, rasters

    def _classify_group(self, state):
        """A ``--batch`` group through the batched forward (over the mesh
        when there is one): ``(rasters, (probs, outs))``."""
        builders, bags, rasters = state
        if self._int8_pending:
            armed_on = next((b for b in builders if b.getsize() > 0), None)
            if armed_on is not None:
                self._ensure_int8(armed_on)
        return rasters, inference.classify_slides_batched(
            self.model, self.cfg, bags, infer_fn=self._batched_infer(),
            mesh=self.mesh)

    def process_group(self, builders) -> int:
        """--batch: several small slides through one extractor call, then
        one pool per slide; the same artifacts per slide as ``process``."""
        t0 = time.perf_counter()
        rasters, (probs, outs) = self._lead(
            ("group", [b.params["fullpath"] for b in builders]),
            lambda: self._group_bags(builders), self._classify_group)
        secs = (time.perf_counter() - t0) / max(len(builders), 1)
        n_done = 0
        for i, b in enumerate(builders):
            if b.getname() in self.processed:
                continue  # a retried group where this member already won
            T = rasters[i].shape[0]
            helpers.write_map(b.getmeta(), 0, rasters[i],
                              outs["Aterm"][i][:, :T],
                              output_dir=self.args.out_root)
            self._write_row(b.getname(), probs[i], outs["y_pred_hat"][i],
                            outs["Aterm_var"][i], b.getsize(), secs)
            self._mark_processed(b.getname())
            print(f"serve: {b.getname()}: probs={np.round(probs[i], 4)} "
                  f"pred={int(outs['y_pred_hat'][i])} ({b.getsize()} "
                  f"tiles, batched x{len(builders)}, {secs:.2f}s/slide)")
            n_done += 1
        return n_done

    # ------------------------------------------------------------------
    def pending(self):
        """Slide paths not yet processed, oldest first."""
        if self.args.watch_dir:
            paths = [p for p in globmod.glob(
                os.path.join(self.args.watch_dir, "*"))
                if p.lower().endswith(SLIDE_EXTS)]
        else:
            paths = []
            if os.path.isfile(self.args.manifest):
                with open(self.args.manifest) as f:
                    paths = [ln.strip() for ln in f if ln.strip()
                             and not ln.startswith("#")]
        now = time.time()
        by_name = {}
        for p in paths:
            name = os.path.split(p)[1].split(".")[0]
            if name in self.processed:
                continue
            count, last_ts = self.attempts.get(name, (0, 0.0))
            if (count >= self.MAX_ATTEMPTS
                    and now - last_ts < self.GIVEUP_BACKOFF_SECS):
                continue  # backing off; retried after the window
            try:  # a file can vanish between the glob and the stat
                mtime = os.path.getmtime(p)
            except OSError:
                continue
            if now - mtime < self.args.settle_secs:
                continue  # likely mid-upload; the next poll takes it
            # one entry per basename (the RoiBuilder keys caches on it):
            # keep the oldest and let the marker suppress the other
            if name not in by_name or mtime < by_name[name][0]:
                by_name[name] = (mtime, p)
        return [p for _, p in sorted(by_name.values())]

    def _note_failure(self, name, err=None):
        if err is not None:
            print(f"serve: ERROR on {name}: {err}", file=sys.stderr)
        count = self.attempts.get(name, (0, 0.0))[0] + 1
        self.attempts[name] = (count, time.time())
        if count >= self.MAX_ATTEMPTS:
            print(f"serve: backing off {name} for "
                  f"{self.GIVEUP_BACKOFF_SECS:.0f}s after {count} "
                  "failures", file=sys.stderr)

    def _prepare(self, path):
        """Host-side prep of ONE slide: builder, cache build (decode +
        tissue filter), transform arming and a readahead hint on the raw
        cache. Under ``--io_depth`` it runs on the producer thread, so it
        writes no daemon state (it only reads ``self.processed``, which
        the consumer checks again before any artifact write). Returns
        ``(path, name, builder, err)``; builder None with err None means
        'already processed, skip'."""
        name = os.path.split(path)[1].split(".")[0]
        try:
            builder = self._make_builder(path)
            if builder.getname() in self.processed:
                return path, name, None, None
            if ("MISSING" in builder.params["status"]
                    and not builder.build()):
                return path, name, None, RuntimeError("cache build failed")
            builder.update_resolution_and_buffer(self.args.resolution)
            builder.readahead()
            return path, name, builder, None
        except Exception as e:  # reported per slide by the drain loop
            return path, name, None, e

    def _try(self, path, builder, name):
        """Serial path for one prepared slide; returns (done, failed)."""
        try:
            ok = self.process(path, builder=builder)
        except Exception as e:  # one bad slide must not kill the daemon;
            # it is NOT marked processed, so a retry can succeed
            self._note_failure(name, e)
            return 0, 1
        if ok is None:
            return 0, 0
        if not ok:
            self._note_failure(name)
            return 0, 1
        return 1, 0

    def _drain(self, paths):
        """Process one poll's backlog; returns (classified, failed)."""
        done = failed = 0
        group = []  # small builders awaiting a batched forward
        size = max(self.args.batch, 1)

        def flush():
            nonlocal done, failed
            while group:
                g = group[:size]
                del group[:size]
                try:
                    done += self.process_group(g)
                except Exception as e:
                    # one poison slide must not burn its batch-mates'
                    # retry budget: retry each member on the serial path
                    print(f"serve: batched group failed ({e}); retrying "
                          "members individually", file=sys.stderr)
                    for b in g:
                        d, f = self._try(b.params["fullpath"], b,
                                         b.getname())
                        done, failed = done + d, failed + f

        items = map(self._prepare, paths)
        if self.args.io_depth > 0:
            items = prefetch_iter(items, depth=self.args.io_depth)
        for path, name, builder, err in items:
            if self._stop_event.is_set():
                # leave the rest of the backlog for the next start; the
                # queued small-slide group below still flushes
                print("serve: stop requested, abandoning the remaining "
                      "backlog after the in-flight work", flush=True)
                break
            if err is not None:  # construction or cache build failed
                failed += 1
                self._note_failure(name, err)
                continue
            if builder is None:
                continue  # already processed
            # small slides go to the batch, big ones stream; tile-less
            # slides take the serial path, whose fallback is the f32 zero
            # bag of the validation forward
            if (self.args.batch > 1
                    and 0 < builder.getsize() <= self.args.batch_tile_cap):
                group.append(builder)
                if len(group) >= size:
                    flush()
                continue
            d, f = self._try(path, builder, name)
            done, failed = done + d, failed + f
        flush()  # the tail group below the batch size
        return done, failed

    def prewarm(self):
        """--prewarm TILES: build the pool kernel's library, then run one
        zero chunk of min(--chunk, TILES) tiles through the extractor and
        the pool: the chunk every slide of at least that many tiles
        streams at. Slides run at their exact tile counts, so other sizes
        (tails, smaller slides, batched groups) are not known in advance
        and pay cuDNN's first call at their shape. Under --int8 the chunk
        skips the extractor, which exists only after calibration, and
        goes through the pool as zero features. Under --bundle the chunk
        (at most the bundle's) runs through the bundle's two programs."""
        tiles = self.args.prewarm
        if not tiles:
            return
        t0 = time.perf_counter()
        if self.device.type == "cuda":
            _build.load("gated_pool")
        roi = self.args.roi_size or ROI_SIZE
        if self.bundle is not None:
            # each bundle program once, on a zero chunk of min(the bundle's
            # chunk, TILES) tiles
            n = min(self.bundle.manifest["chunk"], tiles)
            self.bundle.pool(self.bundle.extract(torch.zeros(
                (n, roi, roi, 3), dtype=torch.uint8, device=self.device)))
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            print(f"serve: prewarm done (bundle: extractor and pool "
                  f"programs, chunk={n}, {time.perf_counter() - t0:.1f}s)",
                  flush=True)
            return
        n = min(self.args.chunk, tiles)
        if self.mesh is not None:  # each rank extracts its share of a chunk
            n = inference.streaming_chunk_for(
                tiles, self.args.chunk, self.mesh.size) // self.mesh.size
        with torch.no_grad():
            if self.args.int8:
                print("serve: prewarm skips the extractor under --int8 "
                      "(it is built after calibration)", flush=True)
                feats = torch.zeros((n, self.cfg.L), device=self.device)
            else:
                extract = inference.make_transform_extract(
                    self.cfg, resolution=self.args.resolution,
                    compute_dtype=self.compute_dtype)
                part = torch.zeros((n, roi, roi, 3), dtype=torch.uint8,
                                   device=self.device)
                feats = extract(self.model.cnn, part)
            amil.attention_pool(self.model, feats, self.cfg)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        print(f"serve: prewarm done (chunk={n}, "
              f"{time.perf_counter() - t0:.1f}s)", flush=True)

    def request_stop(self):
        """Ask the drain loop to exit after the in-flight slide (signal-
        handler and thread safe; idempotent)."""
        if not self._stop_event.is_set():
            self._stop_event.set()
            print("serve: SIGTERM/stop: finishing the in-flight slide, "
                  "then exiting; restart resumes the backlog", flush=True)

    def run(self) -> int:
        """The daemon's loop (rank 0 of a mesh leads it: the other ranks
        :meth:`follow`, and stop when it returns)."""
        try:
            return self._run()
        finally:
            if self.mesh is not None:
                M.broadcast_object(("stop", None), self.mesh)

    def _run(self) -> int:
        self.prewarm()
        n_total, n_failed = 0, 0
        while True:
            done, failed = self._drain(self.pending())
            n_total += done
            n_failed += failed
            if self.mesh is not None:  # the followers wait between polls
                M.broadcast_object(("poll", None), self.mesh)
            if self._stop_event.is_set():
                print(f"serve: stopped gracefully ({n_total} slides, "
                      f"{n_failed} failed); state is durable, restart "
                      "resumes")
                return 0
            if self.args.once:
                print(f"serve: backlog drained ({n_total} slides, "
                      f"{n_failed} failed); exiting (--once)")
                return 0 if n_failed == 0 else 1
            # interruptible poll: a stop during the wait exits at once
            self._stop_event.wait(timeout=self.args.poll_secs)


def main(argv=None, *, device=None) -> int:
    """The CLI. With ``--mesh N`` it spawns N ranks (``parallel/mesh.py``),
    one card each (N CPU ranks over gloo with ``device="cpu"``), and
    returns rank 0's exit code; asking for more cards than there are
    raises."""
    argv = sys.argv[1:] if argv is None else list(argv)
    args = build_argparser().parse_args(argv)
    if args.mesh:
        _refuse_bundle_mix(args)
        return M.launch(_mesh_rank, args.mesh, args=(argv,),
                        devices=M.mesh_devices(args.mesh, device))[0]
    return _serve(args, device)


def _mesh_rank(mesh, argv):
    """One rank of ``--mesh N``: rank 0 leads the daemon, the others
    follow it."""
    args = build_argparser().parse_args(argv)
    if mesh.rank != 0:
        return SlideServer(args, device=mesh.device, mesh=mesh).follow()
    return _serve(args, mesh.device, mesh=mesh)


def _serve(args, device, mesh=None) -> int:
    print(args)
    server = SlideServer(args, device=device, mesh=mesh)
    try:
        # supervisors (systemd, k8s) stop with SIGTERM: drain the slide in
        # flight, record it, exit 0
        prev = signal.signal(signal.SIGTERM,
                             lambda s, f: server.request_stop())
    except ValueError:  # not the main thread (in-process callers, tests)
        prev = None
    try:
        return server.run()
    except KeyboardInterrupt:
        print("serve: interrupted; state is durable, restart resumes")
        return 0
    finally:
        if prev is not None:
            signal.signal(signal.SIGTERM, prev)


if __name__ == "__main__":
    sys.exit(main())
