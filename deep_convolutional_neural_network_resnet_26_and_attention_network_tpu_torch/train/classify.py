"""Attention-MIL training, validation and interface CLI: the live driver.

Counterpart of ``train/classify.py`` in the JAX package, after the
reference entry point ``gbm/classify_combined.py`` (flags
--tag --ckpt --fold --epoch_start --epoch_end --transfer --test_only
--interface; reference: gbm/classify_combined.py:44-87) and its artifacts
(per-epoch ``train_step-<epoch:03d>.model`` checkpoints in the JAX
package's format, ``*summary.json`` stats, ``<epoch>predictions.json``,
the split JSON, ``model_structure.txt``, and the caMicroscope manifests,
``.dla`` maps and result tables of ``--interface``). One device: the card
unless ``main`` is given ``device="cpu"``. Each bag's gradient is added
into the parameters' gradients; every ``--accum`` bags (reference:
:446-454), and on a partial tail window, Adam steps at the staged learning
rate (reference: :110-138). ``--int8`` serves the extractor W8A8
(``ops/quant.py``) in ``--interface`` and ``--test_only``; ``--profile``
traces the first trained epoch (``utils/profiling.py``); ``--tensorboard``
logs each epoch's stats (``utils/tb.py``, a no-op without tensorboard).

Every random stream of epoch E is a pure function of (seed, E, bag index):
the bag order (``loader.epoch_loader_seed``), the tile cap and the crop /
flip augmentation (``RoiBuilder.reseed_augment``), and the Gumbel scores
and dropout masks (:meth:`Driver.bag_generator`). So a run resumed from
epoch E-1's checkpoint replays epoch E of the uninterrupted run.

``--mesh N`` trains over N cards, one rank each (``parallel/mesh.py``):
every rank runs the same deterministic loader, and each accumulation
window becomes one window step (``steps.make_train_step``) whose bags
spread over the slide axis and whose tiles spread over the tile axis; a
partial tail window pads with zero-weight copies. Validation and
``--interface`` stream their oversized slides over every rank. Rank 0
writes every file and prints; a resume loads on every rank.

The figures (``train/heatmap.py``, ``utils/plots.py``,
``utils/helpers.py``) need matplotlib, which the card's machine lacks.
``--peak`` (the first conv's kernels and the ResNet's activation stats
and grids on a training bag, then exit) and ``--n_vis N`` (the 2x3
attention panel of up to N slides, each a whole-slide eval forward through
the pool kernel, at epoch 0 and every 10 epochs, and before
``--interface``) exit naming matplotlib where it is missing. ``--n_vis``
defaults to 0 here (the JAX trainer's default is 8). Where matplotlib is
present the trainer also draws, as the JAX trainer does, the prediction
summary of each validation and the metric curves (``plot_gbm_metrics``)
every 5 epochs; where it is missing it says so once at startup and writes
only their data (``*summary.json``, ``<epoch>predictions.json``).

Run ``python -m deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.train.classify --help``.
"""

import argparse
import contextlib
import os
import sys
import time

import numpy as np
import torch

from .._device import resolve_device
from ..data import dataset as ds_mod
from ..data.loader import (epoch_loader_seed, pad_bag, prefetch_iter,
                           sample_data)
from ..models import attention_mil as amil
from ..parallel import inference, steps
from ..parallel import mesh as M
from ..utils import helpers, plots, profiling
from . import DIVERGED_EXIT, PreemptionLatch, checkpoint, schedule

TARGET_NAMES = ["A", "B", "C"]
# the options this port does not have (every option is ported)
NOT_PORTED = {}


def build_argparser():
    p = argparse.ArgumentParser(
        description="Attention-based classifier for WSI images "
                    "(PyTorch/CUDA attention-MIL)")
    p.add_argument("--tag", default="TEST", type=str, help="Output tag")
    p.add_argument("--ckpt", default=None, type=str,
                   help="load from previous checkpoints ('auto': the newest "
                        "in the run directory)")
    p.add_argument("--epoch_start", default=0, type=int)
    p.add_argument("--epoch_end", default=40, type=int)
    p.add_argument("--fold", default=0, type=int,
                   help="Which fold? 0..n_folds-1 selects that KFold fold; "
                        "-1 = the reference's seeded-random middle-fold "
                        "pick; >= n_folds trains on every slide")
    p.add_argument("--transfer", action="store_true",
                   help="Transfer learning: restore ResNet convs only, "
                        "linear layers stay freshly initialized")
    p.add_argument("--peak", action="store_true",
                   help="Inspect weight matrices / activations and exit "
                        "(needs matplotlib)")
    p.add_argument("--test_only", action="store_true",
                   help="Exit after one validation pass")
    p.add_argument("--interface", action="store_true",
                   help="Run in caMicroscope interface mode: classify every "
                        "slide, write .dla maps, manifests and result "
                        "tables under <output_root>/interface_data")
    # configuration the reference hardcoded
    p.add_argument("--data_root", default="/raid/GHP Immunohistochemistry/")
    p.add_argument("--image_dir", default="All_HE_scans_GBM_AN")
    p.add_argument("--label_sheet", default=None,
                   help="the cluster sheet, as csv")
    p.add_argument("--split_ckpt", default=None,
                   help="restore a training_validation_testing_data*.json split")
    p.add_argument("--output_root", default=".")
    p.add_argument("--resolution", default=300, type=int)
    p.add_argument("--roi_size", default=None, type=int,
                   help="tile size on the slide (default: RoiBuilder's 1200)")
    p.add_argument("--accum", default=5, type=int,
                   help="gradient-accumulation slides per optimizer step")
    p.add_argument("--workers", default=1, type=int,
                   help="producer threads for the training bag loader "
                        "(the reference's DataLoader num_workers)")
    p.add_argument("--arch", default="full", choices=["full", "tiny"],
                   help="tiny = smoke-test model (CI/CPU)")
    p.add_argument("--stem", default="conv7", choices=["conv7", "s2d"],
                   help="s2d = space-to-depth stem (identical math)")
    p.add_argument("--seed", default=0, type=int)
    p.add_argument("--f32", action="store_true",
                   help="disable bf16 conv/matmul compute")
    p.add_argument("--remat", action="store_true",
                   help="recompute resnet blocks in the backward pass to fit "
                        "large training bags")
    p.add_argument("--n_vis", default=0, type=int,
                   help="slides whose attention heatmap panel is drawn at "
                        "epoch 0, every 10 epochs and before --interface "
                        "(needs matplotlib above 0; the JAX trainer's "
                        "default is 8)")
    p.add_argument("--tensorboard", action="store_true",
                   help="stream epoch stats to runs/TAG_<tag> under "
                        "--output_root (legacy SummaryWriter parity; a "
                        "no-op without the tensorboard package)")
    p.add_argument("--profile", action="store_true",
                   help="trace the first trained epoch (host, and the "
                        "card's kernels and copies) into <run>/profile/ as "
                        "a Chrome trace, and add per-step wall-time "
                        "percentiles to each epoch's stats")
    p.add_argument("--mesh", default=0, type=int,
                   help="train over an N-card (slides, tiles) mesh, one "
                        "rank a card: each accumulation window of bags "
                        "becomes one window step, its bags over the slide "
                        "axis and each bag's tiles over the tile axis")
    p.add_argument("--train_pad", default=None, type=int,
                   help="zero-pad margin for the train random-crop jitter "
                        "(default: the reference's 100 px at roi 1200, "
                        "scaled to --roi_size); 0 disables the pad/crop")
    p.add_argument("--stream_tiles", default=4096, type=int,
                   help="slides with more tiles than this stream chunks "
                        "through the extractor in validation/interface "
                        "instead of holding the whole f32 bag on the card")
    p.add_argument("--int8", action="store_true",
                   help="serve the extractor W8A8 int8-quantized "
                        "(ops/quant.py): per-channel int8 weights and "
                        "activation scales calibrated on the test slides' "
                        "tiles. Serving only (--interface / --test_only); "
                        "measure the probability drift on your checkpoint "
                        "first")
    p.add_argument("--int8_calib", default=256, type=int,
                   help="calibration tiles for the --int8 activation scales")
    return p


def make_config(args, class_weights=None) -> amil.MILConfig:
    """``args.arch`` ``full`` (widths 20/40/60/80, 3 blocks a stage) or
    ``tiny`` (widths 8, 1 block a stage), ``args.stem`` and ``args.remat``
    (``conv7`` and off unless given) and optional class weights."""
    cw = tuple(class_weights) if class_weights is not None else None
    remat = getattr(args, "remat", False)
    stem = getattr(args, "stem", "conv7")
    if args.arch == "tiny":
        return amil.MILConfig(widths=(8, 8, 8, 8), blocks=(1, 1, 1, 1),
                              class_weights=cw, remat=remat, stem=stem)
    return amil.MILConfig(class_weights=cw, remat=remat, stem=stem)


def _seed_generator(*entropy: int) -> torch.Generator:
    """A CPU generator seeded from a ``SeedSequence`` of ``entropy``."""
    seed = int(np.random.SeedSequence(list(entropy)).generate_state(1)[0])
    return torch.Generator().manual_seed(seed)


class Driver:
    """The model, its optimizer, the step functions and the output paths,
    on ``device`` (the card unless ``"cpu"``). With ``mesh`` this is one
    rank of a mesh (``parallel/mesh.py``): it trains through the window
    step, and only rank 0 writes files (``self.writes``)."""

    def __init__(self, args, cfg: amil.MILConfig, output_dir: str, *,
                 device=None, mesh=None):
        self.args = args
        self.cfg = cfg
        self.output_dir = output_dir
        self.heat_dir = os.path.join(output_dir, "heatmaps")
        self.device = resolve_device(device)
        self.mesh = mesh
        self.writes = mesh is None or mesh.rank == 0
        self.compute_dtype = None if args.f32 else torch.bfloat16
        self.diverged = False  # set by the non-finite-loss guard
        self.stream_tiles = int(args.stream_tiles)

        self.model = amil.init_attention_mil(
            torch.Generator().manual_seed(args.seed), cfg,
            device=self.device).train()
        self.optimizer = steps.make_optimizer(self.model)
        # the write of each epoch's checkpoint overlaps the next epoch; its
        # save() copies the state to the host first, since the next
        # optimizer step updates the parameters in place
        self.ckpt_writer = checkpoint.AsyncCheckpointer()
        self.grad_fn = steps.make_bag_grad(cfg,
                                           compute_dtype=self.compute_dtype)
        self.fwd_eval = steps.make_bag_forward(
            cfg, train=False, compute_dtype=self.compute_dtype)
        self.fwd_train = steps.make_bag_forward(
            cfg, train=True, compute_dtype=self.compute_dtype)
        # the streaming per-chunk program; None is the default extractor,
        # enable_int8 swaps in the int8 one
        self.transform_extract = None
        if mesh is not None:
            self.window_step = steps.make_train_step(
                cfg, mesh=mesh, compute_dtype=self.compute_dtype)
            print(f"Mesh training over {mesh.shape}")

    def replicate(self):
        """On a mesh: every rank takes rank 0's parameters and Adam
        state."""
        if self.mesh is not None:
            steps.replicate_state(self.mesh, self.model, self.optimizer)

    def enable_int8(self, builders):
        """Swap the eval and streaming extractors for the W8A8 int8
        serving path (``ops/quant.py``): quantize the (restored) cnn weights
        once, calibrate the activation scales on up to ``--int8_calib``
        eval-transformed tiles from ``builders`` (only the leading slice of
        each memory-mapped cache is read; tile-less slides are skipped),
        and rebuild ``fwd_eval`` and the streaming program around the
        quantized forward. Serving only: the quantized closures fix the
        weights when built and ignore the live parameters."""
        from ..ops import quant

        want = max(int(self.args.int8_calib), 1)
        chunks, n = [], 0
        for b in builders if self.writes else ():
            tiles = quant.calib_tiles_from_builder(b, want - n,
                                                   self.args.resolution)
            if tiles is None:
                continue
            chunks.append(tiles)
            n += tiles.shape[0]
            if n >= want:
                break
        qp_sc = None
        if n:
            qp_sc = quant.quantize_and_calibrate(self.model.cnn,
                                                 torch.cat(chunks, dim=0))
        if self.mesh is not None:
            # rank 0 calibrates, every rank serves its scales
            qp_sc, n = M.broadcast_object((qp_sc, n), self.mesh)
        if n == 0:
            raise RuntimeError("--int8: no slides with tiles available "
                               "to calibrate on")
        self.fwd_eval = steps.make_bag_forward(
            self.cfg, train=False, compute_dtype=self.compute_dtype,
            extractor=quant.make_int8_extractor(self.model.cnn, None,
                                                qp_sc=qp_sc))
        self.transform_extract = quant.make_int8_transform_extract(
            self.model.cnn, None, self.args.resolution, qp_sc=qp_sc)
        print(f"int8: W8A8 extractor armed ({n} calibration tiles)")

    def _halt_non_finite(self, epoch: int, loss_sum: float) -> bool:
        """A NaN/Inf training loss halts the run BEFORE checkpointing, so
        the newest checkpoint on disk stays the last healthy epoch and
        ``--ckpt auto`` resumes from good state. (The reference saved
        whatever the epoch produced, gbm/classify_combined.py:468-474.)"""
        print(f"FATAL: non-finite training loss (sum={loss_sum}) at epoch "
              f"{epoch}; halting WITHOUT checkpointing; fix the config "
              "and resume from the last good checkpoint (--ckpt auto)",
              file=sys.stderr)
        self.diverged = True  # main() exits DIVERGED_EXIT, not 0
        try:
            self.ckpt_writer.wait()  # the last healthy epoch's write lands
        except Exception as exc:
            # a failed pending write must not mask the divergence: the
            # DIVERGED_EXIT contract is what supervisors key on
            print(f"WARNING: pending checkpoint write also failed: {exc}",
                  file=sys.stderr)
        return False

    def bag_generator(self, epoch: int, n: int, *, validate: bool = False):
        """The generator of bag ``n``'s Gumbel scores and dropout mask in
        epoch ``epoch``: a pure function of (seed, epoch, n), so a resumed
        run replays the uninterrupted run's streams. Validation has a
        disjoint domain, as the JAX package's ``epoch_key`` gives it."""
        base = 1_000_000 + epoch if validate else epoch
        return _seed_generator(self.args.seed, base, n)

    # ------------------------------------------------------------ train
    def train_epoch(self, epoch: int, dataset, epoch_stats: dict):
        stage = schedule.stage_for_epoch(epoch)
        if stage.stop:
            if self.writes:
                self.ckpt_writer.save(checkpoint.checkpoint_path(
                    self.output_dir, epoch, final=True), self.model)
                self.ckpt_writer.wait()
            print(f"Stage = [Stop]: saved FINAL checkpoint at epoch {epoch}")
            return False
        print(f"===> TRAIN: Epoch = {epoch} "
              f"Stage = [{stage.name}], lr = [{stage.lr}]")

        coefs = amil.gate_coefficients(self.model).cpu().numpy()
        for i in range(3):
            epoch_stats[f"coef_a{i + 1}"] = float(coefs[i])

        dataset.train()
        dataset.reseed_augment(self.args.seed, epoch)
        # a mesh rank transforms only its share of each bag's subsample
        dataset.defer_train = self.mesh is not None
        if self.args.workers > 1:
            # parallel producers deliver out of order, so each bag's noise
            # and its window vary from run to run: bit-exact resume holds
            # only for the default single producer
            print("note: --workers > 1 delivers bags out of order; "
                  "bit-exact determinism/resume requires --workers 1")
        loader = sample_data(dataset, image_size=self.args.resolution,
                             shuffle=True,
                             seed=epoch_loader_seed(self.args.seed, epoch),
                             workers=self.args.workers)
        if self.mesh is not None:
            return self._train_epoch_mesh(epoch, stage, loader, epoch_stats)

        # the scalars stay on the device through the epoch; one copy at
        # the end
        keys = ("loss", "error", "Aterm_mu", "Aterm_var", "KLD", "l2",
                "y_pred_hat")
        dev_metrics = {k: [] for k in keys}
        labels = []
        self.optimizer.zero_grad(set_to_none=True)
        batch_count = 0
        n = 0
        t0 = time.time()
        timer = profiling.StepTimer() if self.args.profile else None
        for tiles, mask, label in loader:
            with (timer.step() if timer is not None
                  else contextlib.nullcontext()):
                outs = self.grad_fn(self.model, tiles, mask, label,
                                    self.bag_generator(epoch, n))
                batch_count += 1
                if batch_count >= self.args.accum:
                    steps.apply_updates(self.optimizer, stage.lr)
                    batch_count = 0
                if timer is not None and self.device.type == "cuda":
                    # a step's time is the card's, not the enqueue's
                    torch.cuda.synchronize(self.device)
            for k in keys:
                dev_metrics[k].append(outs[k])
            labels.append(label)
            n += 1
        if batch_count:
            # a partial tail window steps too, rather than dropping its
            # gradients (the reference's un-zeroed .grad buffers carried
            # them into the next epoch; see PARITY.md)
            steps.apply_updates(self.optimizer, stage.lr)
        if timer is not None:
            epoch_stats["step_times"] = timer.summary()
        epoch_stats["input_stall_fraction"] = loader.stall_fraction()
        fetched = {k: torch.stack(v).float().cpu().numpy() if v
                   else np.zeros((0,)) for k, v in dev_metrics.items()}
        dt = time.time() - t0
        predictions = [int(p) for p in fetched["y_pred_hat"]]
        last_l2 = float(fetched["l2"][-1]) if len(fetched["l2"]) else 0.0
        return self._finish_epoch(epoch, epoch_stats, labels, predictions,
                                  {k: float(v.sum())
                                   for k, v in fetched.items()},
                                  last_l2, n, dt)

    def _train_epoch_mesh(self, epoch, stage, loader, epoch_stats):
        """The mesh path (the JAX trainer's ``_train_epoch_mesh``): each
        accumulation window of bags is ONE window step, the gradient of the
        window's summed losses and one Adam step, which is the sequential
        accumulate-then-step. Every rank iterates the same loader and hands
        the step the whole window; the step runs this rank's share."""
        accum = self.args.accum
        keys = ("loss", "error", "Aterm_mu", "Aterm_var", "KLD", "l2")
        sums = dict.fromkeys(keys, 0.0)
        predictions, labels, window = [], [], []
        n, last_l2 = 0, 0.0
        t0 = time.time()
        timer = profiling.StepTimer() if self.args.profile else None

        def run_window(bags):
            nonlocal n, last_l2
            real = len(bags)
            # a partial tail window pads with zero-weight copies: they add
            # neither gradients nor metrics
            weights = [1.0] * real + [0.0] * (accum - real)
            gens = [self.bag_generator(epoch, n + i) for i in range(real)]
            gens += [self.bag_generator(epoch, n)] * (accum - real)
            bags = bags + [bags[0]] * (accum - real)
            metrics = self.window_step(
                self.model, self.optimizer, [b[0] for b in bags],
                [b[1] for b in bags], [b[2] for b in bags], stage.lr,
                bag_weights=weights, generators=gens)
            for k in keys:  # window means: keep the window's sums
                sums[k] += float(metrics[k]) * real
            last_l2 = float(metrics["l2"])
            predictions.extend(int(p) for p in metrics["y_pred_hat"][:real])
            labels.extend(int(b[2]) for b in bags[:real])
            n += real

        for tiles, mask, label in loader:
            window.append((tiles, mask, label))
            if len(window) >= accum:
                with (timer.step() if timer is not None
                      else contextlib.nullcontext()):
                    run_window(window)
                    if timer is not None and self.device.type == "cuda":
                        torch.cuda.synchronize(self.device)
                window = []
        if window:
            run_window(window)
        if timer is not None:
            epoch_stats["step_times"] = timer.summary()
        epoch_stats["input_stall_fraction"] = loader.stall_fraction()
        return self._finish_epoch(epoch, epoch_stats, labels, predictions,
                                  sums, last_l2, n, time.time() - t0)

    def _finish_epoch(self, epoch, epoch_stats, labels, predictions, sums,
                      last_l2, n, dt):
        """The epoch's checkpoint (rank 0) and stats from its sums over
        bags; a non-finite loss halts instead."""
        loss_sum = sums["loss"]
        if not np.isfinite(loss_sum):
            return self._halt_non_finite(epoch, loss_sum)
        if self.writes:
            self.ckpt_writer.save(
                checkpoint.checkpoint_path(self.output_dir, epoch),
                self.model, self.optimizer)
        n = max(n, 1)
        epoch_stats["train_acc"] = helpers.classification_report(
            labels, predictions, labels=[0, 1, 2], target_names=TARGET_NAMES)
        epoch_stats["train_loss"] = loss_sum / n
        epoch_stats["train_wsum"] = sums["Aterm_mu"] / n
        epoch_stats["train_wvar"] = sums["Aterm_var"] / n
        epoch_stats["train_cll2"] = last_l2
        epoch_stats["train_kld"] = sums["KLD"] / n
        epoch_stats["train_err"] = sums["error"] / n
        epoch_stats["train_secs"] = dt
        # the legacy summary keys the root plot script reads
        # (plot_gbm_metrics.py:55-56): the epoch's total loss and the
        # legacy Attention temperature default (gbm/classify.py:366)
        epoch_stats["train_sum"] = loss_sum
        epoch_stats["model_temp"] = 0.0
        epoch_stats["model_mean_weights"] = \
            helpers.get_layer_weight_summary_mean(self.model)
        epoch_stats["model_max_weights"] = \
            helpers.get_layer_weight_summary_max(self.model)
        print(f"T{'' if self.mesh is None else '[mesh]'}: "
              f"Loss {epoch_stats['train_loss']:.3f}; "
              f"Error {100 * epoch_stats['train_err']:.2f}%; "
              f"{n} slides in {dt:.1f}s")
        return True

    def _stream_with_rank0(self, builders):
        """A mesh rank other than 0 in validation and ``--interface``: it
        takes its share of every slide that rank 0 streams (those above
        ``--stream_tiles``), in rank 0's order; rank 0 runs the other
        slides alone and writes every result."""
        for builder in builders:
            if builder.getsize() > self.stream_tiles:
                inference.classify_slide_streaming(
                    self.model, self.cfg, builder,
                    resolution=self.args.resolution,
                    compute_dtype=self.compute_dtype,
                    transform_extract=self.transform_extract, mesh=self.mesh)

    # --------------------------------------------------------- validate
    def validate(self, epoch: int, dataset, epoch_stats: dict):
        print(f"===> VALIDATION: Epoch = {epoch}")
        stage = schedule.stage_for_epoch(epoch, test=True)
        dataset.eval()
        dataset.NewResolution(self.args.resolution)
        if not self.writes:
            self._stream_with_rank0(dataset.test_slide_builders)
            return
        keys = ("loss", "error", "Aterm_mu", "KLD", "y_pred_hat")
        dev = {k: [] for k in keys}
        predvals, labels = [], []
        n = 0
        n_streamed = 0  # oversized bags that took the eval-mode streaming

        def produce():
            # normal bags load (cache IO, transform) on a prefetch thread
            # while the device runs the previous one; oversized bags are
            # marked and stream on the consumer side
            for idx, builder in enumerate(dataset.test_slide_builders):
                label = int(dataset.test_slide_record[idx])
                if builder.getsize() > self.stream_tiles:
                    yield "stream", builder, label
                else:
                    yield "bag", builder.get_validation_data(), label

        for kind, payload, label in prefetch_iter(produce(), depth=2):
            if kind == "stream":
                # exact eval-mode streaming (one chunk plus the [T, L]
                # features resident); the pre-Check train-mode noise is
                # skipped for these bags
                _, souts, _ = inference.classify_slide_streaming(
                    self.model, self.cfg, payload,
                    resolution=self.args.resolution,
                    compute_dtype=self.compute_dtype,
                    transform_extract=self.transform_extract,
                    mesh=self.mesh)
                outs = {k: torch.as_tensor(np.asarray(v)) for k, v in
                        inference.streaming_eval_outputs(
                            souts, label, self.cfg).items()}
                n_streamed += 1
            else:
                mask = torch.ones(payload.shape[0], dtype=torch.float32,
                                  device=payload.device)
                # pre-Check stages validate with the train-mode noise, like
                # the reference (SetStage(test=True) switches to eval only
                # from epoch 150; gbm/classify_combined.py:123-134)
                if stage.train_mode:
                    outs = self.fwd_train(
                        self.model, payload, mask, label,
                        self.bag_generator(epoch, n, validate=True))
                else:
                    outs = self.fwd_eval(self.model, payload, mask, label)
            for k in keys:
                dev[k].append(outs[k].reshape(()).cpu())
            predvals.append(outs["y_pred"].reshape(-1).float().cpu().numpy())
            labels.append(label)
            n += 1
        fetched = {k: torch.stack(v).float().numpy() if v else np.zeros((0,))
                   for k, v in dev.items()}
        predictions = [int(p) for p in fetched["y_pred_hat"]]
        n = max(n, 1)
        if predvals and self.writes and helpers.have_matplotlib():
            os.makedirs(self.heat_dir, exist_ok=True)
            plots.plot_prediction_summary(epoch, self.heat_dir, predvals,
                                          labels)
        # <epoch>predictions.json, plot_roc's input (reference:
        # gbm/plot_roc.py:12-38): score = P(class A), label = 1 iff A
        if predvals and self.writes:
            plots.save_predictions(
                self.output_dir, epoch, [float(p[0]) for p in predvals],
                [1.0 if int(lbl) == 0 else 0.0 for lbl in labels])
        epoch_stats["valid_acc"] = helpers.classification_report(
            labels, predictions, labels=[0, 1, 2], target_names=TARGET_NAMES)
        epoch_stats["valid_loss"] = float(fetched["loss"].sum()) / n
        epoch_stats["valid_err"] = float(fetched["error"].sum()) / n
        epoch_stats["valid_wsum"] = float(fetched["Aterm_mu"].sum()) / n
        epoch_stats["valid_kld"] = float(fetched["KLD"].sum()) / n
        # streamed bags always take the eval-mode forward; before Check a
        # nonzero count marks the epoch's validation as mixed-mode
        epoch_stats["valid_streamed_bags"] = n_streamed
        epoch_stats["valid_eval_mode"] = not stage.train_mode
        print(f"V: Loss {epoch_stats['valid_loss']:.3f}; "
              f"Error {100 * epoch_stats['valid_err']:.2f}%")

    # -------------------------------------------------------- visualize
    def visualize_data(self, sample) -> dict:
        """The heatmap panel's data for one slide: its whole bag through the
        eval forward (so through the pool kernel): ``wROIs`` [K, T],
        ``Mterm``, ``Fterm`` [T, L] as numpy, with the raster, the raw
        tiles and the name."""
        data, raster, img_data = sample.get_inference_data()
        tiles, mask = pad_bag(data)
        outs = self.fwd_eval(self.model, tiles, mask, 1)
        T = data.shape[0]
        return {"A": outs["wROIs"].float().cpu().numpy()[:, :T],
                "M": outs["Mterm"].float().cpu().numpy(),
                "F": outs["Fterm"].float().cpu().numpy()[:T],
                "raster": raster, "img_data": img_data,
                "roi_size": sample.params["roi_size"]}

    def visualize(self, epoch: int, sample, mode: str = "Train"):
        """Whole-slide inference -> the 2x3 attention heatmap panel
        (reference: gbm/classify_combined.py:142-218); returns its path."""
        from . import heatmap

        d = self.visualize_data(sample)
        os.makedirs(self.heat_dir, exist_ok=True)
        return heatmap.create_map(
            mode + "-" + sample.getname(), epoch, "Last", d["img_data"],
            d["raster"], d["A"], d["F"], d["M"], roi_size=d["roi_size"],
            output_dir=self.heat_dir)

    # ------------------------------------------------------------- peak
    def peak(self, dataset):
        """Weight and activation inspection (reference:
        gbm/classify_combined.py:537-544): the first conv's kernels, then
        one training bag's first 8 tiles through the ResNet's taps, their
        stats printed and their grids drawn."""
        from ..models import resnet

        helpers.plot_kernels(self.model, self.args.epoch_start, 0,
                             output_dir=self.output_dir)
        dataset.train()
        loader = sample_data(dataset, image_size=self.args.resolution,
                             shuffle=True)
        for tiles, mask, label in loader:
            tiles = tiles[:8]
            with torch.no_grad():
                _, acts = resnet.apply_resnet26(
                    self.model.cnn, tiles, compute_dtype=self.compute_dtype,
                    taps=True)
            summary = helpers.activation_summary(self.model.cnn, tiles,
                                                 acts=acts)
            for layer, stats in summary.items():
                print(f"{layer:10s} {stats}")
            grids = helpers.activation_grids(self.model.cnn, tiles,
                                             acts=acts)
            for layer, grid in grids.items():
                helpers.plot_activations(
                    grid, os.path.join(self.output_dir,
                                       f"activations-{layer}.png"))
            return summary
        return {}

    # -------------------------------------------------------- interface
    def interface(self, epoch: int, dataset):
        """caMicroscope batch-inference mode (reference:
        gbm/classify_combined.py:221-298): every slide of the cohort is
        classified, slides above ``--stream_tiles`` tiles through the
        streaming path and the rest as one bag each (loaded on a prefetch
        thread), one pool launch a slide. Writes, in the output directory,
        ``manifest_img.csv``, ``manifest_heat.csv``, ``move_images.sh``,
        the ``.dla`` maps of each slide, ``GBMresult_probs_class.csv``
        (probabilities and ``Aterm_var``) and ``GBMdata_slideEBs_class.csv``
        (label and flattened ``Mterm``), as the JAX package does, then
        prints the tile counts and the classification report."""
        print("===> INTERFACING TO CAMICROSCOPE")
        dataset.interface()
        dataset.NewResolution(self.args.resolution)
        if not self.writes:
            self._stream_with_rank0(dataset.all_builders)
            return
        out = self.output_dir

        def produce():
            # normal slides load (cache IO, transform) on a prefetch
            # thread; oversized slides are marked and stream on the
            # consumer side
            for idx in range(len(dataset)):
                builder = dataset.all_builders[idx]
                if builder.getsize() > self.stream_tiles:
                    yield "stream", builder, None, None
                else:
                    tiles, _, raster, _ = dataset[idx]
                    yield "bag", builder, tiles, raster

        with open(f"{out}/move_images.sh", "w+") as f_tomove, \
                open(f"{out}/manifest_img.csv", "w+") as f_img, \
                open(f"{out}/manifest_heat.csv", "w+") as f_heat:
            f_img.write("path,studyid,clinicaltrialsubjectid,imageid\n")
            f_heat.write("path,studyid,clinicaltrialsubjectid,imageid\n")
            predictions, labels = [], []
            ccls, slide_ebs, l_ntiles = {}, {}, []
            for kind, builder, tiles, raster in prefetch_iter(produce(),
                                                              depth=2):
                meta = builder.getmeta()
                label = int(np.asarray(meta["outcome_tensor"]).ravel()[0])
                if kind == "stream":
                    _, outs, raster = inference.classify_slide_streaming(
                        self.model, self.cfg, builder,
                        resolution=self.args.resolution,
                        compute_dtype=self.compute_dtype,
                        transform_extract=self.transform_extract,
                        mesh=self.mesh)
                    T = raster.shape[0]
                else:
                    T = tiles.shape[0]
                    outs = self.fwd_eval(
                        self.model, tiles,
                        torch.ones(T, dtype=torch.float32,
                                   device=tiles.device), label)
                    outs = {k: v.float().cpu().numpy()
                            for k, v in outs.items()}
                l_ntiles.append(meta["ntiles"])
                image_name = meta.get("caMIC_image_name", meta["basename"])
                id_name = meta.get("caMIC_id_name", meta["basename"])
                study = meta.get("caMIC_study", "gbm-classif-nn")
                f_img.write(f"{image_name},{study},{id_name},{id_name}\n")
                f_tomove.write(f"cp '{meta['fullpath']}' "
                               f"{out}/gbm_validation_set/\n")
                sample_key = meta.get("Sample Name", meta["basename"])
                probs = np.asarray(outs["y_pred"]).ravel()
                avar = float(outs["Aterm_var"])
                ccls[sample_key] = np.append(probs, avar)
                slide_ebs[sample_key] = np.append(
                    float(label), np.asarray(outs["Mterm"]).ravel())
                predictions.append(int(outs["y_pred_hat"]))
                labels.append(label)
                print(id_name, "| true:", meta.get("outcome_item", label),
                      "| probs:", probs, "| Avar:", avar)
                helpers.write_map(meta, epoch, np.asarray(raster),
                                  np.asarray(outs["Aterm"])[:, :T], f_heat,
                                  out)
        helpers.write_frame_csv(os.path.join(out, "GBMresult_probs_class.csv"),
                                ccls)
        helpers.write_frame_csv(
            os.path.join(out, "GBMdata_slideEBs_class.csv"), slide_ebs)
        print("NTILES = ", l_ntiles)
        print(helpers.classification_report_text(
            helpers.classification_report(labels, predictions,
                                          labels=[0, 1, 2],
                                          target_names=TARGET_NAMES),
            TARGET_NAMES))


def _refuse_not_ported(args):
    for flag, item in NOT_PORTED.items():
        if getattr(args, flag):
            raise SystemExit(
                f"classify: --{flag} is not ported to the PyTorch package "
                f"yet; ROADMAP {item} brings it")
    drawing = [f for f, on in (("--peak", args.peak),
                               ("--n_vis", args.n_vis > 0)) if on]
    if drawing and not helpers.have_matplotlib():
        raise SystemExit(
            f"classify: {' and '.join(drawing)} "
            f"{'draw' if len(drawing) > 1 else 'draws'} figures, which "
            "needs matplotlib; it is not installed here")


def main(argv=None, *, device=None):
    """The CLI. ``device`` is where the model trains and bags are built:
    the card unless ``"cpu"`` is asked for (there is no fallback). With
    ``--mesh N`` it spawns N ranks (``parallel/mesh.py``), one card each
    (N CPU ranks over gloo with ``device="cpu"``), and returns rank 0's
    exit code; asking for more cards than there are raises."""
    argv = sys.argv[1:] if argv is None else list(argv)
    args = build_argparser().parse_args(argv)
    _refuse_not_ported(args)
    if args.mesh:
        return M.launch(_mesh_rank, args.mesh, args=(argv,),
                        devices=M.mesh_devices(args.mesh, device))[0]
    return _run(args, resolve_device(device))


def _mesh_rank(mesh, argv):
    """One rank of ``--mesh N``: the CLI on the rank's device."""
    return _run(build_argparser().parse_args(argv), mesh.device, mesh=mesh)


def _run(args, device, mesh=None):
    print(args)
    if not helpers.have_matplotlib():
        print("note: matplotlib is not installed: the metric curves and the "
              "prediction summaries are not drawn; their data is in "
              "*summary.json and <epoch>predictions.json")
    if args.interface:
        output_dir = os.path.join(args.output_root, "interface_data")
    else:
        output_dir = os.path.join(args.output_root, f"run_{args.tag}")
    writes = mesh is None or mesh.rank == 0
    if writes:
        os.makedirs(output_dir, exist_ok=True)

    dataset = ds_mod.GHPSingleBagDatasetSimple(
        bag=True, output_dir=output_dir, root_dir=args.data_root,
        image_dir=args.image_dir, label_sheet=args.label_sheet,
        roi_size=args.roi_size, seed=args.seed,
        train_pad=args.train_pad, device=device)
    if args.split_ckpt:
        dataset.load_from_checkpoint(args.split_ckpt, save=writes)
    else:
        dataset.load_new(n_folds=6, n_fold_selection=args.fold,
                         save=writes)

    cfg = make_config(args, dataset.GetClassWeights())
    driver = Driver(args, cfg, output_dir, device=device, mesh=mesh)

    if args.ckpt == "auto":
        # elastic resume: pick up the newest checkpoint in the run dir
        args.ckpt = checkpoint.latest_checkpoint(output_dir)
        if args.ckpt:
            print(f"Auto-resume from {args.ckpt}")
    if args.ckpt is not None and not os.path.isfile(args.ckpt):
        print(f"error: checkpoint not found: {args.ckpt}", file=sys.stderr)
        return 2
    if args.ckpt is not None:
        _, loaded, skipped = checkpoint.restore_params(
            driver.model, args.ckpt, transfer=args.transfer)
        mode = "ResNet-conv transfer" if args.transfer else "full"
        print(f"Loaded {mode} checkpoint: {len(loaded)} tensors "
              f"({len(skipped)} skipped)")
        if not args.transfer:
            checkpoint.restore_opt_state(driver.optimizer, driver.model,
                                         args.ckpt)
    driver.replicate()

    if args.int8:
        if not (args.interface or args.test_only):
            print("error: --int8 is a serving path; use it with "
                  "--interface or --test_only", file=sys.stderr)
            return 2
        if (args.test_only
                and schedule.stage_for_epoch(args.epoch_start,
                                             test=True).train_mode):
            # pre-Check stages validate normal bags with the train-mode
            # noise (reference parity); that path keeps the float
            # extractor, so only streamed oversized bags would quantize
            print("note: --test_only at a pre-Check epoch uses the "
                  "train-mode forward for normal bags; --int8 applies "
                  "only to the eval/streaming paths")
        driver.enable_int8(list(dataset.test_slide_builders)
                           or list(dataset.all_builders))

    if args.peak:
        if writes:
            driver.peak(dataset)
        return 0

    if args.epoch_start == 0 and writes:
        with open(os.path.join(output_dir, "model_structure.txt"), "w+") as f:
            f.write(helpers.model_summary(driver.model))

    # visualization samples: the reference hardcodes 8 demo slides
    # (gbm/classify_combined.py:501-516); here the first 4 test and the
    # first 4 training slides, cut to --n_vis
    vis_samples = ([(b, "Test") for b in dataset.test_slide_builders[:4]]
                   + [(b, "Train") for b in dataset.train_slide_builders[:4]]
                   )[:args.n_vis] if writes else []
    for b, _ in vis_samples:  # arm the transforms (reference :509-516)
        b.update_resolution_and_buffer(args.resolution)

    if args.interface:
        for b, m in vis_samples:
            driver.visualize(0, b, mode=m)
        driver.interface(0, dataset)
        return 0

    if args.test_only:
        epoch_stats = {}
        driver.validate(args.epoch_start, dataset, epoch_stats)
        if writes:
            helpers.savestats(args, output_dir, args.epoch_start,
                              epoch_stats)
        return 0

    tb_writer = None
    if args.tensorboard and writes:
        from ..utils.tb import EpochWriter

        tb_writer = EpochWriter(os.path.join(args.output_root, "runs",
                                             f"TAG_{args.tag}"))
    if vis_samples:
        driver.visualize(0, vis_samples[0][0], mode=vis_samples[0][1])
    latch = PreemptionLatch().install()
    try:
        for ep in range(args.epoch_start, args.epoch_end + 1):
            epoch_stats = {}
            # --profile traces the first trained epoch only: a trace grows
            # with wall time, and one epoch answers where the steps go
            trace_ctx = (profiling.trace(os.path.join(output_dir, "profile"),
                                         device=device)
                         if args.profile and ep == args.epoch_start and writes
                         else contextlib.nullcontext())
            with trace_ctx:
                keep_going = driver.train_epoch(ep, dataset, epoch_stats)
            if not keep_going:
                break  # Stop stage, or a halt on a non-finite loss
            if ep % 5 == 0:
                driver.validate(ep, dataset, epoch_stats)
                if writes:
                    helpers.savestats(args, output_dir, ep, epoch_stats)
                    if helpers.have_matplotlib():
                        plots.plot_gbm_metrics(output_dir, args.tag)
            if ep % 10 == 0:
                for b, m in vis_samples:
                    driver.visualize(ep, b, mode=m)
            if tb_writer is not None:
                tb_writer.log_epoch(ep, epoch_stats)
            stop = latch.stop_requested()
            if mesh is not None:  # rank 0's signal decides for every rank
                stop = M.broadcast_object(stop, mesh)
            if stop:
                # epoch ep's checkpoint is submitted; the wait() below
                # makes it durable before the clean exit
                print(f"train: preempted, stopped after epoch {ep}; "
                      f"resume with --ckpt auto --epoch_start {ep + 1}")
                break
    finally:
        latch.restore()
    if tb_writer is not None:
        tb_writer.close()
    driver.ckpt_writer.wait()  # the last epoch's checkpoint must be durable
    # a run halted on divergence must be told apart from success (the Stop
    # stage's break is a clean finish)
    return DIVERGED_EXIT if driver.diverged else 0


if __name__ == "__main__":
    sys.exit(main())
