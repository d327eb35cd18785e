"""Legacy GAN-discriminator classifier driver.

Counterpart of ``train/classify_legacy.py`` in the JAX package, the
runnable form of the reference's stale ``gbm/classify.py`` (flags :37-65,
``disc_cutoff = 6`` at :33, ``classifier(x, y, step_input=disc_cutoff)``
at :116, the ``.dla`` export at :207-225): the attention-MIL head trained
on features of a pretrained StyleGAN critic cut at ``--disc_cutoff``
blocks (``models/disc_extractor.py``, frozen), with per-group learning
rates (``LR_MULTS``, gbm/classify.py:368-373) on Adam (0.9, 0.99),
gradients of ``w1 * loss + w2 * KLD`` summed over ``--accum`` bags (:300-
331; a partial tail window steps too), a ``train_step-NNN.model``
checkpoint with the Adam state every epoch (:349-355), classification
reports, and in ``--test_only`` the caMicroscope manifests and ``.dla``
attention maps (:163-225). Every bag runs the gated pool's kernels on the
card, forward and (training) backward.

As in the JAX package the extractor is frozen, so the ``cnn`` group's 20x
rate is inert and the KLD term carries no gradient; each bag's noise (the
subsample's Gumbel scores, the dropout mask) is a pure function of (seed,
epoch, bag), so a resume replays an epoch. The layer-summary plot every 5
optimizer steps needs matplotlib; where it is missing the driver says so
once and skips it.

Run ``python -m deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.train.classify_legacy --help``.
"""

import argparse
import math
import os
import sys
from datetime import datetime

import numpy as np
import torch

from .._device import resolve_device
from ..data.dataset import GHPSingleBagDatasetSimple
from ..data.loader import epoch_loader_seed, sample_data
from ..models import attention_mil as amil
from ..models import blocks, disc_extractor
from ..models import stylegan as sg
from ..parallel import steps
from ..utils import helpers
from . import DIVERGED_EXIT, Diverged, PreemptionLatch, checkpoint, gan

# per-group LR multipliers (reference: gbm/classify.py:368-373); "cnn" is
# inert here because the discriminator extractor is frozen
LR_MULTS = {"cnn": 20.0, "attention": 2.0}
TARGET_NAMES = ["A", "B", "C"]


def build_argparser():
    p = argparse.ArgumentParser(
        description="Attention classifier for WSI images using partial "
                    "GAN-trained discriminator reduction (legacy driver)")
    # the reference's own flags (gbm/classify.py:37-65)
    p.add_argument("--lr", default=0.001, type=float)
    p.add_argument("--ckpt", default=None, type=str,
                   help="load classifier head from a previous checkpoint")
    p.add_argument("--epoch_start", default=0, type=int)
    p.add_argument("--epoch_end", default=40, type=int)
    p.add_argument("--no_from_rgb_activate", action="store_true")
    p.add_argument("--transfer", action="store_true",
                   help="re-initialize every linear layer of the head")
    p.add_argument("--test_only", action="store_true")
    # configuration the reference hardcoded
    p.add_argument("--gan_ckpt", default=None, type=str,
                   help="5-part GAN checkpoint; its discriminator becomes "
                        "the frozen feature extractor (random init if unset)")
    p.add_argument("--disc_cutoff", default=disc_extractor.DISC_CUTOFF,
                   type=int)
    p.add_argument("--width_mult", default=1.0, type=float,
                   help="discriminator width multiplier (match the GAN run)")
    p.add_argument("--resolution", default=128, type=int,
                   help="tile resolution; sets the discriminator entry step")
    p.add_argument("--accum", default=4, type=int)
    p.add_argument("--w1", default=1.0, type=float)
    p.add_argument("--w2", default=2.0, type=float)
    p.add_argument("--data_root", default="/raid/GHP Immunohistochemistry/")
    p.add_argument("--image_dir", default="All_HE_scans_GBM_AN")
    p.add_argument("--label_sheet", default=None)
    p.add_argument("--split_ckpt", default=None)
    p.add_argument("--output_root", default=".")
    p.add_argument("--roi_size", default=None, type=int)
    p.add_argument("--seed", default=0, type=int)
    p.add_argument("--f32", action="store_true")
    p.add_argument("--tensorboard", action="store_true")
    return p


def load_discriminator(args, device):
    """The critic of ``--gan_ckpt`` (its ``discriminator/`` section), or a
    randomly initialised one, on ``device``, frozen."""
    disc = sg.init_discriminator(
        torch.Generator().manual_seed(args.seed), width_mult=args.width_mult,
        from_rgb_activate=not args.no_from_rgb_activate, device=device)
    if args.gan_ckpt:
        loaded, total = gan.restore_section(
            disc, checkpoint.load_raw(args.gan_ckpt), "discriminator")
        print(f"Loaded discriminator from {args.gan_ckpt}: "
              f"{loaded}/{total} tensors")
        if loaded < total:
            print(f"WARNING: {total - loaded} discriminator tensors missing "
                  "or shape-mismatched (check --width_mult matches the GAN "
                  "run); those layers keep RANDOM init weights")
    else:
        print("WARNING: no --gan_ckpt; extractor uses random discriminator "
              "weights (smoke/e2e use only)")
    return disc.eval().requires_grad_(False)


def _report(labels, predictions):
    print(helpers.classification_report_text(
        helpers.classification_report(labels, predictions, labels=[0, 1, 2],
                                      target_names=TARGET_NAMES),
        TARGET_NAMES))


class LegacyDriver:
    """The head, its optimizer and the bag functions over the frozen
    extractor, on ``device``."""

    def __init__(self, args, cfg, extractor, output_dir, device):
        self.args = args
        self.cfg = cfg
        self.extractor = extractor
        self.output_dir = output_dir
        self.device = device
        self.compute_dtype = None if args.f32 else torch.bfloat16
        self.model = amil.init_attention_mil(
            torch.Generator().manual_seed(args.seed + 1), cfg,
            device=device).train()
        self.optimizer = steps.make_optimizer_legacy(self.model, LR_MULTS)
        self.global_steps = 0

    def bag_noise(self, epoch: int, n: int, tiles: int) -> dict:
        """The noise of bag ``n`` (of ``tiles`` tiles) in epoch ``epoch``,
        as ``apply_attention_mil`` keywords: a generator seeded from
        (seed, epoch, n), which draws the subsample's scores, then the
        dropout mask."""
        seed = int(np.random.SeedSequence([self.args.seed, epoch, n])
                   .generate_state(1)[0])
        return {"generator": torch.Generator().manual_seed(seed)}

    def grad(self, tiles, mask, label, noise):
        """One bag's backward of ``w1 * loss + w2 * KLD`` (the reference's
        TOTAL_LOSS, gbm/classify.py:300,325), added into ``.grad``."""
        outs = amil.apply_attention_mil(
            self.model, tiles, label, self.cfg, mask=mask, train=True,
            compute_dtype=self.compute_dtype, extractor=self.extractor,
            **noise)
        (self.args.w1 * outs["loss"] + self.args.w2 * outs["KLD"]).backward()
        return {k: v.detach() for k, v in outs.items()}

    def evaluate(self, tiles, mask, label):
        return amil.apply_attention_mil(
            self.model, tiles, label, self.cfg, mask=mask, train=False,
            compute_dtype=self.compute_dtype, extractor=self.extractor)

    def step(self):
        steps.apply_updates(self.optimizer, self.args.lr)
        self.global_steps += 1

    def train_epoch(self, epoch, dataset, writer):
        args = self.args
        print(f"===> TRAIN: Epoch, w1, w2 = {epoch} {args.w1} {args.w2}")
        dataset.train()
        dataset.reseed_augment(args.seed, epoch)
        loader = sample_data(dataset, image_size=args.resolution,
                             shuffle=True,
                             seed=epoch_loader_seed(args.seed, epoch))
        self.optimizer.zero_grad(set_to_none=True)
        count, preds, labels, losses = 0, [], [], []
        for tiles, mask, label in loader:
            outs = self.grad(tiles, mask, label,
                             self.bag_noise(epoch, len(labels),
                                            tiles.shape[0]))
            preds.append(int(outs["y_pred_hat"]))
            labels.append(int(label))
            losses.append(outs["loss"].float())
            count += 1
            if count >= args.accum:
                self.step()
                count = 0
                if self.global_steps % 5 == 0 and helpers.have_matplotlib():
                    helpers.plot_layer_summary(
                        self.model, os.path.join(
                            self.output_dir,
                            f"layer_summary-{self.global_steps:05d}.png"))
        if count:
            # a partial tail window steps too (the main driver's policy)
            self.step()
        loss = (float(torch.stack(losses).mean()) if losses
                else float("nan"))
        err = (float(np.mean(np.asarray(preds) != np.asarray(labels)))
               if labels else float("nan"))
        print(f"Epoch {epoch}: train loss {loss:.4f}, error {100 * err:.2f}%")
        if writer is not None:
            writer.log_epoch(epoch, {"train_loss": loss, "train_error": err})
        _report(labels, preds)
        if losses and not math.isfinite(loss):
            # halt WITHOUT checkpointing the diverged epoch, so the newest
            # checkpoint stays a healthy resume point
            raise Diverged(
                f"non-finite training loss ({loss}) at epoch {epoch}; "
                "halted without checkpointing; resume from the previous "
                "epoch's checkpoint")
        checkpoint.save(
            os.path.join(self.output_dir, f"train_step-{epoch:03d}.model"),
            self.model, self.optimizer, extra={"epoch": np.int64(epoch)})

    def validate(self, epoch, dataset, writer):
        print(f"===> VALIDATION: Epoch = {epoch}")
        dataset.eval()
        loader = sample_data(dataset, image_size=self.args.resolution,
                             shuffle=False)
        preds, labels = [], []
        for tiles, mask, label in loader:
            outs = self.evaluate(tiles, mask, label)
            preds.append(int(outs["y_pred_hat"]))
            labels.append(int(label))
        _report(labels, preds)
        if writer is not None and labels:
            acc = float(np.mean(np.asarray(preds) == np.asarray(labels)))
            writer.log_epoch(epoch, {"valid_acc": acc})

    def test(self, epoch, dataset):
        """The caMicroscope export (reference: gbm/classify.py:147-205):
        manifests, the image move script and each slide's ``.dla`` maps."""
        print(f"===> TEST: Epoch = {epoch}")
        dataset.interface()
        loader = sample_data(dataset, image_size=self.args.resolution,
                             shuffle=False)
        out = self.output_dir
        preds, labels = [], []
        with open(os.path.join(out, "move_images.sh"), "w") as f_mv, \
                open(os.path.join(out, "manifest_image.csv"), "w") as f_img, \
                open(os.path.join(out, "manifest_heat.csv"), "w") as f_heat:
            f_img.write("path,studyid,clinicaltrialsubjectid,imageid\n")
            f_heat.write("path,studyid,clinicaltrialsubjectid,imageid\n")
            # every slide is classified and written, openslide-eligible or
            # not, as in the main driver's interface mode
            for tiles, mask, label, coords, meta in loader:
                outs = self.evaluate(tiles, mask, label)
                T = coords.shape[0]
                f_img.write("{0},{1},{2},{2}\n".format(
                    meta.get("camic_id", meta["basename"]),
                    meta.get("studyid", "gmb-id-nn"), meta["basename"]))
                f_mv.write(f"cp '{meta.get('fullpath', meta['basename'])}' "
                           "./images/gbm_validation_set/\n")
                helpers.write_map(meta, epoch, np.asarray(coords),
                                  outs["Aterm"].float().cpu().numpy()[:, :T],
                                  f_heat, out)
                preds.append(int(outs["y_pred_hat"]))
                labels.append(int(label))
        _report(labels, preds)


def main(argv=None, *, device=None):
    """The CLI; ``device`` is the card unless ``"cpu"`` is asked for."""
    args = build_argparser().parse_args(argv)
    device = resolve_device(device)
    print(args)
    stamp = datetime.now().strftime("%d-%b-%Y-%H-%M-%S")
    sub = ("test_data" if args.test_only
           else f"run_attention_classifier_glioblastoma_{stamp}")
    output_dir = os.path.join(args.output_root, sub)
    os.makedirs(output_dir, exist_ok=True)
    if not args.test_only and not helpers.have_matplotlib():
        print("note: matplotlib is not installed: the layer-summary plots "
              "are not drawn")

    disc = load_discriminator(args, device)
    step = int(math.log2(args.resolution)) - 2
    L = disc_extractor.feature_dim(step, cutoff=args.disc_cutoff,
                                   width_mult=args.width_mult)
    extractor = disc_extractor.make_extractor(disc, step=step,
                                              cutoff=args.disc_cutoff)
    dataset = GHPSingleBagDatasetSimple(
        bag=True, output_dir=output_dir, root_dir=args.data_root,
        image_dir=args.image_dir, label_sheet=args.label_sheet,
        roi_size=args.roi_size, seed=args.seed, device=device)
    if args.split_ckpt:
        dataset.load_from_checkpoint(args.split_ckpt)
    else:
        dataset.load_new()

    cfg = amil.MILConfig(L=L, class_weights=None)
    driver = LegacyDriver(args, cfg, extractor, output_dir, device)
    if args.ckpt:
        print("Loading checkpoint!!!")
        checkpoint.restore_params(driver.model, args.ckpt)
    if args.transfer:
        print("Randomizing Linear Layers!!!")
        blocks.reset_linear(driver.model,
                            torch.Generator().manual_seed(args.seed + 2))
    if args.ckpt and not args.transfer:
        checkpoint.restore_opt_state(driver.optimizer, driver.model,
                                     args.ckpt)

    writer = None
    if args.tensorboard:
        from ..utils import tb

        writer = tb.EpochWriter(os.path.join(args.output_root, "runs",
                                             f"legacy_{stamp}"))
    if args.test_only:
        driver.test(args.epoch_start - 1, dataset)
        return 0
    latch = PreemptionLatch().install()
    try:
        for epoch in range(args.epoch_start, args.epoch_end):
            driver.train_epoch(epoch, dataset, writer)
            driver.validate(epoch, dataset, writer)
            if latch.stop_requested():
                # train_epoch saved this epoch's checkpoint
                print(f"train: preempted, stopped after epoch {epoch}")
                break
    except Diverged as e:
        print(f"FATAL: {e}", file=sys.stderr)
        return DIVERGED_EXIT
    finally:
        latch.restore()
        if writer is not None:
            writer.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
