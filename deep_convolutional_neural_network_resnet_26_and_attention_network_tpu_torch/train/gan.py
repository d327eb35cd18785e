"""Progressive-growing WGAN-GP StyleGAN trainer.

Counterpart of ``train/gan.py`` in the JAX package, after the reference
trainer (reference: style-based-gan-pytorch-master-512/train.py:1-323):
resolution step = epoch // step_every, alpha fade-in by samples seen over
the phase, the per-resolution batch schedule, the WGAN-GP critic loss with
the 0.001 * real^2 drift term and the 10x gradient penalty (a double
backward through the critic), the n_critic generator cadence, the
generator EMA (``g_running``), the style MLP at lr x 0.01, Adam (0.0,
0.99), and 5-part checkpoints {generator, discriminator, g_optimizer,
d_optimizer, g_running} in the JAX package's npz layout (either package
resumes the other's).

The losses take their random draws as arguments (:func:`draw_d`,
:func:`draw_g`: the noise planes, the interpolation ``eps`` and the
critic's dropout masks), so a test can hand both packages the same draws.
The trainer draws them from a ``torch.Generator`` on the training device,
seeded per (seed, epoch), with the batch order and the style-mixing coin
flips also pure functions of (seed, epoch): a run resumed from epoch
E-1's checkpoint replays epoch E. On the card it asks cuDNN for
deterministic algorithms for that reason.

``--grad_accum N`` sums the gradients of N microbatches (one backward
each) and averages them, as the JAX package's scan does; the minibatch
stddev sees the microbatch. ``--mesh N`` trains over N ranks
(``parallel/mesh.data_mesh``): every rank loads the whole batch and
draws the whole batch's noise, keeps its rows, and the minibatch stddev,
the batch means and the gradients are sums over the ranks, so the step is
the single-card step up to the order of the sums. ``--compute_dtype
bf16`` runs the G/D forward and backward under ``torch.autocast``
(convolutions and matmuls in bf16); the master weights, Adam, the loss
terms and the gradient-penalty norm stay float32.

Run ``python -m deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.train.gan --help``.
"""

import argparse
import contextlib
import copy
import json
import math
import os
import random as py_random
import struct
import sys
import time
import zlib

import numpy as np
import torch
import torch.nn.functional as F

from .._device import resolve_device
from ..data.gan_dataset import ImageFolderDataset, MultiResolutionStore
from ..data.loader import prefetch_iter
from ..models import stylegan as sg
from ..ops.collectives import all_reduce_
from ..parallel import mesh as M
from ..utils import interop
from . import DIVERGED_EXIT, Diverged, PreemptionLatch, checkpoint

STEP_BATCH_SIZE = {4: 256, 8: 256, 16: 256, 32: 256, 64: 256, 128: 128,
                   256: 128, 512: 100}  # reference: train.py:61
ADAM_BETAS = (0.0, 0.99)
ADAM_EPS = 1e-8
STYLE_LR_MULT = 0.01


def make_optimizers(gen, disc):
    """Adam(0.0, 0.99) for the generator (its style MLP in a second group
    at lr x 0.01, reference: train.py:279-291) and for the critic. The
    learning rate is set by each step (:func:`_adam_step`)."""
    g_opt = torch.optim.Adam(
        [{"params": list(gen.generator.parameters()), "lr_mult": 1.0},
         {"params": list(gen.style.parameters()),
          "lr_mult": STYLE_LR_MULT}],
        lr=0.0, betas=ADAM_BETAS, eps=ADAM_EPS)
    d_opt = torch.optim.Adam(disc.parameters(), lr=0.0, betas=ADAM_BETAS,
                             eps=ADAM_EPS)
    return g_opt, d_opt


def _adam_step(optimizer, lr: float):
    """One Adam step at ``lr`` (times each group's ``lr_mult``); a
    parameter without a gradient steps with a zero one, as optax updates
    every leaf."""
    for group in optimizer.param_groups:
        group["lr"] = float(lr) * group.get("lr_mult", 1.0)
        for p in group["params"]:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
    optimizer.step()
    optimizer.zero_grad(set_to_none=True)


def adam_count(optimizer) -> int:
    steps = [int(st["step"]) for st in optimizer.state.values()
             if "step" in st]
    return max(steps) if steps else 0


@torch.no_grad()
def accumulate(ema, gen, decay: float = 0.999):
    """g_running EMA: e = decay * e + (1 - decay) * p
    (reference: train.py:27-32)."""
    e = [p for p in ema.parameters()]
    g = [p.detach() for p in gen.parameters()]
    torch._foreach_mul_(e, decay)
    torch._foreach_add_(e, torch._foreach_mul(g, 1.0 - decay))


def ema_decay_at(count: int, ema_decay: float, warmup: bool) -> float:
    """The EMA decay after ``count`` generator steps: ``ema_decay``, or
    with ``warmup`` min(ema_decay, (1+t)/(10+t)) in float32 (the JAX
    package's tf-EMA ``num_updates`` schedule)."""
    if not warmup:
        return ema_decay
    t = np.float32(count)
    eff = min(np.float32(ema_decay),
              (np.float32(1.0) + t) / (np.float32(10.0) + t))
    return float(np.float32(eff))


# ------------------------------------------------------------------ draws
def draw_d(generator, disc, batch: int, step: int, device=None) -> dict:
    """The critic step's draws for a batch: the generator's noise planes,
    the interpolation ``eps`` [B, 1, 1, 1] and the dropout masks of the
    three critic passes (real, fake, gradient penalty)."""
    return {"keep_real": sg.draw_dropout(generator, disc, batch, step,
                                         device),
            "noise": sg.make_noise(generator, batch, step, device),
            "eps": torch.rand((batch, 1, 1, 1), generator=generator,
                              device=device or generator.device),
            "keep_fake": sg.draw_dropout(generator, disc, batch, step,
                                         device),
            "keep_gp": sg.draw_dropout(generator, disc, batch, step, device)}


def draw_g(generator, disc, batch: int, step: int, device=None) -> dict:
    """The generator step's draws: noise planes and one critic pass's
    dropout masks."""
    return {"noise": sg.make_noise(generator, batch, step, device),
            "keep": sg.draw_dropout(generator, disc, batch, step, device)}


def _rows(tree, sl):
    """Every tensor of a draws tree cut to the batch rows ``sl``."""
    if isinstance(tree, torch.Tensor):
        return tree[sl]
    if isinstance(tree, dict):
        return {k: _rows(v, sl) for k, v in tree.items()}
    return [_rows(v, sl) for v in tree]


def _microbatches(batch: int, grad_accum: int, mesh):
    """The row slices of each microbatch on this rank: microbatch k is
    rows [k*mb, (k+1)*mb) of the batch, and on a mesh this rank's share of
    them."""
    if batch % grad_accum:
        raise ValueError(f"batch {batch} not divisible by grad_accum "
                         f"{grad_accum}")
    mb = batch // grad_accum
    out = []
    for k in range(grad_accum):
        lo = k * mb
        if mesh is not None:
            r = mesh.rows(mb)
            out.append(slice(lo + r.start, lo + r.stop))
        else:
            out.append(slice(lo, lo + mb))
    return out, mb


def _autocast(device, compute_dtype):
    if compute_dtype is None:
        return contextlib.nullcontext()
    return torch.autocast(device_type=torch.device(device).type,
                          dtype=compute_dtype)


# ----------------------------------------------------------------- losses
def d_loss(gen, disc, real, zs, sel, alpha, draws, *, step,
           compute_dtype=None, remat=False, group=None, batch_total=None,
           sink=None):
    """The WGAN-GP critic loss on a (micro)batch (reference:
    train.py:99-132): -(E[D(real)] - 0.001 E[D(real)^2]) + E[D(fake)] +
    10 E[(||grad_x D(x_hat)|| - 1)^2], x_hat = eps real + (1 - eps) fake.

    ``real`` [b, 3, s, s], ``zs`` [S, b, code] and ``draws``
    (:func:`draw_d`) are this call's rows; with ``group`` the batch of
    ``batch_total`` rows is split over the group's ranks and each mean is
    this rank's sum over ``batch_total`` (the gradients then sum over the
    ranks). Each of the three terms goes to ``sink(term)`` as soon as it
    is built, so a caller can run its backward and free its graph before
    the next critic pass; returns ``(loss, aux)`` detached, aux
    ``disc_loss`` and ``grad_penalty`` (this rank's parts)."""
    n = real.shape[0] if batch_total is None else batch_total
    sink = sink or (lambda t: None)

    def critic(x, keep):
        with _autocast(x.device, compute_dtype):
            return sg.apply_discriminator(disc, x, step=step, alpha=alpha,
                                          keep=keep, remat=remat,
                                          group=group).float()

    real_predict = critic(real, draws["keep_real"])
    real_term = real_predict.sum() / n - 0.001 * (real_predict ** 2).sum() / n
    sink(-real_term)
    with torch.no_grad(), _autocast(real.device, compute_dtype):
        fake = sg.apply_styled_generator(gen, zs, draws["noise"], step=step,
                                         alpha=alpha, style_sel=sel).float()
    fake_term = critic(fake, draws["keep_fake"]).sum() / n
    sink(fake_term)

    # gradient penalty on the real/fake interpolate (reference:
    # train.py:121-132), differentiated through the critic's gradient
    eps = draws["eps"].to(real.dtype)
    x_hat = (eps * real + (1 - eps) * fake).detach().requires_grad_(True)
    d_sum = critic(x_hat, draws["keep_gp"]).sum()
    grad_x_hat, = torch.autograd.grad(d_sum, x_hat, create_graph=True)
    norms = torch.sqrt((grad_x_hat.float().reshape(x_hat.shape[0], -1)
                        ** 2).sum(dim=1))
    grad_penalty = 10.0 * ((norms - 1.0) ** 2).sum() / n
    sink(grad_penalty)
    rt, ft, gp = (t.detach() for t in (real_term, fake_term, grad_penalty))
    return -rt + ft + gp, {"disc_loss": rt - ft, "grad_penalty": gp}


def g_loss(gen, disc, zs, sel, alpha, draws, *, step, loss_kind="wgan-gp",
           compute_dtype=None, remat=False, group=None, batch_total=None):
    """The generator loss: -E[D(G(z))], or softplus(-D(G(z))) under
    ``loss_kind="r1"`` (reference: train.py:150-153). The batch mean is as
    in :func:`d_loss`. Returns the loss with its graph."""
    n = zs.shape[1] if batch_total is None else batch_total
    with _autocast(zs.device, compute_dtype):
        fake = sg.apply_styled_generator(gen, zs, draws["noise"], step=step,
                                         alpha=alpha, style_sel=sel,
                                         remat=remat)
        predict = sg.apply_discriminator(disc, fake, step=step, alpha=alpha,
                                         keep=draws["keep"], remat=remat,
                                         group=group).float()
    if loss_kind == "r1":
        return F.softplus(-predict).sum() / n
    return (-predict).sum() / n


def _sync_grads(params, mesh):
    """Sum every gradient over the mesh's ranks in one all-reduce."""
    grads = []
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
        grads.append(p.grad)
    flat = torch.cat([g.reshape(-1) for g in grads])
    all_reduce_(flat, mesh.group)
    start = 0
    for g in grads:
        g.copy_(flat[start:start + g.numel()].view_as(g))
        start += g.numel()


def _scale_grads(params, factor: float):
    for p in params:
        if p.grad is not None:
            p.grad.mul_(factor)


def make_d_step(step: int, *, loss_kind: str = "wgan-gp", compute_dtype=None,
                remat: bool = False, grad_accum: int = 1, mesh=None):
    """``d_step(gen, disc, d_opt, real, zs, sel, alpha, lr, draws) ->
    aux`` (``disc_loss``, ``grad_penalty``, device scalars): one Adam step
    of the critic on the WGAN-GP loss. ``real`` [B, 3, s, s], ``zs``
    [S, B, code] and ``draws`` are the whole batch's on every rank.

    ``loss_kind`` switches only the generator's objective: the reference
    trains the critic with the WGAN-GP loss under ``--loss r1`` too
    (train.py:99-132), and so does this port. ``grad_accum`` sums the
    gradients of that many microbatches and averages them (exact for every
    batch-mean term; the minibatch stddev sees the microbatch, as each of
    the reference's GPUs saw its share)."""
    if grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")
    group = None if mesh is None else mesh.group

    def d_step(gen, disc, d_opt, real, zs, sel, alpha, lr, draws):
        params = list(disc.parameters())
        slices, mb = _microbatches(real.shape[0], grad_accum, mesh)
        aux_sum = None
        for sl in slices:
            _, aux = d_loss(gen, disc, real[sl], zs[:, sl], sel, alpha,
                            _rows(draws, sl), step=step,
                            compute_dtype=compute_dtype, remat=remat,
                            group=group, batch_total=mb,
                            sink=lambda t: t.backward())
            aux = torch.stack([aux["disc_loss"], aux["grad_penalty"]])
            aux_sum = aux if aux_sum is None else aux_sum + aux
        if mesh is not None:
            _sync_grads(params, mesh)
            all_reduce_(aux_sum, group)
        if grad_accum > 1:
            _scale_grads(params, 1.0 / grad_accum)
            aux_sum = aux_sum * (1.0 / grad_accum)
        _adam_step(d_opt, lr)
        return {"disc_loss": aux_sum[0], "grad_penalty": aux_sum[1]}

    return d_step


def make_g_step(step: int, *, loss_kind: str = "wgan-gp", compute_dtype=None,
                remat: bool = False, grad_accum: int = 1,
                ema_decay: float = 0.999, ema_warmup: bool = False,
                mesh=None):
    """``g_step(gen, disc, g_opt, ema, zs, sel, alpha, lr, draws) ->
    loss`` (a device scalar): one Adam step of the generator (the critic
    frozen) and the ``g_running`` EMA update.

    ``ema_decay``: the EMA's decay (the reference hardcodes 0.999, which
    keeps 0.999^t of the initial random generator after t steps; short
    runs want e.g. 0.99). ``ema_warmup``: the decay min(ema_decay,
    (1+t)/(10+t)) over the optimizer step count t, which rides the
    restored Adam count on resume."""
    if grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")
    if not 0.0 <= ema_decay < 1.0:
        raise ValueError(f"ema_decay must be in [0, 1), got {ema_decay}")
    group = None if mesh is None else mesh.group

    def g_step(gen, disc, g_opt, ema, zs, sel, alpha, lr, draws):
        params = list(gen.parameters())
        slices, mb = _microbatches(zs.shape[1], grad_accum, mesh)
        loss_sum = None
        disc.requires_grad_(False)
        try:
            for sl in slices:
                loss = g_loss(gen, disc, zs[:, sl], sel, alpha,
                              _rows(draws, sl), step=step,
                              loss_kind=loss_kind,
                              compute_dtype=compute_dtype, remat=remat,
                              group=group, batch_total=mb)
                loss.backward()
                loss = loss.detach()
                loss_sum = loss if loss_sum is None else loss_sum + loss
        finally:
            disc.requires_grad_(True)
        if mesh is not None:
            _sync_grads(params, mesh)
            loss_sum = loss_sum.reshape(1)
            all_reduce_(loss_sum, group)
            loss_sum = loss_sum.reshape(())
        if grad_accum > 1:
            _scale_grads(params, 1.0 / grad_accum)
            loss_sum = loss_sum * (1.0 / grad_accum)
        _adam_step(g_opt, lr)
        accumulate(ema, gen, ema_decay_at(adam_count(g_opt), ema_decay,
                                          ema_warmup))
        return loss_sum

    return g_step


# ------------------------------------------------------------ checkpoints
def _png_chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def write_png(path: str, rgb: np.ndarray):
    """Write an [H, W, 3] uint8 array as an 8-bit RGB PNG (no filter,
    zlib level 6), with nothing but ``zlib`` and ``struct``."""
    rgb = np.ascontiguousarray(rgb, np.uint8)
    h, w, _ = rgb.shape
    raw = np.concatenate([np.zeros((h, 1), np.uint8),
                          rgb.reshape(h, w * 3)], axis=1).tobytes()
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + _png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0,
                                                   0, 0))
                + _png_chunk(b"IDAT", zlib.compress(raw, 6))
                + _png_chunk(b"IEND", b""))
    return path


def save_image_grid(images, path: str, nrow: int = 8):
    """[-1, 1] float [N, 3, H, W] (or an NHWC numpy array) -> a tiled PNG
    (torchvision ``save_image``'s grid; reference: train.py:179-192), with
    the JAX package's quantization, written by :func:`write_png`."""
    if isinstance(images, torch.Tensor):
        images = images.detach().float().permute(0, 2, 3, 1).cpu().numpy()
    imgs = np.clip((np.asarray(images) + 1.0) * 127.5, 0, 255).astype(
        np.uint8)
    n, h, w, c = imgs.shape
    ncol = int(math.ceil(n / nrow))
    grid = np.zeros((ncol * h, nrow * w, c), np.uint8)
    for i in range(n):
        r, c_ = divmod(i, nrow)
        grid[r * h:(r + 1) * h, c_ * w:(c_ + 1) * w] = imgs[i]
    return write_png(path, grid)


def gan_snapshot(gen, disc, g_opt, d_opt, ema) -> dict:
    """The 5-part checkpoint blob, host copies in the JAX package's flat
    keys and layouts (optax's ``count``/``mu``/``nu`` for each Adam)."""
    blob = {}
    for section, module in (("generator", gen), ("discriminator", disc),
                            ("g_running", ema)):
        blob.update({f"{section}/{k}": v for k, v in
                     interop.gan_flat_from_module(module).items()})
    for section, module, opt in (("g_optimizer", gen, g_opt),
                                 ("d_optimizer", disc, d_opt)):
        count, mu, nu = interop.gan_adam_to_flat(module, opt)
        blob[f"{section}/count"] = np.asarray(count, np.int32)
        for name, flat in (("mu", mu), ("nu", nu)):
            blob.update({f"{section}/{name}/{k}": v for k, v in flat.items()})
    return blob


def save_gan_checkpoint(path, gen, disc, g_opt, d_opt, ema):
    """Write the 5-part checkpoint atomically (``checkpoint.save_blob``)."""
    return checkpoint.save_blob(path, gan_snapshot(gen, disc, g_opt, d_opt,
                                                   ema))


def _section(blob, section):
    pre = f"{section}/"
    return {k[len(pre):]: v for k, v in blob.items() if k.startswith(pre)}


def restore_section(module, blob, section: str):
    """Overlay a checkpoint section onto a module's parameters; returns
    (loaded, total) so a caller can tell a layout mismatch (missing or
    shape-mismatched leaves keep their current values)."""
    return interop.load_gan_flat(module, _section(blob, section))


def restore_opt_section(module, optimizer, blob, section: str):
    """Overlay an optax Adam section (``count``, ``mu``, ``nu``) onto a
    ``torch.optim.Adam``; returns (loaded, total) counted as the JAX
    package counts the state's leaves."""
    flat = _section(blob, section)
    mu = {k[3:]: v for k, v in flat.items() if k.startswith("mu/")}
    nu = {k[3:]: v for k, v in flat.items() if k.startswith("nu/")}
    count = flat.get("count")
    total = 1 + 2 * len(list(module.parameters()))
    loaded = interop.load_gan_adam(module, optimizer, count, mu, nu)
    return loaded, total


def load_gan_checkpoint(path, gen, disc, g_opt, d_opt, ema):
    """Restore the 5-part checkpoint in place; warns, as the JAX package
    does, for every section that did not fully match."""
    blob = checkpoint.load_raw(path)
    results = {
        "generator": restore_section(gen, blob, "generator"),
        "discriminator": restore_section(disc, blob, "discriminator"),
        "g_optimizer": restore_opt_section(gen, g_opt, blob, "g_optimizer"),
        "d_optimizer": restore_opt_section(disc, d_opt, blob, "d_optimizer"),
        "g_running": restore_section(ema, blob, "g_running"),
    }
    for section, (loaded, total) in results.items():
        if loaded < total:
            print(f"WARNING: checkpoint {path} section '{section}': only "
                  f"{loaded}/{total} tensors matched (width_mult/layout "
                  "mismatch?); unmatched layers keep RANDOM init weights")
    return results


# ---------------------------------------------------------------- trainer
def build_argparser():
    p = argparse.ArgumentParser(description="Progressive Growing of GANs")
    p.add_argument("--phase", type=int, default=600_000,
                   help="samples per fade-in phase")
    p.add_argument("--lr", default=0.001, type=float)
    p.add_argument("--sched", action="store_true", help="lr/batch scheduling")
    p.add_argument("--init_size", default=8, type=int)
    p.add_argument("--max_size", default=512, type=int)
    p.add_argument("--ckpt", default=None, type=str)
    p.add_argument("--epoch_start", default=0, type=int)
    p.add_argument("--no_from_rgb_activate", action="store_true")
    p.add_argument("--mixing", action="store_true")
    p.add_argument("--loss", type=str, default="wgan-gp",
                   choices=["wgan-gp", "r1"])
    # configuration the reference hardcoded
    p.add_argument("--data_dir", required=True)
    p.add_argument("--output_dir", default=".")
    p.add_argument("--epochs", default=36, type=int)
    p.add_argument("--step_every", default=4, type=int,
                   help="epochs per resolution step (512-run: 4; 256-run: 10)")
    p.add_argument("--code_size", default=512, type=int)
    p.add_argument("--width_mult", default=1.0, type=float,
                   help="channel-width multiplier (tiny models for tests)")
    p.add_argument("--n_critic", default=1, type=int)
    p.add_argument("--batch_override", default=None, type=int)
    p.add_argument("--max_batches", default=None, type=int,
                   help="cap batches per epoch (smoke tests)")
    p.add_argument("--seed", default=0, type=int)
    p.add_argument("--mesh", default=0, type=int,
                   help="data-parallel G/D training over N ranks, one card "
                        "each (the reference's nn.DataParallel on 4 GPUs): "
                        "each rank keeps its rows of every batch, the "
                        "minibatch stddev, the batch means and the "
                        "gradients are sums over the ranks; the single-card "
                        "step up to the order of the sums")
    p.add_argument("--compute_dtype", default="f32", choices=["f32", "bf16"],
                   help="opt-in mixed precision for the G/D forward and "
                        "backward (torch.autocast); master weights, Adam, "
                        "the loss terms and the GP norm stay f32")
    p.add_argument("--ckpt_every", type=int, default=1,
                   help="write the 5-part checkpoint and the EMA sample grid "
                        "every N epochs (default 1, the reference's cadence, "
                        "train.py:166-218). A crash loses at most the N-1 "
                        "epochs after the most recent written checkpoint; the "
                        "final epoch and a SIGTERM stop are always written")
    p.add_argument("--remat", action="store_true",
                   help="recompute every G/D progression block in the "
                        "backward pass (torch.utils.checkpoint, which "
                        "carries the gradient penalty's second order)")
    p.add_argument("--ema_decay", type=float, default=0.999,
                   help="g_running EMA decay (the reference hardcodes "
                        "0.999; short runs keep 0.999^t of the initial "
                        "random generator, so pass e.g. 0.99 when there "
                        "are only a few thousand generator steps)")
    p.add_argument("--ema_warmup", action="store_true",
                   help="warm the g_running decay up as min(--ema_decay, "
                        "(1+t)/(10+t)) over optimizer steps t (default off, "
                        "the reference's constant decay)")
    p.add_argument("--grad_accum", type=int, default=1,
                   help="accumulate gradients over N sequential "
                        "microbatches per step (the batch must divide): "
                        "peak memory is one microbatch's; the minibatch "
                        "stddev sees the microbatch like each reference GPU "
                        "saw its share")
    p.add_argument("--profile", action="store_true",
                   help="trace the first epoch (host and card) into "
                        "<output_dir>/profile/, time every step (critic "
                        "and generator halves), and write each epoch's "
                        "step times, imgs/s and peak memory to "
                        "<output_dir>/train_stats.jsonl")
    return p


def _epoch_generator(seed: int, epoch: int, device) -> torch.Generator:
    """The epoch's draw stream on ``device``: a pure function of
    (seed, epoch)."""
    s = int(np.random.SeedSequence([seed, epoch, 11]).generate_state(1)[0])
    return torch.Generator(device=device).manual_seed(s)


def _schedule(args):
    """(init_step, max_step, the set of batch sizes the run will use)."""
    max_step = int(math.log2(args.max_size)) - 2
    init_step = min(max(int(math.log2(args.init_size)) - 2, 0), max_step)
    sched = ({args.batch_override} if args.batch_override else {
        STEP_BATCH_SIZE.get(
            4 * 2 ** min(init_step + e // args.step_every, max_step), 32)
        for e in range(args.epoch_start, args.epochs)})
    return init_step, max_step, sched


def _validate(args, mesh_size: int):
    """Argument checks before any dataset or device work: the whole
    progressive batch schedule against --grad_accum and --mesh (a batch
    that does not divide would otherwise stop a long run mid-flight)."""
    if args.ckpt_every < 1:
        raise RuntimeError(f"--ckpt_every must be >= 1, got {args.ckpt_every}")
    if not 0.0 <= args.ema_decay < 1.0:
        raise RuntimeError(f"--ema_decay must be in [0, 1), got "
                           f"{args.ema_decay}")
    if args.grad_accum < 1:
        raise RuntimeError(f"--grad_accum must be >= 1, got {args.grad_accum}")
    _, _, sched = _schedule(args)
    accum = args.grad_accum
    if accum > 1:
        bad = sorted(b for b in sched if b % accum)
        if bad:
            raise RuntimeError(
                f"batch schedule {bad} not divisible by --grad_accum "
                f"{accum}; pass --batch_override with a multiple of {accum}")
    if mesh_size:
        bad = sorted(b for b in sched if (b // accum) % mesh_size)
        if bad:
            raise RuntimeError(
                f"batch schedule {bad} not divisible over --mesh {mesh_size}"
                + (f" after --grad_accum {accum} microbatching"
                   if accum > 1 else "")
                + f"; pass --batch_override with a multiple of "
                f"{mesh_size * accum}")


def train_gan(args, device=None, mesh=None):
    """The training loop (the JAX package's ``train_gan``) on ``device``
    (the card unless ``"cpu"``), or on one rank of a data mesh. Returns
    ``(gen, disc, g_running)``."""
    device = resolve_device(device if mesh is None else mesh.device)
    _validate(args, 0 if mesh is None else mesh.size)
    writes = mesh is None or mesh.rank == 0
    width = args.width_mult
    sample_dir = os.path.join(args.output_dir, "sample")
    ckpt_dir = os.path.join(args.output_dir, "checkpoint")
    if writes:
        os.makedirs(sample_dir, exist_ok=True)
        os.makedirs(ckpt_dir, exist_ok=True)

    init = torch.Generator().manual_seed(args.seed)
    gen = sg.init_styled_generator(init, style_dim=args.code_size,
                                   width_mult=width, device=device)
    disc = sg.init_discriminator(
        init, width_mult=width,
        from_rgb_activate=not args.no_from_rgb_activate, device=device)
    ema = copy.deepcopy(gen).requires_grad_(False)
    g_opt, d_opt = make_optimizers(gen, disc)
    if args.ckpt:
        load_gan_checkpoint(args.ckpt, gen, disc, g_opt, d_opt, ema)
        print("Loaded GAN checkpoint", args.ckpt)
    if mesh is not None:
        print(f"GAN data-parallel over {mesh.size} ranks")

    lr_sched = ({128: 0.0015, 256: 0.002, 512: 0.003, 1024: 0.003}
                if args.sched else {})
    # a prebuilt resolution-keyed store (meta.json) reads pre-resized
    # tiles, the reference's LMDB MultiResolutionDataset; otherwise
    # resize-on-fetch from a plain image folder
    if os.path.exists(os.path.join(args.data_dir, MultiResolutionStore.META)):
        dataset = MultiResolutionStore(args.data_dir, seed=args.seed,
                                       device=device)
    else:
        dataset = ImageFolderDataset(args.data_dir, seed=args.seed,
                                     device=device)
    init_step, max_step, _ = _schedule(args)
    n_blocks = gen.n_blocks
    cdt = torch.bfloat16 if args.compute_dtype == "bf16" else None

    step_fns = {}
    ckpt_writer = checkpoint.AsyncCheckpointer()
    latch = PreemptionLatch().install()
    deterministic = torch.backends.cudnn.deterministic
    if device.type == "cuda":
        # bit-exact resume on the card: cuDNN's default algorithms may
        # reduce with atomics in the backward
        torch.backends.cudnn.deterministic = True
    stats_path = os.path.join(args.output_dir, "train_stats.jsonl")
    try:
        for epoch in range(args.epoch_start, args.epochs):
            step = min(init_step + epoch // args.step_every, max_step)
            final_progress = (init_step + epoch // args.step_every) >= max_step
            resolution = 4 * 2 ** step
            batch = args.batch_override or STEP_BATCH_SIZE.get(resolution, 32)
            lr = lr_sched.get(resolution, args.lr)
            dataset.NewResolution(resolution, batch)
            # every stream of epoch E is a pure function of (seed, E): the
            # batch order, the style-mixing coin flips and crossovers, and
            # every draw of the steps
            dataset.reseed(args.seed, epoch)
            py_rng = py_random.Random(args.seed * 1_000_003 + epoch * 7919
                                      + 1)
            draws_gen = _epoch_generator(args.seed, epoch, device)
            if step not in step_fns:
                kw = dict(loss_kind=args.loss, compute_dtype=cdt,
                          remat=args.remat, grad_accum=args.grad_accum,
                          mesh=mesh)
                step_fns[step] = (
                    make_d_step(step, **kw),
                    make_g_step(step, ema_decay=args.ema_decay,
                                ema_warmup=args.ema_warmup, **kw))
            d_step, g_step = step_fns[step]

            # used_sample (and with it the alpha fade-in) resets every
            # epoch, as in the reference (train.py:80)
            used_sample = 0
            alpha = 1.0
            zero = torch.zeros((), device=device)
            disc_loss_dev = gp_dev = gen_loss_dev = zero
            t0 = time.time()
            n_batches = 0
            timing = args.profile
            step_s, d_s = [], []
            if timing and device.type == "cuda":
                torch.cuda.reset_peak_memory_stats(device)
            trace_ctx = contextlib.nullcontext()
            if args.profile and epoch == args.epoch_start and writes:
                from ..utils import profiling

                trace_ctx = profiling.trace(
                    os.path.join(args.output_dir, "profile"), device=device)
            with trace_ctx:
                for i, real in enumerate(prefetch_iter(dataset.batches())):
                    n_batches += 1
                    if args.max_batches and i >= args.max_batches:
                        break
                    b = real.shape[0]
                    alpha = (1.0 if (resolution == args.init_size
                                     and not args.ckpt) or final_progress
                             else min(1.0, (used_sample + 1) / args.phase))
                    used_sample += b
                    real = real.permute(0, 3, 1, 2).contiguous()
                    ts = time.perf_counter()
                    mixing = args.mixing and py_rng.random() < 0.9
                    zs = torch.randn((2, b, args.code_size),
                                     generator=draws_gen, device=device)
                    sel = sg.sample_style_sel(py_rng, 2 if mixing else 1,
                                              step, n_blocks)
                    draws = draw_d(draws_gen, disc, b, step, device)
                    aux = d_step(gen, disc, d_opt, real, zs, sel, alpha, lr,
                                 draws)
                    del draws
                    disc_loss_dev = aux["disc_loss"]
                    gp_dev = aux["grad_penalty"]
                    if timing:
                        float(disc_loss_dev)  # the card's time, not enqueue
                        d_s.append(time.perf_counter() - ts)
                    if (i + 1) % args.n_critic == 0:
                        mixing = args.mixing and py_rng.random() < 0.9
                        zs2 = torch.randn((2, b, args.code_size),
                                          generator=draws_gen, device=device)
                        sel2 = sg.sample_style_sel(
                            py_rng, 2 if mixing else 1, step, n_blocks)
                        gen_loss_dev = g_step(
                            gen, disc, g_opt, ema, zs2, sel2, alpha, lr,
                            draw_g(draws_gen, disc, b, step, device))
                    if timing:
                        float(gen_loss_dev)
                        step_s.append(time.perf_counter() - ts)

            if n_batches == 0:
                raise RuntimeError(
                    f"epoch {epoch}: zero batches at batch size {batch} over "
                    f"{len(dataset)} images (batches drop ragged tails). Pass "
                    "--batch_override with a size <= the dataset size.")
            gen_loss, disc_loss, gp = (float(gen_loss_dev),
                                       float(disc_loss_dev), float(gp_dev))
            if not all(map(math.isfinite, (gen_loss, disc_loss, gp))):
                # halt WITHOUT checkpointing the poisoned epoch so the newest
                # checkpoint on disk stays the last healthy one
                halt = Diverged(
                    f"non-finite GAN losses at epoch {epoch} "
                    f"(G {gen_loss}, D {disc_loss}, GP {gp}); halted "
                    "WITHOUT checkpointing; resume from the most recent "
                    "written checkpoint (with --ckpt_every N that is up to "
                    "N-1 epochs back)")
                try:
                    ckpt_writer.wait()  # the last healthy write must land
                except Exception as exc:
                    raise halt from exc
                raise halt
            print(f"Epoch {epoch}: res {resolution}; samples {used_sample}; "
                  f"G {gen_loss:.3f}; D {disc_loss:.3f}; GP {gp:.3f}; "
                  f"alpha {alpha:.4f}; {time.time() - t0:.1f}s")
            if timing and writes:
                timed = step_s[1:] or step_s  # the first step warms up
                row = {"epoch": epoch, "resolution": resolution,
                       "batch": batch, "grad_accum": args.grad_accum,
                       "compute_dtype": args.compute_dtype,
                       "step_s": step_s, "d_step_s": d_s,
                       "median_step_s": float(np.median(timed)),
                       "imgs_per_s": batch / float(np.median(timed)),
                       "peak_mem_bytes": (
                           torch.cuda.max_memory_allocated(device)
                           if device.type == "cuda" else None)}
                with open(stats_path, "a") as f:
                    f.write(json.dumps(row) + "\n")
                print(f"profile: {len(timed)} timed batches, median "
                      f"{row['median_step_s'] * 1e3:.0f} ms, "
                      f"{row['imgs_per_s']:.1f} imgs/s")

            # EMA sample grid + 5-part checkpoint (reference:
            # train.py:166-218)
            stopping = latch.stop_requested()
            if mesh is not None:  # rank 0's signal decides for every rank
                stopping = M.broadcast_object(stopping, mesh)
            due = ((epoch + 1) % args.ckpt_every == 0
                   or epoch == args.epochs - 1 or stopping)
            if due and writes:
                with torch.no_grad():
                    n = min(16, batch)
                    zs = torch.randn((1, n, args.code_size),
                                     generator=draws_gen, device=device)
                    noise = sg.make_noise(draws_gen, n, step, device)
                    imgs = sg.apply_styled_generator(ema, zs, noise,
                                                     step=step, alpha=1.0)
                save_image_grid(imgs, os.path.join(
                    sample_dir, f"e{epoch}_gen.png"), nrow=4)
                ckpt_writer.submit(
                    checkpoint.save_blob,
                    os.path.join(ckpt_dir, f"train_step-{epoch}.model"),
                    gan_snapshot(gen, disc, g_opt, d_opt, ema))
            if stopping:
                print(f"train: preempted, stopped after epoch {epoch}; "
                      f"resume with --ckpt ...train_step-{epoch}.model "
                      f"--epoch_start {epoch + 1}")
                break
    finally:
        latch.restore()
        torch.backends.cudnn.deterministic = deterministic
    ckpt_writer.wait()  # the final epoch's checkpoint must be durable
    return gen, disc, ema


def main(argv=None, *, device=None):
    """The CLI; ``device`` is the card unless ``"cpu"`` is asked for. With
    ``--mesh N`` it spawns N ranks (one card each; N gloo ranks with
    ``device="cpu"``) and returns rank 0's exit code."""
    argv = sys.argv[1:] if argv is None else list(argv)
    args = build_argparser().parse_args(argv)
    if args.mesh:
        _validate(args, args.mesh)
        return M.launch(_mesh_rank, args.mesh, args=(argv,),
                        devices=M.mesh_devices(args.mesh, device))[0]
    return _run(args, device)


def _mesh_rank(mesh, argv):
    return _run(build_argparser().parse_args(argv), None,
                M.data_mesh(device=mesh.device))


def _run(args, device, mesh=None):
    print(args)
    try:
        train_gan(args, device, mesh)
    except Diverged as e:
        print(f"FATAL: {e}", file=sys.stderr)
        return DIVERGED_EXIT
    return 0


if __name__ == "__main__":
    sys.exit(main())
