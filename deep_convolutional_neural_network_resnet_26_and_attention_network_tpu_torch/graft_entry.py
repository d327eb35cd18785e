"""The port's entry points: the flagship model's forward, and a
multi-rank dry run of the training step.

Counterpart of the repository's ``__graft_entry__.py``, which drives the
JAX package (``entry`` at its line 45, ``dryrun_multichip`` at 113):

  * :func:`entry` returns ``(fn, example_args)``: the eval-mode bag forward
    of the gated attention-MIL classifier with the ResNet-26 extractor, in
    bf16, on the card unless ``device="cpu"`` is asked for.
  * :func:`dryrun_multichip` spawns ``n`` gloo ranks on the CPU as a
    (slides, tiles) mesh (``parallel/mesh.py``) and runs, on tiny shapes,
    one window step (bags over the slide axis, each bag's tiles over the
    tile axis, the gradients summed over every rank) and the explicit
    sharded pool (``parallel/shard_pool.py``).
  * :func:`dryrun_multichip_gan`, the JAX dry run's other half: the
    StyleGAN's WGAN-GP critic step (double backward, two microbatches a
    rank) and its style-mixing generator step with the EMA, over a data
    mesh of ``n`` gloo ranks on the CPU.

Run ``python -m deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.graft_entry``
on a machine with a card.
"""

import math

import torch

from .models import attention_mil as amil
from .parallel import mesh as M
from .parallel import shard_pool, steps


def entry(device=None):
    """``(fn, example_args)``: ``fn(model, tiles, mask, label) -> (y_pred
    [1, 3], loss [], Aterm [3, T])``, the eval-mode bag forward in bf16
    over 64 tiles of 128 px."""
    cfg = amil.MILConfig()
    model = amil.init_attention_mil(torch.Generator().manual_seed(0), cfg,
                                    device=device)
    dev = next(model.parameters()).device
    T, H, W = 64, 128, 128
    tiles = torch.zeros((T, H, W, 3), dtype=torch.float32, device=dev)
    mask = torch.ones((T,), dtype=torch.float32, device=dev)

    def fn(model, tiles, mask, label):
        out = amil.apply_attention_mil(model, tiles, label, cfg, mask=mask,
                                       compute_dtype=torch.bfloat16)
        return out["y_pred"], out["loss"], out["Aterm"]

    return fn, (model, tiles, mask, 0)


def _dryrun_rank(mesh):
    """One rank of :func:`dryrun_multichip`: the window step and the
    sharded pool; returns the window's loss."""
    cfg = amil.MILConfig(widths=(8, 8, 8, 8), blocks=(1, 1, 1, 1), L=80)
    model = amil.init_attention_mil(torch.Generator().manual_seed(0), cfg,
                                    device=mesh.device)
    opt = steps.make_optimizer(model)
    steps.replicate_state(mesh, model, opt)
    B = mesh.shape[M.SLIDES_AXIS]           # one bag per slide rank
    T = 8 * mesh.shape[M.TILES_AXIS]        # a training subsample per rank
    step = steps.make_train_step(cfg, mesh=mesh)
    metrics = step(model, opt, torch.ones((B, T, 32, 32, 3)),
                   torch.ones((B, T)), [0] * B, 2e-4,
                   generators=[torch.Generator().manual_seed(1 + b)
                               for b in range(B)])
    loss = float(metrics["loss"])
    if not math.isfinite(loss):
        raise AssertionError("non-finite loss in the dry run")
    # the explicit collective path: the tile-sharded pool
    h, m = shard_pool.shard_features(mesh, torch.ones((T, cfg.L)))
    pooled = shard_pool.make_sharded_pool(cfg, mesh)(model, h, m)
    if not bool(torch.isfinite(pooled["logits"]).all()):
        raise AssertionError("non-finite sharded pool")
    return loss


def dryrun_multichip(n_devices: int) -> None:
    """One window step and the sharded pool on ``n_devices`` gloo ranks on
    the CPU, in float32 (tiny shapes); every rank must report the same
    finite loss."""
    losses = M.launch(_dryrun_rank, n_devices,
                      devices=["cpu"] * n_devices)
    if len(set(losses)) != 1:
        raise AssertionError(f"the ranks disagree on the loss: {losses}")


def _gan_dryrun_rank(mesh):
    """One rank of :func:`dryrun_multichip_gan`: the critic step at 4 px,
    two microbatches of one image a rank, then the style-mixing generator
    step; returns both losses."""
    from .models import stylegan as sg
    from .train import gan

    dm = M.data_mesh(device=mesh.device)
    width, step, B = 1 / 32, 0, 2 * dm.size
    init = torch.Generator().manual_seed(2)
    gen = sg.init_styled_generator(init, width_mult=width, device=dm.device)
    disc = sg.init_discriminator(init, width_mult=width, device=dm.device)
    ema = sg.init_styled_generator(init, width_mult=width, device=dm.device)
    ema.load_state_dict(gen.state_dict())
    g_opt, d_opt = gan.make_optimizers(gen, disc)
    draws = torch.Generator().manual_seed(3)
    d_step = gan.make_d_step(step, grad_accum=2, mesh=dm)
    aux = d_step(gen, disc, d_opt, torch.ones((B, 3, 4, 4)),
                 torch.ones((1, B, 512)), None, 1.0, 1e-3,
                 gan.draw_d(draws, disc, B, step))
    sel = [0] + [1] * (gen.n_blocks - 1)
    g_step = gan.make_g_step(step, grad_accum=2, mesh=dm)
    g_loss = g_step(gen, disc, g_opt, ema, torch.ones((2, B, 512)), sel, 1.0,
                    1e-3, gan.draw_g(draws, disc, B, step))
    losses = (float(aux["disc_loss"]), float(g_loss))
    if not all(map(math.isfinite, losses)):
        raise AssertionError(f"non-finite GAN losses in the dry run: {losses}")
    return losses


def dryrun_multichip_gan(n_devices: int) -> None:
    """The JAX dry run's StyleGAN half on ``n_devices`` gloo ranks on the
    CPU (tiny widths): the WGAN-GP d_step with two microbatches and the
    style-mixing g_step over a data mesh; every rank must report the same
    finite losses."""
    losses = M.launch(_gan_dryrun_rank, n_devices,
                      devices=["cpu"] * n_devices)
    if len(set(losses)) != 1:
        raise AssertionError(f"the ranks disagree on the losses: {losses}")


if __name__ == "__main__":
    fn, args = entry()
    out = fn(*args)
    print("entry() OK:", [tuple(o.shape) for o in out])
    dryrun_multichip(8)
    print("dryrun_multichip OK on 8 gloo ranks on the CPU")
    dryrun_multichip_gan(8)
    print("dryrun_multichip_gan OK on 8 gloo ranks on the CPU")
