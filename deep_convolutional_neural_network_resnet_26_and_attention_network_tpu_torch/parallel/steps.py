"""Train and eval steps of the attention-MIL model, on one card or a mesh.

Counterpart of ``parallel/steps.py`` in the JAX package, after the
reference training loop (reference:
gbm/classify_combined.py:388-485): Adam(betas=(0.9, 0.999), eps=1e-8),
gradients summed over ``accum`` bags before each optimizer step (the
reference uses 5), and the staged learning rate passed in per step.

Where the JAX package returns a gradient tree and sums trees
(``make_accumulate``), each bag's ``loss.backward()`` here adds its
gradient into the parameters' ``.grad``, so consecutive calls sum the
window exactly as the JAX package's ``acc + grads`` does; ``apply_updates``
steps and clears them. ``torch.optim.Adam`` with the learning rate set per
step is optax's ``scale_by_adam`` followed by ``-lr * update``.

``make_train_step`` is the JAX package's batched window step: one Adam
step on the summed losses of a window of bags, dummy bags weighted 0. On a
mesh (``parallel/mesh.py``) each slide rank runs its own bags of the window
and each tile rank its share of every such bag's tiles; after the backward
one all-reduce sums every gradient over the whole world, and every rank
takes the same Adam step. The JAX package writes none of these
collectives (GSPMD inserts them); here they are explicit.
"""

import torch

from ..models import attention_mil as amil
from ..ops.collectives import all_reduce_
from . import mesh as M

ADAM_BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8


def make_optimizer(model):
    """Adam matching the JAX package's ``optax.scale_by_adam(b1=0.9,
    b2=0.999, eps=1e-8)``; the learning rate is set by each
    :func:`apply_updates` call so the staged schedule can change it."""
    return torch.optim.Adam(model.parameters(), lr=0.0, betas=ADAM_BETAS,
                            eps=ADAM_EPS)


ADAM_BETAS_LEGACY = (0.9, 0.99)


def make_optimizer_legacy(model, lr_mults=None):
    """Adam with the legacy driver's betas (reference: gbm/classify.py:374,
    betas=(0.9, 0.99)), the JAX package's ``make_optimizer_legacy``: one
    parameter group per top-level module of ``model``, each with the
    ``lr_mult`` that ``lr_mults`` gives its name (1 if absent), which
    :func:`apply_updates` multiplies into the learning rate."""
    groups = {}
    for name, p in model.named_parameters():
        groups.setdefault(name.split(".")[0], []).append(p)
    lr_mults = lr_mults or {}
    return torch.optim.Adam(
        [{"params": ps, "lr_mult": float(lr_mults.get(top, 1.0))}
         for top, ps in groups.items()],
        lr=0.0, betas=ADAM_BETAS_LEGACY, eps=ADAM_EPS)


def apply_updates(optimizer, lr: float):
    """One optimizer step on the summed gradients at learning rate ``lr``
    (times each group's ``lr_mult``, where it has one)
    (``optimizer.step()`` after the reference's 5 accumulated bags,
    gbm/classify_combined.py:450-454), then clear the gradients. A
    parameter without a gradient steps with a zero one, as optax updates
    every leaf: its moments decay and its step count advances."""
    for group in optimizer.param_groups:
        group["lr"] = float(lr) * group.get("lr_mult", 1.0)
        for p in group["params"]:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
    optimizer.step()
    optimizer.zero_grad(set_to_none=True)


def make_bag_grad(cfg: amil.MILConfig, *, compute_dtype=None):
    """Per-bag loss backward: ``fn(model, tiles, mask, label,
    generator=None, *, scores=None, keep=None) -> outputs``. One call is one
    ``loss.backward()`` of the reference's hot loop
    (gbm/classify_combined.py:446-447): the bag's gradient is added to each
    parameter's ``.grad``. The outputs are detached."""

    def grad_fn(model, tiles, mask, label, generator=None, **noise):
        outs = amil.apply_attention_mil(
            model, tiles, label, cfg, mask=mask, train=True,
            generator=generator, compute_dtype=compute_dtype, **noise)
        outs["loss"].backward()
        return {**outs, "loss": outs["loss"].detach()}

    return grad_fn


def make_bag_forward(cfg: amil.MILConfig, *, train: bool = False,
                     compute_dtype=None, extractor=None):
    """Single-bag forward without autograd: ``fn(model, tiles, mask, label,
    generator=None) -> dict``; ``train=True`` takes the training forward's
    subsample and dropout (validation before the Check stage does).
    ``extractor`` swaps the tile embedder (the W8A8 int8 serving path,
    ``ops.quant.make_int8_extractor``)."""

    def fwd(model, tiles, mask, label, generator=None):
        with torch.no_grad():
            return amil.apply_attention_mil(
                model, tiles, label, cfg, mask=mask, train=train,
                generator=generator, compute_dtype=compute_dtype,
                extractor=extractor)

    return fwd


def make_eval_step(cfg: amil.MILConfig, *, compute_dtype=None):
    """``eval(model, tiles [B, T, H, W, 3], masks [B, T], labels [B]) ->``
    the per-bag outputs stacked on a leading axis, without ``Fterm``."""

    def step(model, tiles, masks, labels):
        outs = batched_forward(model, tiles, masks, labels, cfg,
                               compute_dtype=compute_dtype)
        outs.pop("Fterm")
        return outs

    return step


def batched_forward(model, tiles, masks, labels, cfg, *, compute_dtype=None,
                    extractor=None):
    """The eval forward of a batch of bags, one after another (the JAX
    package's vmapped ``batched_forward``): ``tiles`` [B, T, H, W, 3] (or a
    list of B bags), ``masks`` [B, T], ``labels`` [B]. Returns the per-bag
    outputs stacked on a leading axis."""
    fwd = make_bag_forward(cfg, compute_dtype=compute_dtype,
                           extractor=extractor)
    outs = [fwd(model, t, m, int(lbl))
            for t, m, lbl in zip(tiles, masks, labels)]
    return {k: torch.stack([o[k] for o in outs]) for k in outs[0]}


# the per-bag scalars of a window step's metrics, in the order of the rows
# the mesh all-reduces
_SCALARS = ("loss", "error", "Aterm_mu", "Aterm_var", "KLD", "l2")


def _split_bag(mesh, tiles, idx, sub_mask, keep, L):
    """This rank's share of a training bag's chosen tiles (``idx``, taken
    over the whole bag): the rows padded with zero-mask rows to a multiple
    of the tile axis, then cut; the tiles copied to the rank's card."""
    k = idx.shape[0]
    pad = -k % mesh.shape[M.TILES_AXIS]
    if pad:
        idx = torch.cat([idx, idx.new_zeros(pad)])
        sub_mask = torch.cat([sub_mask, sub_mask.new_zeros(pad)])
        if keep is not None:
            keep = torch.cat([keep, keep.new_ones((pad, L))])
    rows = mesh.rows(k + pad)
    share = idx[rows]
    return (tiles[share.to(tiles.device)].to(mesh.device),
            sub_mask[rows].to(mesh.device),
            None if keep is None else keep[rows])


def _train_bag(model, cfg, mesh, tiles, mask, label, weight, noise,
               compute_dtype):
    """One bag of a window step: its forward on this rank (the whole bag,
    or this rank's share of its subsample on a mesh) and, for a real bag,
    the backward of its loss. ``noise`` is a generator or the injected
    ``(scores [T], keep [k, L])``. Returns the detached outputs."""
    generator, scores, keep = noise
    if mesh is None:
        with torch.set_grad_enabled(weight > 0):
            outs = amil.apply_attention_mil(
                model, tiles, label, cfg, mask=mask, train=True,
                generator=generator, scores=scores, keep=keep,
                compute_dtype=compute_dtype)
    else:
        # the subsample is a top-k over the whole bag: every rank of the
        # tile axis takes it on the host from the same scores, then keeps
        # its share of the chosen tiles
        if scores is None:
            scores = amil.gumbel_scores(generator, tiles.shape[0])
        idx, sub_mask = amil.subsample_index(mask.cpu(),
                                             cfg.train_tile_fraction,
                                             scores.cpu())
        if keep is None and cfg.dropout > 0.0:
            keep = amil.dropout_keep(generator, (idx.shape[0], cfg.L),
                                     cfg.dropout)
        part, part_mask, part_keep = _split_bag(mesh, tiles, idx, sub_mask,
                                                keep, cfg.L)
        with torch.set_grad_enabled(weight > 0):
            outs = amil._bag_forward(
                model, part, label, cfg, part_mask, part_keep, compute_dtype,
                remat=cfg.remat, group=mesh.tiles_group)
    if weight > 0:
        # the tile ranks of a bag hold the same loss; the pool's backward
        # takes dM as it is (ops/gated_pool.py), so no rank scales it
        (outs["loss"] * weight).backward()
    return {k: v.detach() for k, v in outs.items()}


def _all_reduce_flat(tensors, mesh):
    """Sum ``tensors`` in place over every rank of ``mesh``, as one
    all-reduce of their concatenation on the rank's device (Adam keeps
    its step counts on the host)."""
    flat = torch.cat([x.reshape(-1).to(mesh.device) for x in tensors])
    all_reduce_(flat, mesh.world_group)
    start = 0
    for x in tensors:
        x.copy_(flat[start:start + x.numel()].view_as(x))
        start += x.numel()


def sync_grads(model, mesh):
    """Sum every parameter's gradient over all ranks of ``mesh``, in one
    all-reduce (a missing gradient counts as zero, as optax steps every
    leaf)."""
    params = list(model.parameters())
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    _all_reduce_flat([p.grad for p in params], mesh)


def make_train_step(cfg: amil.MILConfig, *, mesh=None, compute_dtype=None):
    """The window step: ``step(model, optimizer, tiles, masks, labels, lr,
    *, bag_weights=None, generators=None, scores=None, keep=None) ->
    metrics``, one Adam step on the summed losses of the ``B`` bags.

    ``tiles``, ``masks``: the window's bags (a [B, T, ...] tensor or lists
    of B bags of any sizes; on a mesh every rank passes the whole window).
    Each bag's noise is ``generators[b]`` (scores, then the dropout mask,
    as the single-bag path draws them) or the injected ``scores[b]`` [T_b]
    and ``keep[b]`` [k_b, L]. ``bag_weights`` [B] (1 real, 0 dummy) lets a
    partial window pad to B: a dummy bag adds no gradient and no metric,
    and its ``y_pred_hat`` is -1.

    With ``mesh``, slide rank s runs ``mesh.bags(B)`` and each tile rank
    its share of every such bag's subsample; the gradients are summed over
    the world before the step, which every rank then takes alike. Returns
    ``loss``, ``error``, ``Aterm_mu``, ``Aterm_var``, ``KLD`` and ``l2`` as
    weighted means over the real bags, ``y_pred`` [B, 1, C] and
    ``y_pred_hat`` [B], on the host, the same on every rank."""

    def step(model, optimizer, tiles, masks, labels, lr, *, bag_weights=None,
             generators=None, scores=None, keep=None):
        B = len(tiles)
        weights = (torch.ones(B) if bag_weights is None
                   else torch.as_tensor(bag_weights, dtype=torch.float32))
        mine = range(B) if mesh is None else mesh.bags(B)
        device = model.weight_mask.device if mesh is None else mesh.device
        width = len(_SCALARS) + cfg.n_classes + 1
        rows = torch.zeros((B, width), dtype=torch.float32, device=device)
        for b in mine:
            noise = ((generators[b], None, None) if scores is None
                     else (None, scores[b],
                           None if keep is None else keep[b]))
            outs = _train_bag(model, cfg, mesh, tiles[b], masks[b],
                              int(labels[b]), float(weights[b]), noise,
                              compute_dtype)
            if mesh is None or mesh.tile == 0:
                rows[b] = torch.cat(
                    [torch.stack([outs[k].float().reshape(())
                                  for k in _SCALARS]),
                     outs["y_pred"].float().reshape(-1),
                     outs["y_pred_hat"].float().reshape(1)])
        if mesh is not None:
            sync_grads(model, mesh)
            all_reduce_(rows, mesh.world_group)
        apply_updates(optimizer, lr)
        rows = rows.cpu()
        denom = torch.clamp_min(weights.sum(), 1.0)
        metrics = {k: (rows[:, i] * weights).sum() / denom
                   for i, k in enumerate(_SCALARS)}
        n = len(_SCALARS)
        metrics["y_pred"] = rows[:, n:n + cfg.n_classes].reshape(B, 1, -1)
        metrics["y_pred_hat"] = torch.where(
            weights > 0, rows[:, -1].long(), torch.full((B,), -1))
        return metrics

    return step


def shard_batch(mesh, tiles, masks, labels):
    """This rank's part of an eval batch: ``(bags, tiles, masks, labels)``,
    the indices of the slide rank's bags (``mesh.bags``) and, for each,
    this tile rank's share of its rows (``mesh.rows``; a bag's tile count
    must divide over the tile axis) on the rank's device."""
    bags = list(mesh.bags(len(tiles)))
    out_t, out_m = [], []
    for b in bags:
        rows = mesh.rows(tiles[b].shape[0])
        out_t.append(tiles[b][rows].to(mesh.device))
        out_m.append(masks[b][rows].to(mesh.device))
    return bags, out_t, out_m, [labels[b] for b in bags]


def replicate_state(mesh, model, optimizer=None):
    """Make every rank's parameters, buffers and Adam state rank 0's, in
    one all-reduce of rank 0's values and the other ranks' zeros (each rank
    must hold the same structure: the CLIs build it, and load a resumed
    checkpoint, on every rank)."""
    tensors = list(model.parameters()) + list(model.buffers())
    if optimizer is not None:
        for state in optimizer.state.values():
            tensors += [v for v in state.values()
                        if isinstance(v, torch.Tensor)]
    with torch.no_grad():
        if mesh.rank != 0:
            for x in tensors:
                x.zero_()
        _all_reduce_flat([x.data if isinstance(x, torch.nn.Parameter)
                          else x for x in tensors], mesh)
