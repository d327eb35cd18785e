"""Gated attention multiple-instance-learning head over bags of tile features.

Counterpart of ``models/attention_mil.py`` in the JAX package, after the
reference's Attention model (reference: gbm/model.py:89-264):

    H  = ResNet26(tiles)                               [T, L=80]
    Hm0, Hz0 = ContextLayer(H)   # lrelu branch, per-bag batchnorm branch
    A_raw = Linear(L,D) -> tanh -> Linear(D,K)          [T, K=3]
    gate:  sigmoid(-10*w) * softplus(A_raw) + sigmoid(10*w)   (learnable w, init 0.25)
    A = L1-normalize(gate, over tiles) -> transpose     [K, T]
    B = Linear(L,D) -> lrelu -> Linear(D,1)             [T, 1]
    M = A @ B                                           [K, 1] -> logits [1, K]
    y_pred = softmax(logits); loss = smoothed CE (smoothing 0.25, class weights)

Bags may be padded with a validity ``mask``; every tile-axis reduction
counts only valid tiles. The gated pool goes through
``ops/gated_pool.gated_attention_pool``: the CUDA kernels for tensors on
the card, their plain versions on the CPU (the JAX package holds the two
paths to 1e-6, so there is no switch), forward and closed-form backward.

``train=True`` is the training forward: a 20 % subsample of the valid tiles
(Gumbel top-k, ``_subsample``) and dropout on the instance-code branch,
with autograd on; only ``loss`` carries a gradient, every other output is
detached, as the JAX package's ``stop_gradient`` does. Its noise is either
injected (``scores`` [T], ``keep`` [k, L] boolean), which the tests use to
feed both packages the same noise, or drawn from a ``torch.Generator``.
Eval runs without autograd.

``group``, the tile-axis process group of a bag whose tile axis is split
across ranks (``parallel/mesh.py``), makes every reduction over tiles a sum
across the group: the batch-norm statistics, the pool (its split entries,
``gated_pool.sharded_gated_attention_pool``), ``KLD``'s and ``Aterm_mu``'s
masked means and ``Aterm_var``'s column norms and Gram matrix. The
per-tile outputs (``Aterm``, ``wROIs``, ``Bterm``, ``Fterm``) are then this
rank's rows; the rest is the whole bag's, on every rank of the group.
``group=None`` is the single-card path.
"""

from dataclasses import dataclass
from typing import Optional, Tuple

import torch
from torch import nn

from .._device import resolve_device
from ..ops import gated_pool
from ..ops.collectives import all_reduce_sum
from ..ops import init as I
from ..ops import loss as L
from ..ops import nn as N
from . import resnet


@dataclass(frozen=True)
class MILConfig:
    """Model hyperparameters (reference: gbm/model.py:120-124)."""
    L: int = 80            # feature dim into the attention mechanism
    D: int = 40            # attention hidden dim
    K: int = 3             # attention maps
    O: int = 1             # instance-code output nodes
    n_classes: int = 3
    smoothing: float = 0.25
    dropout: float = 0.25
    train_tile_fraction: float = 0.2
    remat: bool = False  # recompute resnet blocks in the backward pass
    stem: str = "conv7"  # "s2d" = space-to-depth stem (same math)
    class_weights: Optional[Tuple[float, ...]] = None
    widths: Tuple[int, ...] = resnet.WIDTHS
    blocks: Tuple[int, ...] = resnet.BLOCKS_PER_STAGE


class AttentionMIL(nn.Module):
    """cnn + context + attention + buffer + gate, with the reference's
    state-dict names (``context.bn``, ``attention.lin{1,2}``,
    ``buffer.lin1``, ``buffer.classifier``, ``weight_mask``). Its
    parameters lie on ``device``: the card unless the CPU (or ``"meta"``)
    is asked for."""

    def __init__(self, cfg: MILConfig = MILConfig(), device=None):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        self.cnn = resnet.ResNet26(embed_dim=cfg.L, widths=cfg.widths,
                                   blocks=cfg.blocks, device=device)
        # ContextLayer BatchNorm1d without running stats: only its affine
        # parameters are used, with masked statistics (ops.nn.batch_norm_tiles)
        self.context = nn.Module()
        self.context.bn = nn.BatchNorm1d(cfg.L, track_running_stats=False,
                                         device=device)
        self.attention = nn.ModuleDict({
            "lin1": nn.Linear(cfg.L, cfg.D, device=device),
            "lin2": nn.Linear(cfg.D, cfg.K, device=device)})
        self.buffer = nn.ModuleDict({
            "lin1": nn.Linear(cfg.L, cfg.D, device=device),
            "classifier": nn.Linear(cfg.D, cfg.O, device=device)})
        self.weight_mask = nn.Parameter(torch.empty(cfg.K, device=device))

    @torch.no_grad()
    def reset_parameters(self, generator):
        cfg = self.cfg
        self.cnn.reset_parameters(generator)
        self.context.bn.weight.fill_(1.0)
        self.context.bn.bias.zero_()
        a, b = self.attention, self.buffer
        # attention MLP: tanh-gain kaiming fan_in (name contains 'attention')
        a["lin1"].weight.copy_(
            I.linear_kaiming_fan_in(generator, cfg.L, cfg.D, I.TANH_GAIN))
        a["lin2"].weight.copy_(
            I.linear_kaiming_fan_in(generator, cfg.D, cfg.K, I.TANH_GAIN))
        # instance-code MLP: lin1 kaiming lrelu fan_in; 'classifier' xavier
        b["lin1"].weight.copy_(I.linear_kaiming_fan_in(
            generator, cfg.L, cfg.D, I.leaky_relu_gain(0.1)))
        b["classifier"].weight.copy_(
            I.linear_xavier_normal(generator, cfg.D, cfg.O))
        for lin in (a["lin1"], a["lin2"], b["lin1"], b["classifier"]):
            lin.bias.zero_()
        # learnable per-map gate, init 0.25 (reference: gbm/model.py:153)
        self.weight_mask.fill_(0.25)

    def forward(self, tiles, label=0, *, mask=None, compute_dtype=None):
        return apply_attention_mil(self, tiles, label, self.cfg, mask=mask,
                                   compute_dtype=compute_dtype)


def init_attention_mil(generator, cfg: MILConfig = MILConfig(), *,
                       device=None):
    """An AttentionMIL on ``device`` (the card by default) with the
    reference's init drawn from ``generator``."""
    model = AttentionMIL(cfg, device="meta").to_empty(
        device=resolve_device(device))
    model.reset_parameters(generator)
    return model.eval()


def _lin(x, layer):
    """x [..., in] through an nn.Linear, in the JAX ``x @ w + b`` order."""
    return N.linear(x, layer.weight.T, layer.bias)


def gumbel_scores(generator, n: int):
    """``n`` standard Gumbel draws (``jax.random.gumbel``'s distribution)
    from a CPU ``torch.Generator``."""
    u = torch.rand(n, generator=generator, dtype=torch.float32)
    return -torch.log(-torch.log(u.clamp_min(torch.finfo(torch.float32).tiny)))


def dropout_keep(generator, shape, rate: float):
    """Boolean keep mask of ``shape``, True with probability ``1 - rate``
    (``jax.random.bernoulli(rng, 1 - rate)``), from a CPU generator."""
    return torch.rand(shape, generator=generator) < 1.0 - rate


def _subsample(tiles, mask, fraction, scores):
    """Random subsample of the VALID tiles (train-time only), after the JAX
    package's ``_subsample`` with its Gumbel draws given as ``scores`` [T].

    ``k_static = max(1, int(T * fraction))`` candidates are the top scores
    among mask>0 tiles (descending); the mask then zeroes every candidate
    beyond ``max(1, floor(T_valid * fraction))``, the reference's
    int(T_valid * fraction) (reference: gbm/model.py:192-194)."""
    idx, sub_mask = subsample_index(mask, fraction, scores)
    return tiles[idx], sub_mask


def subsample_index(mask, fraction, scores):
    """:func:`_subsample`'s choice, on ``mask``'s device: the indices
    ``[k_static]`` of the chosen tiles and their mask. The mesh trainer
    takes it on the host, over the whole bag, before it splits the chosen
    tiles across the tile axis (``parallel/steps.py``). Equal scores (a
    few in a bag of thousands of float32 draws) go lower index first, the
    rule of ``jax.lax.top_k``, on every device: ``torch.topk`` leaves
    their order to the device's algorithm, and the order decides which
    tile meets which row of the dropout mask."""
    k_static = max(1, int(mask.shape[0] * fraction))
    s = torch.where(mask > 0, scores.to(mask.device, torch.float32),
                    torch.full_like(mask, float("-inf")))
    idx = torch.sort(s, descending=True, stable=True).indices[:k_static]
    k_dyn = torch.clamp_min(torch.floor(mask.sum() * fraction), 1.0)
    keep = (torch.arange(k_static, device=mask.device) < k_dyn).to(mask.dtype)
    return idx, mask[idx] * keep


def attention_pool(model, H, cfg: MILConfig, *, mask=None, keep=None,
                   group=None):
    """Everything after the CNN: context, gated attention, pooling, logits.
    H: [T, L] float32 features; ``keep`` [T, L] boolean applies the train
    dropout to the instance-code branch. Runs with autograd when the caller
    has it on. With ``group``, ``H`` is this rank's rows of a bag split
    over the group's ranks. Returns a dict of intermediates."""
    Hz0 = N.batch_norm_tiles(H, model.context.bn.weight,
                             model.context.bn.bias, mask=mask, group=group)
    Hm0 = N.leaky_relu(H)
    if keep is not None:
        Hm0 = N.dropout(Hm0, cfg.dropout, keep.to(Hm0.device), train=True)

    a, b = model.attention, model.buffer
    A_raw = _lin(torch.tanh(_lin(Hz0, a["lin1"])), a["lin2"])      # [T, K]
    Bterm = _lin(N.leaky_relu(_lin(Hm0, b["lin1"])), b["classifier"])  # [T, O]
    wm = model.weight_mask

    m_vec = (mask if mask is not None
             else torch.ones(A_raw.shape[0], device=A_raw.device))
    pool_args = (A_raw.float().contiguous(), Bterm.float().contiguous(),
                 m_vec.float().contiguous(), wm.float().contiguous())
    if group is None:
        Mterm, A_1T, wROIs = gated_pool.gated_attention_pool(*pool_args)
    else:
        Mterm, A_1T, wROIs = gated_pool.sharded_gated_attention_pool(
            *pool_args, group)

    # Decorrelation + mean diagnostics (reference: gbm/model.py:216-219)
    A_raw_m = A_raw * mask[:, None].to(A_raw.dtype) if mask is not None \
        else A_raw
    # with ``group`` the column norms, the Gram matrix and the mean are
    # the whole bag's, each one all-reduce
    A_2 = N.l2_normalize(A_raw_m, axis=0, group=group)            # [T, K]
    off_diag = 1.0 - torch.eye(cfg.K, dtype=A_2.dtype, device=A_2.device)
    Aterm_var = (all_reduce_sum(A_2.T @ A_2, group) * off_diag).mean()
    Aterm_mu = 0.5 * (N.masked_mean(A_raw, mask, axis=0, group=group)
                      ** 2).sum()

    logits = Mterm.reshape(1, cfg.K * cfg.O)                       # [1, K]
    return {
        "Aterm": A_1T, "wROIs": wROIs, "Bterm": Bterm, "Mterm": Mterm,
        "Aterm_mu": Aterm_mu, "Aterm_var": Aterm_var, "logits": logits,
    }


def apply_attention_mil(model, tiles, label, cfg: MILConfig = MILConfig(), *,
                        mask=None, train: bool = False, generator=None,
                        scores=None, keep=None, compute_dtype=None,
                        extractor=None, group=None):
    """Bag forward. tiles: [T, H, W, 3] NHWC; label: int; mask: optional
    [T] validity (1 = real tile). Returns the reference's 13-key dict.
    ``extractor``, a ``(cnn, tiles) -> [T, L]`` function, replaces the
    ResNet-26 as the tile embedder (the W8A8 int8 serving path,
    ``ops.quant.make_int8_extractor``); it gets the tiles detached.

    ``train=True`` subsamples the tiles and applies dropout, with the noise
    given (``scores`` [T] Gumbel draws, ``keep`` [k, L] boolean for the
    ``k = max(1, int(T * cfg.train_tile_fraction))`` kept rows) or drawn
    from ``generator`` (scores first, then keep); autograd is on and only
    ``loss`` carries a gradient. Eval runs under ``no_grad``.

    ``group`` (eval only) is the tile group of a bag split across ranks:
    ``tiles`` and ``mask`` are then this rank's rows. A training bag is
    split after its subsample, which runs over the whole bag
    (``parallel/steps.py``)."""
    if mask is None:
        mask = torch.ones(tiles.shape[0], dtype=torch.float32,
                          device=tiles.device)
    if not train:
        with torch.no_grad():
            return _bag_forward(model, tiles, label, cfg, mask, None,
                                compute_dtype, remat=False,
                                extractor=extractor, group=group)
    if group is not None:
        raise ValueError("a training bag is split across ranks after its "
                         "subsample: use parallel.steps.make_train_step")
    T = tiles.shape[0]
    need = scores is None or (keep is None and cfg.dropout > 0.0)
    if need and generator is None:
        raise ValueError("train=True needs a generator or the injected "
                         "scores and keep")
    if scores is None:
        scores = gumbel_scores(generator, T)
    tiles, mask = _subsample(tiles, mask, cfg.train_tile_fraction, scores)
    if keep is None and cfg.dropout > 0.0:
        keep = dropout_keep(generator, (tiles.shape[0], cfg.L), cfg.dropout)
    outs = _bag_forward(model, tiles, label, cfg, mask, keep, compute_dtype,
                        remat=cfg.remat, extractor=extractor)
    return {k: (v if k == "loss" else v.detach()) for k, v in outs.items()}


def _bag_forward(model, tiles, label, cfg, mask, keep, compute_dtype, *,
                 remat, extractor=None, group=None):
    # the CNN input carries no gradient, like the reference's .detach()
    # (reference: gbm/model.py:194)
    if extractor is not None:
        H = extractor(model.cnn, tiles.detach()).float()          # [T, L]
    else:
        H = resnet.apply_resnet26(model.cnn, tiles.detach(),
                                  compute_dtype=compute_dtype, stem=cfg.stem,
                                  remat=remat).float()            # [T, L]
    KLD = 0.5 * N.masked_mean((H ** 2).mean(dim=1), mask, axis=0,
                              group=group)

    pooled = attention_pool(model, H, cfg, mask=mask, keep=keep, group=group)
    logits = pooled["logits"]
    y_pred = torch.softmax(logits, dim=1)
    y_pred_hat = torch.argmax(y_pred)

    weight = (torch.tensor(cfg.class_weights, dtype=torch.float32,
                           device=logits.device)
              if cfg.class_weights is not None else None)
    label = torch.as_tensor(label, dtype=torch.int64,
                            device=logits.device).reshape(())
    ce_loss = L.smoothed_ce_loss(logits, label[None],
                                 num_classes=cfg.n_classes,
                                 smoothing=cfg.smoothing, weight=weight)
    error = 1.0 - (y_pred_hat == label).float()

    # Buffer weight-norm diagnostic (reference: gbm/model.py:246)
    l2 = torch.stack([torch.linalg.norm(model.buffer["lin1"].weight),
                      torch.linalg.norm(model.buffer["classifier"].weight)
                      ]).mean()
    return {
        "Aterm": pooled["Aterm"], "wROIs": pooled["wROIs"],
        "Bterm": pooled["Bterm"], "Mterm": pooled["Mterm"], "Fterm": H,
        "Aterm_mu": pooled["Aterm_mu"], "Aterm_var": pooled["Aterm_var"],
        "loss": ce_loss, "l2": l2, "KLD": KLD, "y_pred": y_pred,
        "y_pred_hat": y_pred_hat, "error": error,
    }


def gate_coefficients(model):
    """sigmoid(10*w) per attention map — the 'coef_a*' stats the training
    driver logs every epoch (reference: gbm/classify_combined.py:392-394)."""
    return torch.sigmoid(10.0 * model.weight_mask.detach())
