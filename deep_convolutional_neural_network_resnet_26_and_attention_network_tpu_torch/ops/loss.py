"""Label-smoothed cross-entropy with probabilistic targets.

The reference's CrossEntropyWithProbs / smooth_one_hot /
cross_entropy_with_probs trio (reference: nnBlocks.py:47-138) accumulates
per-class F.cross_entropy values; algebraically that is

    loss_i = sum_y target[i, y] * w[y] * (-log_softmax(logits_i)[y])

which is what is computed here, as in the JAX package's ``ops/loss.py``.
"""

import torch
import torch.nn.functional as F


def smooth_one_hot(labels, num_classes: int, smoothing: float = 0.0):
    """One-hot with label smoothing: target class gets 1-smoothing, the rest
    share smoothing/(classes-1). labels: int tensor [...]."""
    if not 0.0 <= smoothing < 1.0:
        raise ValueError(f"smoothing must be in [0, 1), got {smoothing}")
    confidence = 1.0 - smoothing
    off = smoothing / (num_classes - 1)
    one_hot = F.one_hot(labels.long(), num_classes).to(torch.float32)
    return one_hot * (confidence - off) + off


def cross_entropy_with_probs(logits, target_probs, weight=None,
                             reduction: str = "mean"):
    """CE where targets are probabilities; optional per-class weights.

    logits: [N, C]; target_probs: [N, C]; weight: [C] or None.
    reduction: 'none' | 'mean' | 'sum'.
    """
    if reduction not in ("none", "mean", "sum"):
        raise ValueError(
            "Keyword 'reduction' must be one of ['none', 'mean', 'sum']")
    logp = F.log_softmax(logits, dim=-1)
    w = (torch.ones(logits.shape[-1], dtype=logp.dtype, device=logp.device)
         if weight is None else weight)
    per_point = -(target_probs * w[None, :] * logp).sum(dim=-1)
    if reduction == "none":
        return per_point
    if reduction == "mean":
        return per_point.mean()
    return per_point.sum()


def smoothed_ce_loss(logits, labels, *, num_classes: int, smoothing: float,
                     weight=None, reduction: str = "mean"):
    """CrossEntropyWithProbs equivalent: smooth labels then prob-target CE."""
    target = smooth_one_hot(labels, num_classes, smoothing).to(logits.device)
    return cross_entropy_with_probs(logits, target, weight, reduction)
