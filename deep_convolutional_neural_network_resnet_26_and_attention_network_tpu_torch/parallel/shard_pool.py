"""Explicit tile-parallel attention pooling over the mesh's tile axis.

Counterpart of ``parallel/shard_pool.py`` in the JAX package (``shard_map``
and ``psum``). The tile axis of one bag is split over the mesh's "tiles"
ranks, and every reduction over tiles that the single-card forward makes
becomes an all-reduce over the rank's tile group:

  * the context layer's masked batch-norm statistics: the count, sum
    H * m and the centred sum (H - mu)^2 * m (three all-reduces);
  * the gated pool's L1 denominator and its pooled product M = A1^T B
    (one all-reduce of the ``[K, 1+O]`` table between the pool kernel's
    partials and finish entries, ``ops/gated_pool.py``).

MIL attention pooling is a linear reduction over tiles, so this is exact
up to the order of the sums. Eval only, on the reference's eval path
(gbm/model.py:89-264).
"""

import torch
import torch.distributed as dist

from ..models import attention_mil as amil
from . import mesh as M


def make_sharded_pool(cfg: amil.MILConfig, mesh: M.Mesh):
    """``pool(model, H [t, L], mask [t]) -> {logits, Mterm, Aterm}`` for
    this rank's rows of a bag split over the tile axis of ``mesh``
    (:func:`shard_features`). ``logits`` [1, K*O] and ``Mterm`` [K, O] are
    the whole bag's; ``Aterm`` [K, T] is gathered from the tile group's
    ranks, the whole bag's in row order, as the JAX function returns it."""
    group = mesh.tiles_group

    @torch.no_grad()
    def pool(model, H, mask=None):
        if mask is None:
            mask = torch.ones(H.shape[0], dtype=torch.float32,
                              device=H.device)
        out = amil.attention_pool(model, H, cfg, mask=mask, group=group)
        shards = [torch.empty_like(out["Aterm"])
                  for _ in range(mesh.shape[M.TILES_AXIS])]
        dist.all_gather(shards, out["Aterm"].contiguous(), group=group)
        return {"logits": out["logits"], "Mterm": out["Mterm"],
                "Aterm": torch.cat(shards, dim=1)}

    return pool


def shard_features(mesh: M.Mesh, H, mask=None):
    """This rank's contiguous share of ``H`` [T, L] and ``mask`` [T] (ones
    when not given), on the rank's device. A T that the tile axis does not
    divide is padded first with zero rows of mask 0, which add nothing to
    any reduction."""
    t = mesh.shape[M.TILES_AXIS]
    T = H.shape[0]
    if mask is None:
        mask = torch.ones(T, dtype=torch.float32, device=H.device)
    pad = -T % t
    if pad:
        H = torch.cat([H, H.new_zeros((pad,) + tuple(H.shape[1:]))])
        mask = torch.cat([mask, mask.new_zeros(pad)])
    rows = mesh.rows(T + pad)
    return (H[rows].to(mesh.device).contiguous(),
            mask[rows].to(mesh.device).contiguous())
