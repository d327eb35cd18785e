"""The collectives of the tile-sharded bag, over a ``torch.distributed``
process group.

The JAX package leaves these to XLA: GSPMD inserts a psum wherever a
reduction meets the sharded tile axis (``parallel/mesh.py``,
``parallel/shard_pool.py``). The port writes each one itself, through the
two functions below. A ``group`` of ``None`` means the bag is whole on
this rank: both functions then return their input unchanged, so the
single-card path runs exactly as it did.

This module is a leaf (it imports only torch), so the model and the kernel
wrappers can use it without importing ``parallel``.
"""

import torch
import torch.distributed as dist


def all_reduce_(x: torch.Tensor, group) -> torch.Tensor:
    """Sum ``x`` over the ranks of ``group`` in place, without autograd;
    returns ``x``."""
    if group is not None:
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    return x


class _AllReduceSum(torch.autograd.Function):
    """Sum over the ranks of a group; its backward sums the cotangents the
    same way, since every rank's copy of the sum feeds that rank's own
    downstream computation. The backward is itself this function, so the
    sum is differentiable to any order (the GAN's gradient penalty
    differentiates through a gradient that crosses it)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_(x.clone(), group)

    @staticmethod
    def backward(ctx, dy):
        return _AllReduceSum.apply(dy, ctx.group), None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over the ranks of ``group``, differentiable (a new
    tensor; ``x`` itself with ``group=None``)."""
    if group is None:
        return x
    return _AllReduceSum.apply(x, group)
