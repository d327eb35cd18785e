"""The collectives of the tile-sharded bag, over a ``torch.distributed``
process group.

The JAX package leaves these to XLA: GSPMD inserts a psum wherever a
reduction meets the sharded tile axis (``parallel/mesh.py``,
``parallel/shard_pool.py``). The port writes each one itself, through the
functions below. A ``group`` of ``None`` means the bag is whole on this
rank, and so does a group of one rank: both functions then return their
input unchanged and issue nothing, so the single-card path runs exactly
as it did and a slides-only mesh makes no tile-group collective.

This module is a leaf (it imports only torch), so the model and the kernel
wrappers can use it without importing ``parallel``.
"""

import weakref

import torch
import torch.distributed as dist

# each group's size, asked of torch.distributed once (a host call)
_SIZES = weakref.WeakKeyDictionary()


def group_size(group) -> int:
    """The number of ranks in ``group`` (1 for ``None``)."""
    if group is None:
        return 1
    n = _SIZES.get(group)
    if n is None:
        n = _SIZES[group] = dist.get_world_size(group)
    return n


def alone(group) -> bool:
    """True when ``group`` is None or has one rank: a sum or a gather over
    it is its input, and nothing need be issued."""
    return group_size(group) == 1


def all_reduce_(x: torch.Tensor, group) -> torch.Tensor:
    """Sum ``x`` over the ranks of ``group`` in place, without autograd;
    returns ``x``."""
    if not alone(group):
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    return x


def all_gather_cat(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The ranks' ``x`` (each of one shape) concatenated in rank order
    along ``dim``, without autograd; ``x`` itself on a group of one."""
    if alone(group):
        return x
    parts = [torch.empty_like(x) for _ in range(group_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


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
    tensor; ``x`` itself on a group of one)."""
    if alone(group):
        return x
    return _AllReduceSum.apply(x, group)
