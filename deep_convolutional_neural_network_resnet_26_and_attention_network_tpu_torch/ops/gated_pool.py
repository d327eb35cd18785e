"""Fused gated-attention MIL pooling: the CUDA kernels and their plain versions.

Counterpart of ``ops/pallas_pool.py`` in the JAX package (TPU kernel
``_pool_kernel`` and its closed-form custom VJP ``_pool_bwd``). For
``a_raw [T, K]``, ``b [T, O]``, ``mask [T]`` and the gate
``weight_mask [K]``:

    act    = softplus(a_raw)
    gated  = (sigmoid(-10 w) * act + sigmoid(10 w)) * mask
    A1     = gated / max(sum_T |gated|, 1e-12)
    returns (M = A1^T b [K, O], A1^T [K, T], wROIs = A1^T * b[:, 0] [K, T])

:func:`gated_attention_pool` is a ``torch.autograd.Function``: for CUDA
tensors its forward and backward launch ``csrc/gated_pool.cu``, for CPU
tensors they take :func:`gated_attention_pool_reference` and
:func:`gated_attention_pool_backward_reference`. The kernels have no cap on
T: :func:`pool_partition` cuts the tile axis into ranges, one block per
(range, map), and further launches finish once the ranges' partial sums
are in. The mask gets no gradient. A cotangent that autograd does not
materialise (an output that feeds no loss, such as the detached ``A1^T``
and ``wROIs`` of the training path) reaches the backward as ``None``, and
the kernel skips it instead of reading a tensor of zeros.

The forward is the ``torch.library`` op ``OP`` (:func:`gated_pool_forward`:
the kernel on CUDA, the plain version on the CPU, shapes alone under
``torch.export``'s fake tensors), so an exported program (``deploy.py``)
holds the pool as one node and runs the kernel when it is called. A
program that holds the op loads only once this module has registered it.
The autograd Function stays around the op: the op's own autograd would
hand the backward zero tensors for unused outputs.

Split at the reduction (ROADMAP B.1 (b)): when the tile axis of a bag is
split across ranks, :func:`sharded_gated_attention_pool` computes each
shard's sums over T (:func:`pool_forward_partials`), all-reduces the
``[K, 1+O]`` table across the tile group and finishes from the totals
(:func:`pool_forward_finish`); its backward does the same with the
``[K, 2]`` table (:func:`pool_backward_partials`,
:func:`pool_backward_finish`). Each of the four is the CUDA entry of the
same name on the card and its plain version on the CPU.
"""

import ctypes

import torch

from . import _build
from . import nn as N
from .collectives import all_reduce_

# tiles a block of the kernel owns (csrc/gated_pool.cu: 512 threads, four
# tiles each); a bag of at most this many tiles takes one launch
POOL_RANGE = 2048

# wrapper calls that launched the CUDA forward kernel in this process, one
# or two launches each (not the plain version's calls)
LAUNCHES = 0
# wrapper calls that launched the CUDA backward kernel, one or three
# launches each
BWD_LAUNCHES = 0
# wrapper calls that launched the split entries (one shard of a
# tile-sharded bag): the forward's partials (one or two launches) and
# finish (one), the backward's partials (one or two) and finish (two)
PARTIAL_LAUNCHES = 0
FINISH_LAUNCHES = 0
BWD_PARTIAL_LAUNCHES = 0
BWD_FINISH_LAUNCHES = 0


def pool_partition(t):
    """The kernel's cut of ``t`` tiles: ``(nblk, range)``, block j owning
    tiles ``[j * range, min(t, (j + 1) * range))``. ``nblk == 1`` (one
    launch, no scratch) exactly when ``t <= POOL_RANGE``."""
    if t < 1:
        raise ValueError("need T >= 1 tiles")
    return -(-t // POOL_RANGE), POOL_RANGE


def gated_attention_pool_reference(a_raw, b, mask, weight_mask):
    """The unfused chain in plain PyTorch (the JAX package's non-Pallas
    path, ``attention_mil.py:158-176``)."""
    act = N.softplus(a_raw)
    gated = (torch.sigmoid(-10.0 * weight_mask) * act
             + torch.sigmoid(10.0 * weight_mask))
    gated = gated * mask[:, None]
    a1t = N.l1_normalize(gated, axis=0).T
    return a1t @ b, a1t, a1t * b[:, 0][None, :]


def _gated(a_raw, mask, weight_mask):
    """``(act, g1, g0, gated)``: softplus(A_raw), the two gate sigmoids and
    the masked gate, [T, K]."""
    act = N.softplus(a_raw)                      # [T, K]
    g1 = torch.sigmoid(-10.0 * weight_mask)      # [K]
    g0 = torch.sigmoid(10.0 * weight_mask)       # [K]
    return act, g1, g0, (g1 * act + g0) * mask[:, None]


def _da1(like, b, dm, da1t, dwrois):
    """The cotangent into A1 [T, K] (the shape of ``like``) from all three
    outputs (``None`` is a zero cotangent)."""
    da1 = torch.zeros_like(like)
    if dm is not None:
        da1 = b @ dm.T                           # M = A1^T B
    if da1t is not None:
        da1 = da1 + da1t.T                       # A1T passthrough
    if dwrois is not None:
        da1 = da1 + dwrois.T * b[:, :1]          # wROIs = A1^T * B^T
    return da1


def _db(a1, b, dm, dwrois):
    """The cotangent into B [T, O]: A1 dM, plus sum_K dwROIs^T * A1 in
    column 0."""
    db = a1 @ dm if dm is not None else torch.zeros_like(b)
    if dwrois is not None:
        db = db.clone()
        db[:, 0] += (dwrois.T * a1).sum(dim=1)
    return db


def _through_gate(a_raw, mask, act, g1, g0, dgated):
    """dA_raw [T, K] and dw [K] from dgated; mask rows contribute
    nothing."""
    m = mask[:, None]
    dact = dgated * g1 * m
    da_raw = dact * torch.sigmoid(a_raw)
    dg1 = (dgated * act * m).sum(dim=0)          # [K]
    dg0 = (dgated * m).sum(dim=0)                # [K]
    dwm = (dg1 * (-10.0) * g1 * (1.0 - g1)
           + dg0 * 10.0 * g0 * (1.0 - g0))
    return da_raw, dwm


def gated_attention_pool_backward_reference(a_raw, b, mask, weight_mask,
                                            a1t, dm=None, da1t=None,
                                            dwrois=None):
    """The closed-form VJP, ``pallas_pool.py:118-149`` line for line, given
    the forward's ``a1t``. A cotangent of ``None`` counts as zero. Returns
    ``(d_a_raw [T, K], d_b [T, O], d_weight_mask [K])``; the mask gets no
    gradient."""
    a1 = a1t.T                                   # [T, K]
    # recompute cheap forward intermediates
    act, g1, g0, gated = _gated(a_raw, mask, weight_mask)
    denom = torch.clamp_min(gated.sum(dim=0, keepdim=True), 1e-12)
    da1 = _da1(a1, b, dm, da1t, dwrois)
    db = _db(a1, b, dm, dwrois)
    # through the L1 normalization (gated >= 0 so |gated| = gated)
    dgated = (da1 - (da1 * a1).sum(dim=0, keepdim=True)) / denom
    da_raw, dwm = _through_gate(a_raw, mask, act, g1, g0, dgated)
    return da_raw, db, dwm


def pool_forward_partials_reference(a_raw, b, mask, weight_mask):
    """A shard's sums over its T rows, ``[K, 1+O]``: column 0 sum |gated|,
    column 1 + o sum gated * B[:, o]."""
    gated = _gated(a_raw, mask, weight_mask)[3]
    return torch.cat([gated.abs().sum(dim=0)[:, None], gated.T @ b], dim=1)


def pool_forward_finish_reference(a_raw, b, mask, weight_mask, totals):
    """``(M [K, O], A1^T [K, T], wROIs [K, T])`` of a shard from the
    all-reduced ``totals`` [K, 1+O]."""
    denom = torch.clamp_min(totals[:, :1], 1e-12)            # [K, 1]
    a1t = _gated(a_raw, mask, weight_mask)[3].T / denom
    return totals[:, 1:] / denom, a1t, a1t * b[:, 0][None, :]


def pool_backward_partials_reference(a_raw, b, mask, weight_mask, a1t,
                                     dm=None, da1t=None, dwrois=None):
    """A shard's backward sums, ``[K, 2]`` (sum gated, sum da1 * A1), and
    its dB [T, O], which needs no sum over T."""
    a1 = a1t.T
    gated = _gated(a_raw, mask, weight_mask)[3]
    da1 = _da1(a1, b, dm, da1t, dwrois)
    stats = torch.stack([gated.sum(dim=0), (da1 * a1).sum(dim=0)], dim=1)
    return stats, _db(a1, b, dm, dwrois)


def pool_backward_finish_reference(a_raw, b, mask, weight_mask, totals,
                                   dm=None, da1t=None, dwrois=None):
    """A shard's dA_raw [T, K] and its part of dw [K] from the all-reduced
    ``totals`` [K, 2] (da1 needs no A1)."""
    act, g1, g0, gated = _gated(a_raw, mask, weight_mask)
    denom = torch.clamp_min(totals[:, 0], 1e-12)
    da1 = _da1(gated, b, dm, da1t, dwrois)
    dgated = (da1 - totals[:, 1]) / denom
    return _through_gate(a_raw, mask, act, g1, g0, dgated)


def _check(a_raw, b, mask, weight_mask):
    args = {"a_raw": a_raw, "b": b, "mask": mask, "weight_mask": weight_mask}
    devices = {t.device for t in args.values()}
    if len(devices) != 1:
        raise ValueError(f"inputs lie on several devices: {sorted(map(str, devices))}")
    if a_raw.ndim != 2 or b.ndim != 2 or mask.ndim != 1 or weight_mask.ndim != 1:
        raise ValueError("expected a_raw [T, K], b [T, O], mask [T], "
                         "weight_mask [K]")
    t, k = a_raw.shape
    if b.shape[0] != t or mask.shape[0] != t or weight_mask.shape[0] != k:
        raise ValueError(
            f"shape mismatch: a_raw {tuple(a_raw.shape)}, b {tuple(b.shape)}, "
            f"mask {tuple(mask.shape)}, weight_mask {tuple(weight_mask.shape)}")
    if t < 1 or b.shape[1] < 1:
        raise ValueError("need T >= 1 tiles and O >= 1 outputs")
    device = devices.pop()
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}")
    return device


# the C entries of csrc/gated_pool.cu: their pointer arguments, each
# followed by 5 ints (T, K, O, range, nblk) and the stream
ENTRIES = {"gated_pool_forward": 8, "gated_pool_backward": 12,
           "gated_pool_forward_partials": 6, "gated_pool_forward_finish": 8,
           "gated_pool_backward_partials": 11,
           "gated_pool_backward_finish": 11}


def _kernel(entry="gated_pool_forward"):
    """The C entry ``entry`` of the pool's library, its ``ctypes``
    signature set (``ENTRIES``)."""
    fn = getattr(_build.load("gated_pool"), entry)
    if fn.argtypes is None:
        n_ptr = ENTRIES[entry]
        fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 5
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _require_f32_contiguous(**tensors):
    for name, x in tensors.items():
        if x is None:
            continue
        if x.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _limits(t, k, o):
    if t >= 2**31 // max(k, o):
        raise ValueError(f"T={t} too large for 32-bit row offsets")
    if k >= 2**16:
        raise ValueError(f"K={k} attention maps exceed the kernel's grid")


def _ptr(x):
    return None if x is None else x.data_ptr()


def _call(entry, *ptrs_and_shape, device):
    """Launch ``entry`` on ``device``'s current stream; raise on a failed
    launch."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = _kernel(entry)(*ptrs_and_shape, stream)
    if rc != 0:
        raise RuntimeError(f"{entry} launch failed: cudaError {rc}")


def _shape(a_raw, b):
    t, k = a_raw.shape
    o = b.shape[1]
    _limits(t, k, o)
    nblk, tiles = pool_partition(t)
    return t, k, o, tiles, nblk


def _empty(device, *shape):
    return torch.empty(shape, dtype=torch.float32, device=device)


def _launch(a_raw, b, mask, weight_mask):
    global LAUNCHES
    _require_f32_contiguous(a_raw=a_raw, b=b, mask=mask,
                            weight_mask=weight_mask)
    t, k, o, tiles, nblk = _shape(a_raw, b)
    dev = a_raw.device
    m, a1t, wrois = _empty(dev, k, o), _empty(dev, k, t), _empty(dev, k, t)
    # the ranges' partial sums, for the second launch; none with one range
    scratch = _empty(dev, k, nblk, 1 + o) if nblk > 1 else None
    _call("gated_pool_forward", a_raw.data_ptr(), b.data_ptr(),
          mask.data_ptr(), weight_mask.data_ptr(), m.data_ptr(),
          a1t.data_ptr(), wrois.data_ptr(), _ptr(scratch), t, k, o, tiles,
          nblk, device=dev)
    LAUNCHES += 1
    return m, a1t, wrois


# the op's namespace names the port; registered once, when this module is
# first imported
OP = "resnet26_attention_mil_torch::gated_pool_forward"


@torch.library.custom_op(OP, mutates_args=(), device_types="cpu")
def gated_pool_forward(a_raw: torch.Tensor, b: torch.Tensor,
                       mask: torch.Tensor, weight_mask: torch.Tensor
                       ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The pool's forward as a ``torch.library`` op: ``(M [K, O], A1^T
    [K, T], wROIs [K, T])``. On the CPU the plain version, made
    contiguous as the kernel's outputs are."""
    return tuple(x.contiguous() for x in gated_attention_pool_reference(
        a_raw, b, mask, weight_mask))


@gated_pool_forward.register_kernel("cuda")
def _gated_pool_forward_cuda(a_raw, b, mask, weight_mask):
    return _launch(a_raw, b, mask, weight_mask)


@gated_pool_forward.register_fake
def _gated_pool_forward_fake(a_raw, b, mask, weight_mask):
    t, k = a_raw.shape
    return (a_raw.new_empty((k, b.shape[1])), a_raw.new_empty((k, t)),
            a_raw.new_empty((k, t)))


def _launch_backward(a_raw, b, mask, weight_mask, a1t, dm, da1t, dwrois):
    global BWD_LAUNCHES
    _require_f32_contiguous(a_raw=a_raw, b=b, mask=mask,
                            weight_mask=weight_mask, a1t=a1t, dm=dm,
                            da1t=da1t, dwrois=dwrois)
    t, k, o, tiles, nblk = _shape(a_raw, b)
    dev = a_raw.device
    da_raw, db = torch.empty_like(a_raw), torch.empty_like(b)
    dw = torch.empty_like(weight_mask)
    # two [K, nblk, 2] tables of the ranges' partial sums (denom and
    # sum da1 * A1; the two dw sums); none with one range
    scratch = _empty(dev, 2, k, nblk, 2) if nblk > 1 else None
    _call("gated_pool_backward", a_raw.data_ptr(), b.data_ptr(),
          mask.data_ptr(), weight_mask.data_ptr(), a1t.data_ptr(), _ptr(dm),
          _ptr(da1t), _ptr(dwrois), da_raw.data_ptr(), db.data_ptr(),
          dw.data_ptr(), _ptr(scratch), t, k, o, tiles, nblk, device=dev)
    BWD_LAUNCHES += 1
    return da_raw, db, dw


def gated_attention_pool_backward(a_raw, b, mask, weight_mask, a1t, dm=None,
                                  da1t=None, dwrois=None):
    """The pool's VJP: CUDA tensors go through the backward kernel (or
    raise), CPU tensors through
    :func:`gated_attention_pool_backward_reference`. Returns
    ``(d_a_raw, d_b, d_weight_mask)``."""
    if a_raw.device.type == "cuda":
        return _launch_backward(a_raw, b, mask, weight_mask, a1t, dm, da1t,
                                dwrois)
    return gated_attention_pool_backward_reference(
        a_raw, b, mask, weight_mask, a1t, dm, da1t, dwrois)


class _GatedPool(torch.autograd.Function):
    """Forward and closed-form backward of the pool, like the JAX
    package's ``jax.custom_vjp``. Grads are not materialised, so an unused
    output's cotangent arrives as ``None`` and costs nothing."""

    @staticmethod
    def forward(ctx, a_raw, b, mask, weight_mask):
        ctx.set_materialize_grads(False)
        m, a1t, wrois = gated_pool_forward(a_raw, b, mask, weight_mask)
        ctx.save_for_backward(a_raw, b, mask, weight_mask, a1t)
        return m, a1t, wrois

    @staticmethod
    def backward(ctx, dm, da1t, dwrois):
        a_raw, b, mask, weight_mask, a1t = ctx.saved_tensors
        cots = [None if c is None else c.contiguous()
                for c in (dm, da1t, dwrois)]
        da_raw, db, dw = gated_attention_pool_backward(
            a_raw, b, mask, weight_mask, a1t, *cots)
        return da_raw, db, None, dw


def gated_attention_pool(a_raw, b, mask, weight_mask):
    """Fused pooling. a_raw: [T, K]; b: [T, O]; mask: [T]; weight_mask: [K].

    Returns (M [K, O], A1T [K, T], wROIs [K, T]). CUDA tensors go through
    the kernels (or raise); CPU tensors through the plain versions.
    Differentiable in ``a_raw``, ``b`` and ``weight_mask``."""
    _check(a_raw, b, mask, weight_mask)
    return _GatedPool.apply(a_raw, b, mask, weight_mask)


# ------------------------------------------------- split at the reduction

def pool_forward_partials(a_raw, b, mask, weight_mask):
    """A shard's ``[K, 1+O]`` sums over its rows (sum |gated|, sum
    gated * B): ``gated_pool_forward_partials`` on the card, its plain
    version on the CPU."""
    global PARTIAL_LAUNCHES
    device = _check(a_raw, b, mask, weight_mask)
    if device.type != "cuda":
        return pool_forward_partials_reference(a_raw, b, mask, weight_mask)
    _require_f32_contiguous(a_raw=a_raw, b=b, mask=mask,
                            weight_mask=weight_mask)
    t, k, o, tiles, nblk = _shape(a_raw, b)
    out = _empty(device, k, 1 + o)
    scratch = _empty(device, k, nblk, 1 + o) if nblk > 1 else None
    _call("gated_pool_forward_partials", a_raw.data_ptr(), b.data_ptr(),
          mask.data_ptr(), weight_mask.data_ptr(), out.data_ptr(),
          _ptr(scratch), t, k, o, tiles, nblk, device=device)
    PARTIAL_LAUNCHES += 1
    return out


def pool_forward_finish(a_raw, b, mask, weight_mask, totals):
    """``(M [K, O], A1^T [K, T], wROIs [K, T])`` of a shard from the
    all-reduced ``totals`` [K, 1+O]: ``gated_pool_forward_finish`` on the
    card, its plain version on the CPU."""
    global FINISH_LAUNCHES
    device = _check(a_raw, b, mask, weight_mask)
    if device.type != "cuda":
        return pool_forward_finish_reference(a_raw, b, mask, weight_mask,
                                             totals)
    _require_f32_contiguous(a_raw=a_raw, b=b, mask=mask,
                            weight_mask=weight_mask, totals=totals)
    t, k, o, tiles, nblk = _shape(a_raw, b)
    m, a1t, wrois = _empty(device, k, o), _empty(device, k, t), \
        _empty(device, k, t)
    _call("gated_pool_forward_finish", a_raw.data_ptr(), b.data_ptr(),
          mask.data_ptr(), weight_mask.data_ptr(), totals.data_ptr(),
          m.data_ptr(), a1t.data_ptr(), wrois.data_ptr(), t, k, o, tiles,
          nblk, device=device)
    FINISH_LAUNCHES += 1
    return m, a1t, wrois


def pool_backward_partials(a_raw, b, mask, weight_mask, a1t, dm=None,
                           da1t=None, dwrois=None):
    """A shard's backward sums ``[K, 2]`` (sum gated, sum da1 * A1) and its
    dB: ``gated_pool_backward_partials`` on the card, its plain version on
    the CPU. ``dm`` is the cotangent of the replicated M (the same on
    every rank), ``da1t`` and ``dwrois`` this shard's columns."""
    global BWD_PARTIAL_LAUNCHES
    device = _check(a_raw, b, mask, weight_mask)
    if device.type != "cuda":
        return pool_backward_partials_reference(a_raw, b, mask, weight_mask,
                                                a1t, dm, da1t, dwrois)
    _require_f32_contiguous(a_raw=a_raw, b=b, mask=mask,
                            weight_mask=weight_mask, a1t=a1t, dm=dm,
                            da1t=da1t, dwrois=dwrois)
    t, k, o, tiles, nblk = _shape(a_raw, b)
    stats, db = _empty(device, k, 2), torch.empty_like(b)
    scratch = _empty(device, k, nblk, 2) if nblk > 1 else None
    _call("gated_pool_backward_partials", a_raw.data_ptr(), b.data_ptr(),
          mask.data_ptr(), weight_mask.data_ptr(), a1t.data_ptr(), _ptr(dm),
          _ptr(da1t), _ptr(dwrois), db.data_ptr(), stats.data_ptr(),
          _ptr(scratch), t, k, o, tiles, nblk, device=device)
    BWD_PARTIAL_LAUNCHES += 1
    return stats, db


def pool_backward_finish(a_raw, b, mask, weight_mask, totals, dm=None,
                         da1t=None, dwrois=None):
    """A shard's dA_raw and its part of dw from the all-reduced ``totals``
    [K, 2]: ``gated_pool_backward_finish`` on the card, its plain version
    on the CPU."""
    global BWD_FINISH_LAUNCHES
    device = _check(a_raw, b, mask, weight_mask)
    if device.type != "cuda":
        return pool_backward_finish_reference(a_raw, b, mask, weight_mask,
                                              totals, dm, da1t, dwrois)
    _require_f32_contiguous(a_raw=a_raw, b=b, mask=mask,
                            weight_mask=weight_mask, totals=totals, dm=dm,
                            da1t=da1t, dwrois=dwrois)
    t, k, o, tiles, nblk = _shape(a_raw, b)
    da_raw, dw = torch.empty_like(a_raw), torch.empty_like(weight_mask)
    dw_scratch = _empty(device, k, nblk, 2)
    _call("gated_pool_backward_finish", a_raw.data_ptr(), b.data_ptr(),
          mask.data_ptr(), weight_mask.data_ptr(), _ptr(dm), _ptr(da1t),
          _ptr(dwrois), totals.data_ptr(), da_raw.data_ptr(), dw.data_ptr(),
          dw_scratch.data_ptr(), t, k, o, tiles, nblk, device=device)
    BWD_FINISH_LAUNCHES += 1
    return da_raw, dw


class _ShardedGatedPool(torch.autograd.Function):
    """The pool of one shard of a bag whose tile axis is split over
    ``group``: partials, all-reduce, finish; the backward in the same
    order. M is replicated across the group and everything downstream of
    it is computed alike on every rank, so the cotangent ``dM`` that
    arrives is already the whole of it on every rank: it is not summed
    again (that would count it once per rank). ``dA1T`` and ``dwROIs`` are
    this shard's own. The ``dw`` returned is this shard's part; the
    parameter all-reduce sums the parts."""

    @staticmethod
    def forward(ctx, a_raw, b, mask, weight_mask, group):
        ctx.set_materialize_grads(False)
        ctx.group = group
        totals = all_reduce_(pool_forward_partials(a_raw, b, mask,
                                                   weight_mask), group)
        m, a1t, wrois = pool_forward_finish(a_raw, b, mask, weight_mask,
                                            totals)
        ctx.save_for_backward(a_raw, b, mask, weight_mask, a1t)
        return m, a1t, wrois

    @staticmethod
    def backward(ctx, dm, da1t, dwrois):
        a_raw, b, mask, weight_mask, a1t = ctx.saved_tensors
        cots = [None if c is None else c.contiguous()
                for c in (dm, da1t, dwrois)]
        stats, db = pool_backward_partials(a_raw, b, mask, weight_mask, a1t,
                                           *cots)
        all_reduce_(stats, ctx.group)
        da_raw, dw = pool_backward_finish(a_raw, b, mask, weight_mask, stats,
                                          *cots)
        return da_raw, db, None, dw, None


def sharded_gated_attention_pool(a_raw, b, mask, weight_mask, group=None):
    """The pool of this rank's shard of a bag whose tile axis is split over
    the process group ``group``: ``(M [K, O]`` (the whole bag's, on every
    rank), ``A1^T [K, t]``, ``wROIs [K, t])`` for the shard's ``t`` rows.
    Two all-reduces of a few floats each: one in the forward, one in the
    backward. With ``group=None`` (or a group of one rank) it is
    :func:`gated_attention_pool` through the split entries: on the card
    the same outputs bit for bit."""
    _check(a_raw, b, mask, weight_mask)
    return _ShardedGatedPool.apply(a_raw, b, mask, weight_mask, group)
