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
"""

import ctypes

import torch

from . import _build
from . import nn as N

# tiles a block of the kernel owns (csrc/gated_pool.cu: 512 threads, four
# tiles each); a bag of at most this many tiles takes one launch
POOL_RANGE = 2048

# wrapper calls that launched the CUDA forward kernel in this process, one
# or two launches each (not the plain version's calls)
LAUNCHES = 0
# wrapper calls that launched the CUDA backward kernel, one or three
# launches each
BWD_LAUNCHES = 0


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


def gated_attention_pool_backward_reference(a_raw, b, mask, weight_mask,
                                            a1t, dm=None, da1t=None,
                                            dwrois=None):
    """The closed-form VJP, ``pallas_pool.py:118-149`` line for line, given
    the forward's ``a1t``. A cotangent of ``None`` counts as zero. Returns
    ``(d_a_raw [T, K], d_b [T, O], d_weight_mask [K])``; the mask gets no
    gradient."""
    a1 = a1t.T                                   # [T, K]
    m = mask[:, None]                            # [T, 1]

    # recompute cheap forward intermediates
    act = N.softplus(a_raw)                      # [T, K]
    g1 = torch.sigmoid(-10.0 * weight_mask)      # [K]
    g0 = torch.sigmoid(10.0 * weight_mask)       # [K]
    gated = (g1 * act + g0) * m                  # [T, K], >= 0
    denom = torch.clamp_min(gated.sum(dim=0, keepdim=True), 1e-12)

    # cotangent into A1 from all three outputs
    da1 = torch.zeros_like(a1)
    if dm is not None:
        da1 = b @ dm.T                           # M = A1^T B
    if da1t is not None:
        da1 = da1 + da1t.T                       # A1T passthrough
    if dwrois is not None:
        da1 = da1 + dwrois.T * b[:, :1]          # wROIs = A1^T * B^T
    # cotangent into B
    db = a1 @ dm if dm is not None else torch.zeros_like(b)
    if dwrois is not None:
        db = db.clone()
        db[:, 0] += (dwrois.T * a1).sum(dim=1)

    # through the L1 normalization (gated >= 0 so |gated| = gated)
    dgated = (da1 - (da1 * a1).sum(dim=0, keepdim=True)) / denom

    # through the gate and softplus (mask rows contribute nothing)
    dact = dgated * g1 * m
    da_raw = dact * torch.sigmoid(a_raw)
    dg1 = (dgated * act * m).sum(dim=0)          # [K]
    dg0 = (dgated * m).sum(dim=0)                # [K]
    dwm = (dg1 * (-10.0) * g1 * (1.0 - g1)
           + dg0 * 10.0 * g0 * (1.0 - g0))
    return da_raw, db, dwm


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


def _kernel(entry="gated_pool_forward"):
    """The C entry ``gated_pool_forward`` (8 pointers, 5 ints, the stream)
    or ``gated_pool_backward`` (12 pointers, 5 ints, the stream)."""
    fn = getattr(_build.load("gated_pool"), entry)
    if fn.argtypes is None:
        n_ptr = 8 if entry == "gated_pool_forward" else 12
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


def _launch(a_raw, b, mask, weight_mask):
    global LAUNCHES
    _require_f32_contiguous(a_raw=a_raw, b=b, mask=mask,
                            weight_mask=weight_mask)
    t, k = a_raw.shape
    o = b.shape[1]
    _limits(t, k, o)
    nblk, tiles = pool_partition(t)
    fn = _kernel()
    dev = a_raw.device
    m = torch.empty((k, o), dtype=torch.float32, device=dev)
    a1t = torch.empty((k, t), dtype=torch.float32, device=dev)
    wrois = torch.empty((k, t), dtype=torch.float32, device=dev)
    # the ranges' partial sums, for the second launch; none with one range
    scratch = (torch.empty((k, nblk, 1 + o), dtype=torch.float32, device=dev)
               if nblk > 1 else None)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(a_raw.data_ptr(), b.data_ptr(), mask.data_ptr(),
                weight_mask.data_ptr(), m.data_ptr(), a1t.data_ptr(),
                wrois.data_ptr(), _ptr(scratch), t, k, o, tiles, nblk,
                stream)
    if rc != 0:
        raise RuntimeError(f"gated_pool kernel launch failed: cudaError {rc}")
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
    t, k = a_raw.shape
    o = b.shape[1]
    _limits(t, k, o)
    nblk, tiles = pool_partition(t)
    fn = _kernel("gated_pool_backward")
    dev = a_raw.device
    da_raw = torch.empty_like(a_raw)
    db = torch.empty_like(b)
    dw = torch.empty_like(weight_mask)
    # two [K, nblk, 2] tables of the ranges' partial sums (denom and
    # sum da1 * A1; the two dw sums); none with one range
    scratch = (torch.empty((2, k, nblk, 2), dtype=torch.float32, device=dev)
               if nblk > 1 else None)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(a_raw.data_ptr(), b.data_ptr(), mask.data_ptr(),
                weight_mask.data_ptr(), a1t.data_ptr(), _ptr(dm), _ptr(da1t),
                _ptr(dwrois), da_raw.data_ptr(), db.data_ptr(), dw.data_ptr(),
                _ptr(scratch), t, k, o, tiles, nblk, stream)
    if rc != 0:
        raise RuntimeError(
            f"gated_pool backward kernel launch failed: cudaError {rc}")
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
