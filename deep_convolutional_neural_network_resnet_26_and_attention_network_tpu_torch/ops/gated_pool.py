"""Fused gated-attention MIL pooling: the CUDA kernel and its plain version.

Counterpart of ``ops/pallas_pool.py`` in the JAX package (TPU kernel
``_pool_kernel``). For ``a_raw [T, K]``, ``b [T, O]``, ``mask [T]`` and the
gate ``weight_mask [K]``:

    act    = softplus(a_raw)
    gated  = (sigmoid(-10 w) * act + sigmoid(10 w)) * mask
    A1     = gated / max(sum_T |gated|, 1e-12)
    returns (M = A1^T b [K, O], A1^T [K, T], wROIs = A1^T * b[:, 0] [K, T])

:func:`gated_attention_pool` launches ``csrc/gated_pool.cu`` for CUDA
tensors and takes :func:`gated_attention_pool_reference` only for CPU
tensors. The kernel has no cap on T: :func:`pool_partition` cuts the tile
axis into ranges, one block per (range, map), and a second launch
finishes once the ranges' partial sums are in. It is forward-only: the closed-form
backward (``pallas_pool.py:118-149``) arrives with the training slice, so
inputs that require grad are refused.
"""

import ctypes

import torch

from . import _build
from . import nn as N

# tiles a block of the kernel owns (csrc/gated_pool.cu: 512 threads, four
# tiles each); a bag of at most this many tiles takes one launch
POOL_RANGE = 2048

# wrapper calls that launched the CUDA kernel in this process, one or two
# launches each (not the plain version's calls)
LAUNCHES = 0


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


def _check(a_raw, b, mask, weight_mask):
    args = {"a_raw": a_raw, "b": b, "mask": mask, "weight_mask": weight_mask}
    if torch.is_grad_enabled() and any(t.requires_grad for t in args.values()):
        raise RuntimeError("gated_attention_pool is forward-only: an input "
                           "requires grad")
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
    return devices.pop()


def _kernel():
    fn = _build.load("gated_pool").gated_pool_forward
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 5
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _launch(a_raw, b, mask, weight_mask):
    global LAUNCHES
    for name, x in (("a_raw", a_raw), ("b", b), ("mask", mask),
                    ("weight_mask", weight_mask)):
        if x.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    t, k = a_raw.shape
    o = b.shape[1]
    if t >= 2**31 // max(k, o):
        raise ValueError(f"T={t} too large for 32-bit row offsets")
    if k >= 2**16:
        raise ValueError(f"K={k} attention maps exceed the kernel's grid")
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
                wrois.data_ptr(),
                None if scratch is None else scratch.data_ptr(), t, k, o,
                tiles, nblk, stream)
    if rc != 0:
        raise RuntimeError(f"gated_pool kernel launch failed: cudaError {rc}")
    LAUNCHES += 1
    return m, a1t, wrois


def gated_attention_pool(a_raw, b, mask, weight_mask):
    """Fused pooling. a_raw: [T, K]; b: [T, O]; mask: [T]; weight_mask: [K].

    Returns (M [K, O], A1T [K, T], wROIs [K, T]). CUDA tensors go through
    the kernel (or raise); CPU tensors through the plain version."""
    device = _check(a_raw, b, mask, weight_mask)
    if device.type == "cuda":
        return _launch(a_raw, b, mask, weight_mask)
    if device.type == "cpu":
        return gated_attention_pool_reference(a_raw, b, mask, weight_mask)
    raise ValueError(f"unsupported device {device}")
