"""Fused uint8-ingest ResNet stem: the CUDA kernel and its plain version.

Counterpart of ``ops/pallas_stem.py`` in the JAX package (TPU kernel
``_stem_kernel``). For uint8 tiles ``x [B, 300, 300, 3]`` and the stem
conv ``conv1`` (7x7, stride 2, pad 3, 3 -> 20 channels, with bias):

    out[b,i,j,o] = bias[o] + sum_{u,v,c} bf16(W[o,c,u,v])
                                       * bf16(alpha * x[b,2i+u-3,2j+v-3,c] + beta)

summed in float32, zero-padded, returned as the pre-activation float32
NHWC ``[B, 150, 150, 20]``. :func:`stem_u8_conv` calls the ``torch.library``
op ``OP`` (:func:`u8_stem_forward`): ``csrc/u8_stem.cu`` for CUDA tensors,
:func:`stem_u8_conv_reference` for CPU tensors, shapes alone under
``torch.export``'s fake tensors, so an exported program (``deploy.py``)
holds the stem as one node, as it holds the gated pool. A program that
holds the op loads only once this module has registered it.
:func:`accepts` says what the op computes; :func:`stem_u8_conv` raises
elsewhere.

:func:`stem_u8_pool` runs the stem with its epilogue, the cast to bf16,
LeakyReLU and the 3x3/s2/p1 max-pool, in one launch: the op ``POOL_OP``
(:func:`u8_stem_pool_forward`, ``u8_stem_pool_kernel`` of the same
source), which returns the bf16 NHWC ``[B, 75, 75, 20]`` activations that
stage 1 reads, equal bit for bit to :func:`pool_epilogue` of the first
op's output. The ResNet's uint8 entry (``models/resnet.ResNet26.forward_u8``)
takes it in bf16 and the first op then the epilogue otherwise, then its
residual trunk: the counterpart of the composition in
``tools/exp_stem_pallas.py``. ``OP`` stays, as JAX's ``stem_u8_conv``'s
counterpart and the op of bundles exported before ``POOL_OP`` existed.

The streaming path selects it by default:
``parallel.inference.make_transform_extract``, the per-chunk program of
``classify_slide_streaming``, the daemon's and the bundle's, runs the
uint8 entry with the eval transform's normalize (``alpha=2/255``,
``beta=-1``) wherever ``inference.fused_stem_applies``: a CUDA chunk the
op accepts, served at 300 px through the bf16 ResNet-26. There one launch
does the eval transform's and cuDNN's work (a float32 pass over the tiles,
a cast, cuDNN's padding of 3 channels to 8, the 7x7 convolution) and the
stem's epilogue on the same bf16 operands. The JAX package keeps its stem
opt-in. Serving only: every function here runs without autograd.
"""

import ctypes

import torch
import torch.nn.functional as F

from . import _build
from .nn import LEAKY_SLOPE

H_IN = 300            # the only tile side the kernel takes, as in JAX
OUT = H_IN // 2       # 150 output rows and columns
POOL_OUT = OUT // 2   # 75 rows and columns after the stem's max-pool
C_OUT = 20            # output channels, fixed by the kernel as in JAX
N_PAD = 24            # the kernel's GEMM width: three n8 tiles
K_PAD = 256           # its depth: 16 taps (a, b) x 16 space-to-depth channels

# launches of the CUDA kernels in this process (not of the plain versions):
# u8_stem_kernel (the op OP) and u8_stem_pool_kernel (the op POOL_OP)
LAUNCHES = 0
POOLED_LAUNCHES = 0


def accepts(conv1, x_u8) -> bool:
    """Whether the op computes the stem ``conv1`` on ``x_u8``: uint8
    ``[N >= 1, 300, 300, 3]`` tiles, and a 7x7 conv with stride 2, padding
    3 and no dilation from 3 to 20 channels, with a bias, on the tiles'
    device. It says nothing of the device's type: CPU tensors take the
    plain version."""
    w = conv1.weight
    return (x_u8.dtype == torch.uint8 and x_u8.ndim == 4
            and tuple(x_u8.shape[1:]) == (H_IN, H_IN, 3)
            and x_u8.shape[0] >= 1
            and tuple(w.shape) == (C_OUT, 3, 7, 7) and conv1.bias is not None
            and tuple(conv1.stride) == (2, 2)
            and tuple(conv1.padding) == (3, 3)
            and tuple(conv1.dilation) == (1, 1)
            and w.device == x_u8.device)


def _check(conv1, x_u8):
    if not accepts(conv1, x_u8):
        w = conv1.weight
        raise ValueError(
            f"fused stem expects uint8 [B >= 1, {H_IN}, {H_IN}, 3] tiles and "
            f"a 7x7 conv, stride 2, padding 3, no dilation, from 3 to "
            f"{C_OUT} channels with a bias, on the tiles' device; got tiles "
            f"{x_u8.dtype} {tuple(x_u8.shape)} on {x_u8.device}, conv1 "
            f"weight {tuple(w.shape)} stride {conv1.stride} padding "
            f"{conv1.padding} dilation {conv1.dilation} bias "
            f"{'none' if conv1.bias is None else tuple(conv1.bias.shape)} "
            f"on {w.device}")
    return x_u8.device


@torch.no_grad()
def stem_u8_conv_reference(conv1, x_u8, *, alpha, beta):
    """The plain version: ``F.conv2d`` in float32 of the bf16-rounded
    normalized input with the bf16-rounded weights, plus the float32 bias.

    It matches the kernel, whose products are exact in float32 too, up to
    the order of the sums (TF32 does not change it: bf16 values are exact
    in TF32). It differs from the JAX package's ``stem_u8_conv`` in one
    place: JAX rounds the conv output to bf16 before adding the bias
    (``pallas_stem.py:102, 194``); here the output stays float32."""
    return _plain(x_u8, conv1.weight, conv1.bias, alpha, beta)


def _plain(x_u8, weight, bias, alpha, beta):
    xn = (x_u8.float() * alpha + beta).to(torch.bfloat16).float()
    w = weight.to(torch.bfloat16).float()
    out = F.conv2d(xn.permute(0, 3, 1, 2), w, bias.float(), stride=2,
                   padding=3)
    return out.permute(0, 2, 3, 1)


def pool_epilogue(h):
    """The stem's epilogue on its float32 NHWC sums ``h [B, 150, 150,
    20]``: the cast to bf16, LeakyReLU, max-pool 3/2/1; returns contiguous
    bf16 NHWC ``[B, 75, 75, 20]``. Applied to the op ``OP``'s output it is
    the composition that the op ``POOL_OP`` computes in one launch."""
    h = F.leaky_relu(h.to(torch.bfloat16).permute(0, 3, 1, 2), LEAKY_SLOPE)
    return F.max_pool2d(h, 3, 2, 1).permute(0, 2, 3, 1).contiguous()


@torch.no_grad()
def stem_u8_pool_reference(conv1, x_u8, *, alpha, beta):
    """The plain version of :func:`stem_u8_pool`: :func:`pool_epilogue` of
    :func:`stem_u8_conv_reference`."""
    return pool_epilogue(_plain(x_u8, conv1.weight, conv1.bias, alpha, beta))


def _k_index(device):
    """For each (u, v, c) of the 7x7x3 window, in that order, its row in the
    kernel's K: ``(a*4 + b)*16 + rp*6 + cp*3 + c`` with ``(a, rp) = divmod(u,
    2)`` and ``(b, cp) = divmod(v, 2)``, the space-to-depth order of the JAX
    package's ``pallas_stem._w2_index_maps``. Made on ``device``, so that
    packing copies nothing from the host."""
    u, v, c = torch.meshgrid(torch.arange(7, device=device),
                             torch.arange(7, device=device),
                             torch.arange(3, device=device), indexing="ij")
    k = ((u // 2) * 4 + v // 2) * 16 + (u % 2) * 6 + (v % 2) * 3 + c
    return k.reshape(-1)


def pack_weights(weight):
    """OIHW ``[20, 3, 7, 7]`` conv weights -> the kernel's B operand
    ``[24, 256]`` bf16: row o holds output channel o's 147 taps at
    :func:`_k_index`'s rows, zeros elsewhere (the K padding and rows
    20-23, the N padding), so no padding slot multiplies a live value."""
    w2 = torch.zeros((N_PAD, K_PAD), dtype=torch.float32, device=weight.device)
    w2[:C_OUT, _k_index(weight.device)] = (
        weight.detach().float().permute(0, 2, 3, 1).reshape(C_OUT, -1))
    return w2.to(torch.bfloat16)


def _launch(entry, out, x_u8, weight, bias, *scalars):
    """Launch the C entry ``entry`` of ``csrc/u8_stem.cu`` on the current
    stream: the tiles, the packed weights, the float32 bias and ``out``,
    the tile count, the float ``scalars``; raise if the launch fails."""
    x = x_u8.contiguous()
    w = pack_weights(weight)
    b = bias.detach().float().contiguous()
    fn = getattr(_build.load("u8_stem"), entry)
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong]
                       + [ctypes.c_float] * len(scalars) + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    dev = x.device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(),
                x.shape[0], *(float(v) for v in scalars), stream)
    if rc != 0:
        raise RuntimeError(f"{entry} kernel launch failed: cudaError {rc}")
    return out


# the op's namespace names the port, as the pool's does; registered once,
# when this module is first imported
OP = "resnet26_attention_mil_torch::u8_stem_forward"


@torch.library.custom_op(OP, mutates_args=(), device_types="cpu")
def u8_stem_forward(x_u8: torch.Tensor, weight: torch.Tensor,
                    bias: torch.Tensor, alpha: float, beta: float
                    ) -> torch.Tensor:
    """The stem as a ``torch.library`` op: uint8 ``[B, 300, 300, 3]``, the
    OIHW ``[20, 3, 7, 7]`` weights and ``[20]`` bias -> float32 NHWC
    ``[B, 150, 150, 20]``. On the CPU the plain version, made contiguous
    as the kernel's output is. Its caller checks the arguments
    (:func:`stem_u8_conv`)."""
    return _plain(x_u8, weight, bias, alpha, beta).contiguous()


@u8_stem_forward.register_kernel("cuda")
def _u8_stem_forward_cuda(x_u8, weight, bias, alpha, beta):
    global LAUNCHES
    out = torch.empty((x_u8.shape[0], OUT, OUT, C_OUT), dtype=torch.float32,
                      device=x_u8.device)
    _launch("u8_stem_forward", out, x_u8, weight, bias, alpha, beta)
    LAUNCHES += 1
    return out


@u8_stem_forward.register_fake
def _u8_stem_forward_fake(x_u8, weight, bias, alpha, beta):
    return x_u8.new_empty((x_u8.shape[0], OUT, OUT, C_OUT),
                          dtype=torch.float32)


@torch.no_grad()
def stem_u8_conv(conv1, x_u8, *, alpha, beta):
    """Fused uint8 -> normalize ``x * alpha + beta`` -> conv 7x7/s2/p3 +
    bias. conv1: the port's stem ``nn.Conv2d`` (20 outputs); x_u8: uint8
    [B, 300, 300, 3]; anything :func:`accepts` refuses raises. Returns the
    pre-activation float32 NHWC [B, 150, 150, 20] (a ``channels_last``
    NCHW tensor once permuted). CUDA tensors go through the kernel (or
    raise); CPU tensors through the plain version; both through the op
    ``OP``."""
    device = _check(conv1, x_u8)
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}")
    return u8_stem_forward(x_u8, conv1.weight, conv1.bias, float(alpha),
                           float(beta))


POOL_OP = "resnet26_attention_mil_torch::u8_stem_pool_forward"


@torch.library.custom_op(POOL_OP, mutates_args=(), device_types="cpu")
def u8_stem_pool_forward(x_u8: torch.Tensor, weight: torch.Tensor,
                         bias: torch.Tensor, alpha: float, beta: float
                         ) -> torch.Tensor:
    """The stem and its epilogue as a ``torch.library`` op: the arguments
    of ``OP`` -> bf16 NHWC ``[B, 75, 75, 20]``, the max-pool 3/2/1 of
    LeakyReLU of the stem's sums cast to bf16. On the CPU the plain
    version (:func:`pool_epilogue` of the stem's). Its caller checks the
    arguments (:func:`stem_u8_pool`)."""
    return pool_epilogue(_plain(x_u8, weight, bias, alpha, beta))


@u8_stem_pool_forward.register_kernel("cuda")
def _u8_stem_pool_forward_cuda(x_u8, weight, bias, alpha, beta):
    global POOLED_LAUNCHES
    out = torch.empty((x_u8.shape[0], POOL_OUT, POOL_OUT, C_OUT),
                      dtype=torch.bfloat16, device=x_u8.device)
    _launch("u8_stem_pool_forward", out, x_u8, weight, bias, alpha, beta,
            LEAKY_SLOPE)
    POOLED_LAUNCHES += 1
    return out


@u8_stem_pool_forward.register_fake
def _u8_stem_pool_forward_fake(x_u8, weight, bias, alpha, beta):
    return x_u8.new_empty((x_u8.shape[0], POOL_OUT, POOL_OUT, C_OUT),
                          dtype=torch.bfloat16)


@torch.no_grad()
def stem_u8_pool(conv1, x_u8, *, alpha, beta):
    """:func:`stem_u8_conv` and its epilogue in one launch: the bf16
    activations the ResNet's stage 1 reads, NHWC ``[B, 75, 75, 20]`` (a
    ``channels_last`` NCHW tensor once permuted), equal bit for bit to
    :func:`pool_epilogue` of :func:`stem_u8_conv`. What :func:`accepts`
    refuses raises. Through the op ``POOL_OP``: CUDA tensors take the
    kernel, CPU tensors the plain version."""
    device = _check(conv1, x_u8)
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}")
    return u8_stem_pool_forward(x_u8, conv1.weight, conv1.bias, float(alpha),
                                float(beta))
