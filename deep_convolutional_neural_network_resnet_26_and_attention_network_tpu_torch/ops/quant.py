"""Post-training W8A8 int8 quantization of the ResNet-26 extractor.

Counterpart of ``ops/quant.py`` in the JAX package, an opt-in serving path
(the reference has no quantization). Scheme, as there (standard symmetric
PTQ):

  * weights: per-output-channel int8, ``sw[co] = max|w[co, ...]| / 127``
  * activations: per-tensor static scales from a calibration batch
    (``calibrate_resnet26``): the absmax of each conv's INPUT, so layer N's
    output is quantized against layer N+1's scale
  * conv: int8 x int8 -> int32 accumulation, dequantized by ``sx * sw[co]``,
    bias added in f32, LeakyReLU and residual adds in f32
  * a block's ``conv1`` and ``downsample`` read the SAME input tensor and
    share one activation scale

The qparams and scales keep the JAX package's nested-dict structure and
names; conv weights are OIHW here (HWIO there), the fc weight keeps the
``[in, out]`` layout of both packages' ``linear``. Activations run NCHW
(the ``channels_last`` view of the NHWC tiles). ``utils/interop.py``
carries the JAX package's qparams and scales over.

``_conv_i8`` has the JAX package's three lowerings, which give the same
int32 accumulations bit for bit:

  * ``"conv"``: ``F.conv2d`` in float32 on the int8 grid (PyTorch has no
    int8 convolution). Every partial sum is an integer below
    127 * 127 * 720 < 2**24, so float32 holds it exactly; TF32 is turned
    off around the call, since its 10-bit mantissa would not;
  * ``"dot"``: explicit im2col in (dy, dx, cin) order, then one
    ``torch._int_mm`` (int8 operands, int32 result);
  * ``"shift"``: one thin ``torch._int_mm`` per (dy, dx) tap, summed in
    int32, with no patch buffer.

``torch._int_mm`` on CUDA wants more than 16 rows and K and N multiples of
8 (the model's K are 147, 180, 360, 540, 720 and its N 20 to 80), so the
operands are zero-padded to that, which changes no sum. The fc is an
int32 product in the JAX package; here it is a float32 product with TF32
off, exact for the same reason (127 * 127 * 80 < 2**24).

Quantization error compounds through 26 normalization-free layers, so
measure the slide-probability drift on YOUR checkpoint before serving.
"""

import contextlib

import torch
import torch.nn.functional as F

from ..data import transforms
from . import nn as N

_QMAX = 127.0
IMPLS = ("conv", "dot", "shift")


@contextlib.contextmanager
def _exact_f32():
    """TF32 off for cuDNN convolutions and cuBLAS matmuls inside the block
    (the previous settings come back after it)."""
    conv, mm = (torch.backends.cudnn.allow_tf32,
                torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = conv
        torch.backends.cuda.matmul.allow_tf32 = mm


def _scale_of(x, axis=None):
    """Symmetric absmax scale: max|x| / 127, floored away from zero."""
    a = x.float().abs()
    s = (a.amax() if axis is None else a.amax(dim=axis)) / _QMAX
    return torch.clamp_min(s, 1e-8)


def _quant(x, s):
    """float32 tensor -> int8 on the grid of the per-tensor scale ``s``
    (divided by, as the JAX package does, not multiplied by 1/s)."""
    q = torch.round(x.float() / s)
    return q.clamp(-_QMAX, _QMAX).to(torch.int8)


def _quant_w(w, out_axis: int = 0):
    """Per-output-channel weight quantization along ``out_axis``."""
    axes = tuple(a for a in range(w.ndim) if a != out_axis)
    sw = _scale_of(w, axis=axes)
    shape = [1] * w.ndim
    shape[out_axis] = -1
    q = torch.round(w.detach().float() / sw.reshape(shape))
    return q.clamp(-_QMAX, _QMAX).to(torch.int8), sw


def _conv_site(conv):
    """An ``nn.Conv2d`` -> {"wq": int8 OIHW, "sw": [cout], "b" if biased}."""
    wq, sw = _quant_w(conv.weight)
    out = {"wq": wq, "sw": sw}
    if conv.bias is not None:
        out["b"] = conv.bias.detach().float()
    return out


@torch.no_grad()
def quantize_resnet26(cnn):
    """A ``ResNet26`` -> its int8 qparams (same topology, on its device).

    Each conv site becomes {"wq": int8, "sw": f32 [cout], "b": f32}; the
    fc becomes {"wq": int8 [in, out], "sw"} (no bias in the reference
    head, gbm/model.py:32)."""
    q = {"conv1": _conv_site(cnn.conv1), "stages": []}
    for stage in cnn.stages():
        qs = []
        for block in stage:
            qb = {"conv1": _conv_site(block.conv1),
                  "conv2": _conv_site(block.conv2)}
            if block.downsample is not None:
                qb["downsample"] = _conv_site(block.downsample[0])
            qs.append(qb)
        q["stages"].append(qs)
    wq, sw = _quant_w(cnn.fc.weight.t(), out_axis=1)
    q["fc"] = {"wq": wq, "sw": sw}
    return q


@torch.no_grad()
def calibrate_resnet26(cnn, x, *, act_fn=None):
    """Static activation scales from one calibration batch.

    Runs the float32 forward (conv7 stem, TF32 off) of
    ``resnet.apply_resnet26`` and records the absmax of every conv input.
    x: [N, H, W, 3] normalized tiles on the model's device; a few hundred
    representative tiles. The scales are per-tensor scalars."""
    act = act_fn or N.leaky_relu
    scales = {"stages": []}
    with _exact_f32():
        h = x.float().permute(0, 3, 1, 2)
        scales["conv1"] = _scale_of(h)
        h = N.conv2d_nchw(h, cnn.conv1.weight, cnn.conv1.bias, stride=2,
                          padding=3)
        h = F.max_pool2d(act(h), 3, 2, 1)
        for stage in cnn.stages():
            ss = []
            for block in stage:
                sb = {"conv1": _scale_of(h)}  # downsample shares this input
                out = act(N.conv2d_nchw(h, block.conv1.weight,
                                        block.conv1.bias,
                                        stride=block.stride, padding=1))
                sb["conv2"] = _scale_of(out)
                out = N.conv2d_nchw(out, block.conv2.weight, block.conv2.bias,
                                    stride=1, padding=1)
                if block.downsample is not None:
                    identity = N.conv2d_nchw(h, block.downsample[0].weight,
                                             stride=block.stride, padding=0)
                else:
                    identity = h
                h = act(out + identity)
                ss.append(sb)
            scales["stages"].append(ss)
        scales["fc"] = _scale_of(h.mean(dim=(2, 3)))
    return scales


def _int8_mm(a, b):
    """a [M, K] int8 @ b [K, N] int8 -> int32 [M, N] by ``torch._int_mm``,
    zero-padded to its shape rules (M > 16; K, N multiples of 8)."""
    m, k = a.shape
    n = b.shape[1]
    kp, np_ = -(-k // 8) * 8, -(-n // 8) * 8
    a = F.pad(a, (0, kp - k, 0, max(17 - m, 0)))
    bt = F.pad(b.t(), (0, kp - k, 0, np_ - n)).contiguous()  # [Np, Kp]
    # the second operand as the transpose of a row-major [N, K] matrix:
    # the layout cuBLAS's int8 GEMM takes
    return torch._int_mm(a.contiguous(), bt.t())[:m, :n]


def _taps(x_i8, kh, kw, *, stride, padding):
    """The kh * kw strided slices of the padded NCHW input, each as
    [N, OH, OW, Cin], in (dy, dx) order; and (n, oh, ow)."""
    (h_lo, h_hi), (w_lo, w_hi) = N._pairs(padding)
    x = F.pad(x_i8, (w_lo, w_hi, h_lo, h_hi))
    n, _, hp, wp = x.shape
    oh, ow = (hp - kh) // stride + 1, (wp - kw) // stride + 1
    taps = [x[:, :, dy:dy + (oh - 1) * stride + 1:stride,
              dx:dx + (ow - 1) * stride + 1:stride].permute(0, 2, 3, 1)
            for dy in range(kh) for dx in range(kw)]
    return taps, (n, oh, ow)


def _conv_i8_conv_acc(wq, x_i8, *, stride, padding):
    """float32 ``F.conv2d`` on the int8 grid (channels_last, TF32 off).
    The rounding recovers the integer should cuDNN pick a transform-based
    algorithm whose float32 result lies within rounding of it."""
    x = x_i8.float().contiguous(memory_format=torch.channels_last)
    with _exact_f32():
        acc = N.conv2d_nchw(x, wq.float(), stride=stride, padding=padding)
    return torch.round(acc).to(torch.int32)


def _conv_i8_dot_acc(wq, x_i8, *, stride, padding):
    """im2col + one int8 GEMM. The patch columns are the taps concatenated
    on the channel axis in (dy, dx, cin) order, the C-order flatten of the
    weight as [kh, kw, cin, cout], zero columns padding K to a multiple of
    8 (so the GEMM's own padding copies nothing)."""
    cout, cin, kh, kw = wq.shape
    taps, (n, oh, ow) = _taps(x_i8, kh, kw, stride=stride, padding=padding)
    k = kh * kw * cin
    kp = -(-k // 8) * 8
    if kp != k:
        taps.append(x_i8.new_zeros((n, oh, ow, kp - k)))
    patches = torch.cat(taps, dim=-1).reshape(n * oh * ow, kp)
    w = F.pad(wq.permute(2, 3, 1, 0).reshape(k, cout), (0, 0, 0, kp - k))
    acc = _int8_mm(patches, w)
    return acc.reshape(n, oh, ow, cout).permute(0, 3, 1, 2)


def _conv_i8_shift_acc(wq, x_i8, *, stride, padding):
    """Shift-add: one thin [., cin] x [cin, cout] int8 GEMM per (dy, dx)
    tap, summed in int32; no kh * kw-times patch buffer."""
    cout, cin, kh, kw = wq.shape
    taps, (n, oh, ow) = _taps(x_i8, kh, kw, stride=stride, padding=padding)
    acc = None
    for i, tap in enumerate(taps):
        part = _int8_mm(tap.reshape(n * oh * ow, cin),
                        wq[:, :, i // kw, i % kw].t())
        acc = part if acc is None else acc + part
    return acc.reshape(n, oh, ow, cout).permute(0, 3, 1, 2)


_ACC = {"conv": _conv_i8_conv_acc, "dot": _conv_i8_dot_acc,
        "shift": _conv_i8_shift_acc}


def _conv_i8_acc(wq, x_i8, *, stride, padding, impl="conv"):
    """The int32 accumulation of the int8 conv of NCHW ``x_i8`` with OIHW
    ``wq`` by ``impl`` (one of IMPLS; any other raises)."""
    if impl not in _ACC:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    return _ACC[impl](wq, x_i8, stride=stride, padding=padding)


def _conv_i8(site, x_i8, sx, *, stride, padding, impl="conv"):
    """int8 conv with int32 accumulation, dequantized to float32 NCHW:
    ``acc * (sx * sw) + b``, in the JAX package's order of operations.
    ``padding`` is an int or ``[(h_lo, h_hi), (w_lo, w_hi)]``."""
    acc = _conv_i8_acc(site["wq"], x_i8, stride=stride, padding=padding,
                       impl=impl)
    out = acc.float() * (sx * site["sw"])[None, :, None, None]
    if "b" in site:
        out = out + site["b"][None, :, None, None]
    return out


@torch.no_grad()
def apply_resnet26_int8(qparams, scales, x, *, act_fn=None, impl="conv"):
    """Quantized forward: x [N, H, W, 3] float32 tiles -> [N, embed] f32.

    The topology of :func:`resnet.apply_resnet26` (conv7 stem); the glue
    between convs (dequantize, LeakyReLU, residual add, requantize) is
    float32. ``impl`` picks the conv lowering (see :func:`_conv_i8`)."""
    act = act_fn or N.leaky_relu
    x = x.float().permute(0, 3, 1, 2)
    h = _conv_i8(qparams["conv1"], _quant(x, scales["conv1"]),
                 scales["conv1"], stride=2, padding=3, impl=impl)
    h = F.max_pool2d(act(h), 3, 2, 1)
    for stage_idx, (stage, sstage) in enumerate(
            zip(qparams["stages"], scales["stages"])):
        for b, (block, sb) in enumerate(zip(stage, sstage)):
            stride = 2 if (stage_idx > 0 and b == 0) else 1
            h_i8 = _quant(h, sb["conv1"])
            out = act(_conv_i8(block["conv1"], h_i8, sb["conv1"],
                               stride=stride, padding=1, impl=impl))
            out = _conv_i8(block["conv2"], _quant(out, sb["conv2"]),
                           sb["conv2"], stride=1, padding=1, impl=impl)
            if "downsample" in block:
                identity = _conv_i8(block["downsample"], h_i8, sb["conv1"],
                                    stride=stride, padding=0, impl=impl)
            else:
                identity = h
            h = act(out + identity)
    h_i8 = _quant(h.mean(dim=(2, 3)), scales["fc"])
    with _exact_f32():
        out = h_i8.float() @ qparams["fc"]["wq"].float()
    return out * (scales["fc"] * qparams["fc"]["sw"])


def quantize_and_calibrate(cnn, calib_tiles):
    """One call: (qparams, scales) for :func:`apply_resnet26_int8`."""
    return quantize_resnet26(cnn), calibrate_resnet26(cnn, calib_tiles)


def calib_tiles_from_builder(builder, want: int, resolution: int):
    """The first ``want`` eval-transformed tiles of a slide, on the
    builder's device, WITHOUT materializing the full bag: the raw uint8
    cache is memory-mapped and only the leading slice is transformed.
    Returns None for a tile-less slide (calibrating on the zeros fallback
    would floor every activation scale to 1e-8 and corrupt every later
    prediction)."""
    raw = builder._load_cache(mmap=True)
    n = min(int(want), int(raw.shape[0]))
    if n == 0:
        return None
    tiles = torch.from_numpy(raw[:n].copy()).to(builder.device)
    return transforms.eval_transform(tiles, resolution=resolution)


def make_int8_transform_extract(cnn, calib_tiles, resolution: int, *,
                                qp_sc=None, impl="conv"):
    """The per-chunk program of the int8 streaming path: raw uint8 tiles ->
    eval_transform -> int8 forward. Drop-in for
    ``parallel.inference.classify_slide_streaming(..., transform_extract=)``
    (the ``(cnn, raw_u8) -> [N, L]`` contract; the live cnn argument is
    ignored, the quantized weights are fixed when this is built)."""
    qp, sc = (qp_sc if qp_sc is not None
              else quantize_and_calibrate(cnn, calib_tiles))

    def run(_cnn_unused, raw_u8):
        tiles = transforms.eval_transform(raw_u8, resolution=resolution)
        return apply_resnet26_int8(qp, sc, tiles, impl=impl)

    return run


def make_int8_extractor(cnn, calib_tiles, *, qp_sc=None, impl="conv"):
    """Quantize and calibrate once, return an ``extractor`` for
    ``apply_attention_mil(..., extractor=...)`` (the pluggable tile
    embedder). It ignores the live cnn argument: the quantized weights are
    fixed when it is built (serving semantics). Pass ``qp_sc`` to share
    one calibration across several closures."""
    qp, sc = (qp_sc if qp_sc is not None
              else quantize_and_calibrate(cnn, calib_tiles))

    def extract(_cnn_unused, tiles):
        return apply_resnet26_int8(qp, sc, tiles, impl=impl)

    return extract
