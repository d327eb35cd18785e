"""Progressive-growing StyleGAN: the styled generator and the critic.

Counterpart of ``models/stylegan.py`` in the JAX package, after the
reference's vendored StyleGAN (reference:
style-based-gan-pytorch-master-512/model.py:1-580). The modules carry the
reference's ``state_dict`` names (``generator.progression.5.conv1.0.weight``,
``style.1.linear.weight_orig``, ``progression.0.conv2.1.weight``, the blur
buffers ``...weight`` / ``...weight_flip``), so a reference checkpoint
loads with ``load_state_dict(strict=True)`` and ``utils/interop.py`` maps
them onto the JAX package's parameter paths:

  * equalized learning rate: raw N(0, 1) weights (``weight_orig``) scaled
    by sqrt(2 / fan_in) at use (reference: model.py:24-53)
  * FusedUpsample / FusedDownsample: stride-2 transposed conv / conv with
    the 4-tap shift-averaged kernel (reference: model.py:56-111)
  * Blur: the binomial 3x3 as the JAX package's separable shift-adds
    (reference: model.py:122-179 writes a depthwise convolution, whose
    buffers the module keeps for the state-dict names; the grouped
    convolution and its double backward were far slower on the card under
    cuDNN's deterministic algorithms)
  * PixelNorm, AdaIN (instance norm + style affine), NoiseInjection,
    ConstantInput, StyledConvBlock (reference: model.py:114-119,271-374)
  * Generator: 9 blocks from 4 to 1024 px with per-block to_rgb, style
    mixing by a per-block style selection, alpha fade-in
    (reference: model.py:377-451)
  * StyledGenerator: the 8-layer PixelNorm + EqualLinear mapping MLP and
    mean-style truncation (reference: model.py:454-506)
  * Discriminator: the mirrored progression with the minibatch-stddev
    plane at 4x4, from_rgb taps and train-mode dropout
    (reference: model.py:509-580)

Layouts are NCHW with OIHW weights. The random draws are arguments: the
noise planes ``[B, 1, s, s]`` (:func:`make_noise`) and the critic's
dropout masks, one boolean ``[B, C, h, w]`` keep mask a block
(:func:`draw_dropout`, or a ``torch.Generator`` that draws them as the
blocks run), so a test can feed both packages the same draws and the
trainer can seed them per epoch. ``group`` (a ``torch.distributed`` group)
makes the critic's batch statistic, the minibatch stddev, global over the
ranks that split the batch (``parallel/mesh.py``'s data mesh).
"""

import math
import random as _random

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from .._device import resolve_device
from ..ops.collectives import all_reduce_sum, group_size
from ..ops.nn import leaky_relu

# channel schedule for blocks at 4,8,16,32,64,128,256,512,1024 px
# (reference: model.py:380-390,512-521)
CHANNELS = (512, 512, 512, 512, 256, 128, 64, 32, 16)
LRELU_SLOPE = 0.2
DROPOUT_KEEP = 0.5


def _scaled(width_mult: float, c: int) -> int:
    return max(4, int(c * width_mult))


def lrelu(x):
    """LeakyReLU(0.2) with the JAX package's derivative 1 at 0
    (``ops/nn.leaky_relu``)."""
    return leaky_relu(x, LRELU_SLOPE)


class LeakyReLU(nn.Module):
    """Parameter-free :func:`lrelu`, standing where the reference's
    ``nn.LeakyReLU(0.2)`` stands so the Sequential indices (the
    state-dict names) stay the reference's."""

    def forward(self, x):
        return lrelu(x)


def equal_scale(fan_in: int) -> float:
    """EqualLR multiplier sqrt(2 / fan_in) (reference: model.py:28-32)."""
    return math.sqrt(2.0 / fan_in)


# ----------------------------------------------------------- primitives
class EqualConv2d(nn.Module):
    """Conv with equalized-lr scaling; parameters ``conv.weight_orig``
    [cout, cin, k, k] and ``conv.bias``."""

    def __init__(self, cin, cout, k, padding=0, device=None):
        super().__init__()
        self.padding = padding
        self.conv = nn.Module()
        self.conv.weight_orig = nn.Parameter(
            torch.empty(cout, cin, k, k, device=device))
        self.conv.bias = nn.Parameter(torch.empty(cout, device=device))

    def forward(self, x):
        w = self.conv.weight_orig
        return F.conv2d(x, w * equal_scale(w[0].numel()), self.conv.bias,
                        padding=self.padding)


class EqualLinear(nn.Module):
    """Linear with equalized-lr scaling; ``linear.weight_orig`` [out, in]
    and ``linear.bias``."""

    def __init__(self, cin, cout, device=None):
        super().__init__()
        self.linear = nn.Module()
        self.linear.weight_orig = nn.Parameter(
            torch.empty(cout, cin, device=device))
        self.linear.bias = nn.Parameter(torch.empty(cout, device=device))

    def forward(self, x):
        w = self.linear.weight_orig
        return F.linear(x, w * equal_scale(w.shape[1]), self.linear.bias)


def _fused_kernel(w):
    """Pad the kernel by 1 and average the four shifts (reference:
    model.py:72-78). w: [a, b, k, k] -> [a, b, k+1, k+1]."""
    w = F.pad(w, (1, 1, 1, 1))
    return (w[:, :, 1:, 1:] + w[:, :, :-1, 1:] + w[:, :, 1:, :-1]
            + w[:, :, :-1, :-1]) / 4.0


class FusedUpsample(nn.Module):
    """Stride-2 transposed conv with the smoothed kernel (reference:
    model.py:56-82); ``weight`` [cin, cout, k, k], ``bias`` [cout]."""

    def __init__(self, cin, cout, k, padding=0, device=None):
        super().__init__()
        self.padding = padding
        self.weight = nn.Parameter(torch.empty(cin, cout, k, k, device=device))
        self.bias = nn.Parameter(torch.empty(cout, device=device))

    def forward(self, x):
        w = self.weight
        fan_in = w.shape[0] * w.shape[2] * w.shape[3]
        return F.conv_transpose2d(x, _fused_kernel(w * equal_scale(fan_in)),
                                  self.bias, stride=2, padding=self.padding)


class FusedDownsample(nn.Module):
    """Stride-2 conv with the smoothed kernel (reference: model.py:85-111);
    ``weight`` [cout, cin, k, k], ``bias`` [cout]."""

    def __init__(self, cin, cout, k, padding=0, device=None):
        super().__init__()
        self.padding = padding
        self.weight = nn.Parameter(torch.empty(cout, cin, k, k, device=device))
        self.bias = nn.Parameter(torch.empty(cout, device=device))

    def forward(self, x):
        w = self.weight
        return F.conv2d(x, _fused_kernel(w * equal_scale(w[0].numel())),
                        self.bias, stride=2, padding=self.padding)


class Blur(nn.Module):
    """Binomial 3x3 blur (reference: model.py:165-179), [1, 2, 1] / 4 along
    each axis with zero padding, as shift-adds (``blur``); the reference's
    ``weight`` / ``weight_flip`` buffers are kept for its state-dict names
    (the kernel is symmetric, so the flip equals it)."""

    def __init__(self, channels, device=None):
        super().__init__()
        k = torch.tensor([[1.0, 2.0, 1.0], [2.0, 4.0, 2.0], [1.0, 2.0, 1.0]],
                         device=device)
        k = (k / k.sum()).reshape(1, 1, 3, 3).repeat(channels, 1, 1, 1)
        self.register_buffer("weight", k)
        self.register_buffer("weight_flip", k.flip(2, 3).clone())

    def forward(self, x):
        return blur(x)


def blur(x):
    """The binomial 3x3 blur of NCHW ``x`` with zero padding, separable:
    the JAX package's ``blur`` (shift-adds, whose backward is slicing)."""
    xp = F.pad(x, (0, 0, 1, 1))
    x = (xp[:, :, :-2] + 2.0 * xp[:, :, 1:-1] + xp[:, :, 2:]) * 0.25
    xp = F.pad(x, (1, 1))
    return (xp[..., :-2] + 2.0 * xp[..., 1:-1] + xp[..., 2:]) * 0.25


def upsample2x(x):
    """2x bilinear upsample with half-pixel centres and edge clamping
    (``jax.image.resize(..., "bilinear")``, ``F.interpolate(scale_factor=2,
    mode="bilinear")``) as a fixed stencil: output 2i is 0.25 x[i-1] +
    0.75 x[i], output 2i+1 is 0.75 x[i] + 0.25 x[i+1]. Written with
    slices, so its backward on the card has no atomics and repeats bit
    for bit (the trainer's resume relies on it)."""
    def axis(x, d):
        first = x.narrow(d, 0, 1)
        last = x.narrow(d, x.shape[d] - 1, 1)
        xp = torch.cat([first, x, last], dim=d)
        n = x.shape[d]
        lo, mid, hi = (xp.narrow(d, 0, n), xp.narrow(d, 1, n),
                       xp.narrow(d, 2, n))
        even = 0.25 * lo + 0.75 * mid
        odd = 0.75 * mid + 0.25 * hi
        out = torch.stack([even, odd], dim=d + 1)
        shape = list(x.shape)
        shape[d] = 2 * n
        return out.reshape(shape)

    return axis(axis(x, 2), 3)


def pixel_norm(x, dim=1, eps=1e-8):
    """x / sqrt(mean(x^2, channels)) (reference: model.py:114-119)."""
    return x * torch.rsqrt(torch.mean(x * x, dim=dim, keepdim=True) + eps)


def instance_norm_plain(x, eps=1e-5):
    """The formula as autograd sees it when written out: ``x - mu`` is
    formed twice, and the backward keeps both copies (one under ``** 2``,
    one under the product). :func:`instance_norm` is held to it bit for
    bit."""
    mu = torch.mean(x, dim=(2, 3), keepdim=True)
    var = torch.mean((x - mu) ** 2, dim=(2, 3), keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps)


class _CenteredScale(torch.autograd.Function):
    """``b * r`` whose backward is ``mul``'s own, but which saves ``a``, the
    operand of the variance's ``** 2``, in place of ``b``. Both are
    ``x - mu`` of the same tensors, so they hold the same bits; autograd
    already keeps ``a`` for the ``** 2``, and the product then adds no
    second activation-sized copy (a 1024 px f32 step's largest buffers).
    The graph and each gradient term are those of
    :func:`instance_norm_plain`, so the gradient is unchanged bit for bit.
    Nothing differentiates the generator twice (the critic's gradient
    penalty detaches its input), so one backward is enough."""

    @staticmethod
    def forward(ctx, b, r, a):
        ctx.save_for_backward(a, r)
        return b * r

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        a, r = ctx.saved_tensors
        gb = g * r if ctx.needs_input_grad[0] else None
        gr = ((g * a).sum((2, 3), keepdim=True)
              if ctx.needs_input_grad[1] else None)
        return gb, gr, None


def instance_norm(x, eps=1e-5):
    """Per-sample per-channel spatial normalization (torch InstanceNorm2d,
    affine=False). x: [N, C, H, W]. The arithmetic of
    :func:`instance_norm_plain`, with one saved copy of ``x - mu``."""
    mu = torch.mean(x, dim=(2, 3), keepdim=True)
    a = x - mu
    var = torch.mean(a ** 2, dim=(2, 3), keepdim=True)
    return _CenteredScale.apply(x - mu, torch.rsqrt(var + eps), a.detach())


class PixelNorm(nn.Module):
    def forward(self, x):
        return pixel_norm(x)


class NoiseInjection(nn.Module):
    """x + scale * weight * noise with equal_lr on the weight, fan_in = C
    (reference: model.py:291-297 with equal_lr at :356,361)."""

    def __init__(self, channels, device=None):
        super().__init__()
        self.weight_orig = nn.Parameter(
            torch.empty(1, channels, 1, 1, device=device))

    def forward(self, x, noise):
        w = self.weight_orig
        return x + w * equal_scale(w.shape[1]) * noise


class AdaptiveInstanceNorm(nn.Module):
    """style -> (gamma, beta) through an EqualLinear whose bias starts at
    (1, 0) (reference: model.py:271-288)."""

    def __init__(self, channels, style_dim, device=None):
        super().__init__()
        self.style = EqualLinear(style_dim, channels * 2, device=device)

    def forward(self, x, style):
        s = self.style(style)
        c = x.shape[1]
        gamma, beta = s[:, :c, None, None], s[:, c:, None, None]
        return instance_norm(x) * gamma + beta


class ConstantInput(nn.Module):
    def __init__(self, channels, device=None):
        super().__init__()
        self.input = nn.Parameter(torch.empty(1, channels, 4, 4,
                                              device=device))

    def forward(self, batch: int):
        return self.input.expand(batch, -1, -1, -1)


class _Upsample(nn.Module):
    def forward(self, x):
        return upsample2x(x)


class StyledConvBlock(nn.Module):
    """(reference: model.py:314-374)."""

    def __init__(self, cin, cout, kernel, padding, style_dim, *,
                 initial=False, upsample=False, fused=False, device=None):
        super().__init__()
        if initial:
            self.conv1 = ConstantInput(cin, device=device)
        elif upsample and fused:
            self.conv1 = nn.Sequential(
                FusedUpsample(cin, cout, kernel, padding, device=device),
                Blur(cout, device=device))
        elif upsample:
            self.conv1 = nn.Sequential(
                _Upsample(), EqualConv2d(cin, cout, kernel, padding,
                                         device=device),
                Blur(cout, device=device))
        else:
            self.conv1 = EqualConv2d(cin, cout, kernel, padding,
                                     device=device)
        self.initial = initial
        self.noise1 = NoiseInjection(cout, device=device)
        self.adain1 = AdaptiveInstanceNorm(cout, style_dim, device=device)
        self.conv2 = EqualConv2d(cout, cout, kernel, (kernel - 1) // 2,
                                 device=device)
        self.noise2 = NoiseInjection(cout, device=device)
        self.adain2 = AdaptiveInstanceNorm(cout, style_dim, device=device)

    def forward(self, x, style, noise):
        out = self.conv1(style.shape[0]) if self.initial else self.conv1(x)
        out = lrelu(self.noise1(out, noise))
        out = self.adain1(out, style)
        out = self.conv2(out)
        out = lrelu(self.noise2(out, noise))
        return self.adain2(out, style)


# ------------------------------------------------------------ generator
def _gen_layout(width_mult: float):
    """(cin, cout, kernel, padding, upsample, fused) per block."""
    ch = [_scaled(width_mult, c) for c in CHANNELS]
    layout = [(ch[0], ch[0], 3, 1, False, False)]  # 4px, initial
    specs = [(1, 3, 1, False), (2, 3, 1, False), (3, 3, 1, False),
             (4, 3, 1, False), (5, 5, 2, True), (6, 5, 2, True),
             (7, 5, 2, True), (8, 5, 2, True)]
    cin = ch[0]
    for idx, k, pad, fused in specs:
        layout.append((cin, ch[idx], k, pad, True, fused))
        cin = ch[idx]
    return layout


class Generator(nn.Module):
    def __init__(self, style_dim=512, width_mult=1.0, device=None):
        super().__init__()
        layout = _gen_layout(width_mult)
        self.progression = nn.ModuleList([
            StyledConvBlock(cin, cout, k, pad, style_dim, initial=(i == 0),
                            upsample=up, fused=fz, device=device)
            for i, (cin, cout, k, pad, up, fz) in enumerate(layout)])
        self.to_rgb = nn.ModuleList([
            EqualConv2d(cout, 3, 1, device=device)
            for (_, cout, *_rest) in layout])


class StyledGenerator(nn.Module):
    """``generator`` (the progression) and ``style``, the mapping MLP as
    the reference's Sequential: PixelNorm at 0, then EqualLinear and
    LeakyReLU alternating (EqualLinear at 1, 3, ..., 15)."""

    def __init__(self, style_dim=512, n_mlp=8, width_mult=1.0, device=None):
        super().__init__()
        self.generator = Generator(style_dim, width_mult, device=device)
        layers = [PixelNorm()]
        for _ in range(n_mlp):
            layers += [EqualLinear(style_dim, style_dim, device=device),
                       LeakyReLU()]
        self.style = nn.Sequential(*layers)

    @property
    def n_blocks(self) -> int:
        return len(self.generator.progression)

    @torch.no_grad()
    def reset_parameters(self, generator):
        """The JAX package's init: raw N(0, 1) weights and constant, zero
        biases and noise weights, AdaIN gamma biases 1."""
        _reset_normal(self, generator)
        for block in self.generator.progression:
            for adain in (block.adain1, block.adain2):
                c = adain.style.linear.bias.shape[0] // 2
                adain.style.linear.bias[:c] = 1.0
            block.noise1.weight_orig.zero_()
            block.noise2.weight_orig.zero_()


def _reset_normal(module, generator):
    for name, p in module.named_parameters():
        if name.endswith("bias"):
            p.zero_()
        else:
            p.copy_(torch.randn(p.shape, generator=generator,
                                device=generator.device).to(p.device))


def apply_style_mlp(gen: StyledGenerator, z):
    """PixelNorm -> 8x (EqualLinear + LeakyReLU 0.2)
    (reference: model.py:457-463). z: [B, D]."""
    h = pixel_norm(z, dim=-1)
    for layer in gen.style[1::2]:
        h = lrelu(layer(h))
    return h


def mean_style(gen: StyledGenerator, z):
    """Mean mapped style for truncation (reference: model.py:498-501)."""
    return apply_style_mlp(gen, z).mean(dim=0, keepdim=True)


def _fade(alpha) -> float:
    """alpha < 0 means no blend, which equals alpha = 1; else clip to
    [0, 1]."""
    alpha = float(alpha)
    return 1.0 if alpha < 0 else min(max(alpha, 0.0), 1.0)


def apply_generator(gen: Generator, styles, noise, *, step=0, alpha=-1.0,
                    style_sel=None, remat=False):
    """styles: [S, B, D] mapped styles; noise: list of [B, 1, s, s] planes
    (``noise[i]`` for block i); style_sel: per-block indices into S (the
    style-mixing crossover, :func:`sample_style_sel`). Returns
    [B, 3, s, s] at resolution 4 * 2**step.

    ``remat`` recomputes each styled-conv block in the backward pass
    (``torch.utils.checkpoint``, non-reentrant); values are unchanged."""
    n = len(gen.progression)
    if not 0 <= step < n:
        raise ValueError(
            f"step {step} out of range for a {n}-block generator "
            f"(max resolution {4 * 2 ** (n - 1)}px)")
    if style_sel is None:
        style_sel = [0] * n
    out = out_prev = None
    for i, block in enumerate(gen.progression[:step + 1]):
        style_i = styles[int(style_sel[i])]
        out_prev = out
        if remat:
            out = checkpoint(block, out, style_i, noise[i],
                             use_reentrant=False)
        else:
            out = block(out, style_i, noise[i])
    rgb = gen.to_rgb[step](out)
    a = _fade(alpha)
    if step > 0 and a < 1.0:
        skip = upsample2x(gen.to_rgb[step - 1](out_prev))
        rgb = (1 - a) * skip + a * rgb
    return rgb


def apply_styled_generator(gen: StyledGenerator, zs, noise, *, step=0,
                           alpha=-1.0, style_sel=None, mean_style_w=None,
                           style_weight=0.0, remat=False):
    """zs: [S, B, D] latent codes (S = 1 plain, 2 for mixing); the styles
    pass the mapping MLP, with optional truncation toward
    ``mean_style_w`` (reference: model.py:465-496)."""
    styles = torch.stack([apply_style_mlp(gen, z) for z in zs])
    if mean_style_w is not None:
        styles = mean_style_w + style_weight * (styles - mean_style_w)
    return apply_generator(gen.generator, styles, noise, step=step,
                           alpha=alpha, style_sel=style_sel, remat=remat)


def make_noise(generator, batch: int, step: int, device=None):
    """Per-resolution noise planes [B, 1, s, s] for blocks 0..step
    (reference: model.py:481-485), drawn from ``generator`` on
    ``device`` (the generator's by default)."""
    device = generator.device if device is None else device
    return [torch.randn((batch, 1, 4 * 2 ** i, 4 * 2 ** i),
                        generator=generator, device=device)
            for i in range(step + 1)]


def sample_style_sel(py_rng, n_styles: int, step: int, n_blocks: int):
    """Host-side style-mixing crossover schedule (reference:
    model.py:419-434): len(styles) - 1 crossover points in range(step)."""
    sel = [0] * n_blocks
    if n_styles < 2:
        return sel
    inject = sorted((py_rng or _random).sample(list(range(max(step, 1))),
                                               n_styles - 1))
    crossover = 0
    for i in range(n_blocks):
        if crossover < len(inject) and i > inject[crossover]:
            crossover = min(crossover + 1, n_styles - 1)
        sel[i] = crossover
    return sel


# --------------------------------------------------------- discriminator
def _disc_layout(width_mult: float):
    """Blocks from high resolution down: (cin, cout, k1, pad1, k2, pad2,
    downsample, fused)."""
    ch = [_scaled(width_mult, c) for c in CHANNELS]
    layout = [
        (ch[8], ch[7], 5, 2, 5, 2, True, True),    # 512px
        (ch[7], ch[6], 5, 2, 5, 2, True, True),    # 256
        (ch[6], ch[5], 5, 2, 5, 2, True, True),    # 128
        (ch[5], ch[4], 5, 2, 5, 2, True, True),    # 64
        (ch[4], ch[3], 3, 1, 3, 1, True, False),   # 32
        (ch[3], ch[2], 3, 1, 3, 1, True, False),   # 16
        (ch[2], ch[1], 3, 1, 3, 1, True, False),   # 8
        (ch[1], ch[0], 3, 1, 3, 1, True, False),   # 4
        (ch[0] + 1, ch[0], 3, 1, 4, 0, False, False),  # final (513 -> 512)
    ]
    return layout, ch


class ConvBlock(nn.Module):
    """(reference: model.py:209-268): ``conv1`` = (EqualConv2d, LeakyReLU);
    ``conv2`` = (Blur, FusedDownsample, LeakyReLU) when fused, (Blur,
    EqualConv2d, AvgPool2d, LeakyReLU) when downsampling, else
    (EqualConv2d, LeakyReLU)."""

    def __init__(self, spec, device=None):
        super().__init__()
        cin, cout, k1, p1, k2, p2, down, fused = spec
        self.conv1 = nn.Sequential(EqualConv2d(cin, cout, k1, p1,
                                               device=device),
                                   LeakyReLU())
        if down and fused:
            self.conv2 = nn.Sequential(
                Blur(cout, device=device),
                FusedDownsample(cout, cout, k2, p2, device=device),
                LeakyReLU())
        elif down:
            self.conv2 = nn.Sequential(
                Blur(cout, device=device),
                EqualConv2d(cout, cout, k2, p2, device=device),
                nn.AvgPool2d(2), LeakyReLU())
        else:
            self.conv2 = nn.Sequential(
                EqualConv2d(cout, cout, k2, p2, device=device),
                LeakyReLU())

    def forward(self, x, keep=None):
        """``keep``: this block's boolean dropout mask over conv1's output
        (train mode), or None."""
        out = self.conv1(x)
        if keep is not None:
            out = torch.where(keep, out / DROPOUT_KEEP, 0.0)
        return self.conv2(out)


class Discriminator(nn.Module):
    def __init__(self, width_mult=1.0, from_rgb_activate=True, device=None):
        super().__init__()
        layout, ch = _disc_layout(width_mult)
        self.layout = layout
        self.progression = nn.ModuleList([ConvBlock(s, device=device)
                                          for s in layout])
        rgb_out = [ch[8], ch[7], ch[6], ch[5], ch[4], ch[3], ch[2], ch[1],
                   ch[0]]
        if from_rgb_activate:
            self.from_rgb = nn.ModuleList([
                nn.Sequential(EqualConv2d(3, c, 1, device=device),
                              LeakyReLU()) for c in rgb_out])
        else:
            self.from_rgb = nn.ModuleList([
                EqualConv2d(3, c, 1, device=device) for c in rgb_out])
        self.linear = EqualLinear(ch[0], 1, device=device)

    @property
    def n_blocks(self) -> int:
        return len(self.progression)

    @torch.no_grad()
    def reset_parameters(self, generator):
        """The JAX package's init: raw N(0, 1) weights, zero biases."""
        _reset_normal(self, generator)


def minibatch_stddev(x, eps=1e-8, group=None):
    """sqrt(variance over the batch) averaged to one scalar, tiled as an
    extra feature map (reference: model.py:565-569). With ``group`` the
    batch is split over its ranks (equal shares) and the mean and the
    variance are the whole batch's, each one differentiable all-reduce."""
    if group is None:
        mu = x.mean(dim=0)
        var = ((x - mu) ** 2).mean(dim=0)
    else:
        n = x.shape[0] * group_size(group)
        mu = all_reduce_sum(x.sum(dim=0), group) / n
        var = all_reduce_sum(((x - mu) ** 2).sum(dim=0), group) / n
    mean_std = torch.sqrt(var + eps).mean()
    plane = mean_std.expand(x.shape[0], 1, x.shape[2], x.shape[3])
    return torch.cat([x, plane.to(x.dtype)], dim=1)


def keep_shapes(disc: Discriminator, batch: int, step: int):
    """The shapes of the dropout masks of a critic pass at ``step``, one a
    block in the order the blocks run (resolution 4 * 2**step down to 4)."""
    n = disc.n_blocks
    return [(batch, disc.layout[n - i - 1][1], 4 * 2 ** i, 4 * 2 ** i)
            for i in range(step, -1, -1)]


def draw_dropout(generator, disc: Discriminator, batch: int, step: int,
                 device=None):
    """Bernoulli(0.5) keep masks for one critic pass (the JAX package's
    per-block ``jax.random.bernoulli(sub, 0.5, out.shape)``), drawn from
    ``generator``."""
    device = generator.device if device is None else device
    return [torch.rand(s, generator=generator, device=device) < DROPOUT_KEEP
            for s in keep_shapes(disc, batch, step)]


def apply_discriminator(disc: Discriminator, x, *, step=0, alpha=-1.0,
                        keep=None, remat=False, group=None):
    """x: [B, 3, s, s] at resolution 4 * 2**step -> [B, 1] scores
    (reference: model.py:551-580).

    ``keep``: None (no dropout, eval), a list of boolean masks in
    :func:`keep_shapes`' order (train mode), or a ``torch.Generator`` that
    draws them block by block. ``remat`` recomputes each block in the
    backward pass (non-reentrant ``torch.utils.checkpoint``, which carries
    the gradient penalty's second order); values are unchanged. ``group``:
    see :func:`minibatch_stddev`."""
    n = disc.n_blocks
    if not 0 <= step < n:
        raise ValueError(
            f"step {step} out of range for a {n}-block discriminator "
            f"(max resolution {4 * 2 ** (n - 1)}px)")
    if isinstance(keep, torch.Generator):
        keep = draw_dropout(keep, disc, x.shape[0], step, device=x.device)
    out = None
    for j, i in enumerate(range(step, -1, -1)):
        index = n - i - 1
        if i == step:
            out = disc.from_rgb[index](x)
        if i == 0:
            out = minibatch_stddev(out, group=group)
        block = disc.progression[index]
        mask = None if keep is None else keep[j]
        if remat:
            out = checkpoint(block, out, mask, use_reentrant=False)
        else:
            out = block(out, mask)
        if i > 0 and i == step:
            a = _fade(alpha)
            if a < 1.0:
                skip = disc.from_rgb[index + 1](F.avg_pool2d(x, 2))
                out = (1 - a) * skip + a * out
    out = out.reshape(out.shape[0], -1)
    # the reference computes self.do(out) here and discards the result
    # (model.py:578): no dropout applies to the linear
    return disc.linear(out)


def _parameters_of(modules):
    return [p for m in modules for p in m.parameters()]


def generator_live_parameters(gen: StyledGenerator, step: int, alpha):
    """The parameters of ``gen`` that a pass at ``step`` and ``alpha``
    reaches (:func:`apply_styled_generator`): the style MLP, blocks
    0..step, ``to_rgb[step]`` and, while it fades in, ``to_rgb[step - 1]``;
    in the order of ``gen.parameters()``. A function of the step and
    ``alpha`` alone, so every rank of a data mesh finds the same set."""
    g = gen.generator
    modules = [gen.style, *g.progression[:step + 1], g.to_rgb[step]]
    if step > 0 and _fade(alpha) < 1.0:
        modules.append(g.to_rgb[step - 1])
    live = {id(p) for p in _parameters_of(modules)}
    return [p for p in gen.parameters() if id(p) in live]


def critic_live_parameters(disc: Discriminator, step: int, alpha):
    """The parameters of ``disc`` that a critic pass at ``step`` and
    ``alpha`` reaches (:func:`apply_discriminator`): ``from_rgb`` of the
    step's resolution, the blocks from there down to 4 px, the linear and,
    while it fades in, the next ``from_rgb``; in the order of
    ``disc.parameters()``, the same on every rank."""
    index = disc.n_blocks - step - 1
    modules = [disc.from_rgb[index], *disc.progression[index:], disc.linear]
    if step > 0 and _fade(alpha) < 1.0:
        modules.append(disc.from_rgb[index + 1])
    live = {id(p) for p in _parameters_of(modules)}
    return [p for p in disc.parameters() if id(p) in live]


def init_styled_generator(generator, *, style_dim=512, n_mlp=8,
                          width_mult=1.0, device=None):
    """A :class:`StyledGenerator` on ``device`` (the card unless the CPU
    is asked for) with the JAX package's init drawn from ``generator``."""
    gen = StyledGenerator(style_dim, n_mlp, width_mult, device="meta")
    gen = gen.to_empty(device=resolve_device(device))
    _fill_blur(gen)
    gen.reset_parameters(generator)
    return gen


def init_discriminator(generator, *, width_mult=1.0, from_rgb_activate=True,
                       device=None):
    """A :class:`Discriminator` on ``device`` with the JAX package's init
    drawn from ``generator``."""
    disc = Discriminator(width_mult, from_rgb_activate, device="meta")
    disc = disc.to_empty(device=resolve_device(device))
    _fill_blur(disc)
    disc.reset_parameters(generator)
    return disc


@torch.no_grad()
def _fill_blur(module):
    """Blur buffers after ``to_empty`` (which leaves buffers unset)."""
    for m in module.modules():
        if isinstance(m, Blur):
            fresh = Blur(m.weight.shape[0], device=m.weight.device)
            m.weight.copy_(fresh.weight)
            m.weight_flip.copy_(fresh.weight_flip)
