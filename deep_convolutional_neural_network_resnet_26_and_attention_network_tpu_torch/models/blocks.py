"""Misc building blocks from the reference's nnBlocks / gbm.model toolbox.

Counterpart of ``models/blocks.py`` in the JAX package, with its
functional form: parameters are dicts of tensors in the JAX layouts (HWIO
convs, ``[in, out]`` linears) and activations NHWC, through ``ops/nn.py``,
so one parameter tree (``interop``-free, ``torch.from_numpy`` of the JAX
leaves) runs in both packages.

  TinyExtractor      small CNN tile embedder (reference: nnBlocks.py:15-44)
  zero_dropout       unscaled Bernoulli dropout (reference: nnBlocks.py:140-155)
  ConvBlock          conv pair with 4 downsample variants
                     (reference: nnBlocks.py:397-466)
  ConvToChannelOnly  1x1 + full-size SELU convs (reference: nnBlocks.py:498-512)
  rgb_to_he_res      fixed-weight H&E stain round-trip (reference:
                     nnBlocks.py:281-293)
  linear_norm        PixelNorm duplicate (reference: nnBlocks.py:303-308)
  MLClassifier       3 channel-wise linear heads (reference: gbm/model.py:63-85)
  reset_linear       tanh-kaiming re-init of every linear weight
                     (reference: gbm/model.py:183-187), for a parameter
                     tree or an ``nn.Module`` (the legacy driver's
                     ``--transfer`` on an ``AttentionMIL``)

Initializers draw from a ``torch.Generator`` (``ops/init.py``'s torch
semantics), so their values are the port's own, not the JAX package's.
"""

import torch
import torch.nn.functional as F

from ..ops import init as I
from ..ops import nn as N


def _hwio(t):
    """An OIHW kernel from ``ops/init`` -> HWIO."""
    return t.permute(2, 3, 1, 0).contiguous()


def _conv_p(generator, k, cin, cout):
    return _hwio(I.conv_kernel(generator, k, k, cin, cout))


# ----------------------------------------------------------- ZeroDropout
def zero_dropout(x, p, keep, *, train: bool):
    """Bernoulli zeroing WITHOUT the 1/(1-p) rescale (reference:
    nnBlocks.py:140-155 multiplies by the raw keep mask). ``keep`` is the
    boolean mask (True with probability 1 - p)."""
    if not train or p <= 0.0:
        return x
    return x * keep.to(x.dtype)


# ------------------------------------------------------------ RBGtoHEres
# the reference's hardcoded stain matrix, value for value (reference:
# nnBlocks.py:283-287)
_RGB_FROM_HED = ((1.8874, 0.2780, -1.5554),
                 (-1.4174, 0.8393, 1.1682),
                 (-0.1583, -0.4823, 1.6774))


def rgb_to_he_res(x):
    """H&E stain-space round-trip residual transform, x: [N, H, W, 3]:
    out = -10^-((-(log10(x+2))) @ M^T) + 2 (reference: nnBlocks.py:288-293)."""
    m = torch.tensor(_RGB_FROM_HED, dtype=x.dtype, device=x.device)
    out = -torch.log10(x + 2.0)
    out = torch.einsum("nhwc,co->nhwo", out, m.T)
    return -torch.pow(10.0, -out) + 2.0


def linear_norm(x, eps=1e-8):
    """x / sqrt(mean(x^2, channel)), channel last (reference:
    nnBlocks.py:296-308)."""
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)


# -------------------------------------------------------------- ConvBlock
def init_conv_block(generator, cin, cout, kernel, *, kernel2=None,
                    downsample=False, fused=False, max2d=False, fast=False):
    k2nd = kernel2 or kernel
    if downsample and (fast or not (fused or max2d)):
        k2nd = 2
    p = {"conv1": {"w": _conv_p(generator, kernel, cin, cout),
                   "b": torch.zeros(cout)}}
    if downsample and fused:
        # the FusedDownsample weight is raw N(0, 1) (the StyleGAN family)
        w = torch.randn((k2nd, k2nd, cout, cout), generator=generator)
    else:
        w = _conv_p(generator, k2nd, cout, cout)
    p["conv2"] = {"w": w, "b": torch.zeros(cout)}
    return p


def _fused_downsample(x, w, b, padding):
    """models/stylegan's FusedDownsample on NHWC ``x`` and an HWIO raw
    weight."""
    from .stylegan import _fused_kernel, equal_scale

    kh, kw, cin, _ = w.shape
    wt = _fused_kernel(w.permute(3, 2, 0, 1) * equal_scale(cin * kh * kw))
    out = F.conv2d(x.permute(0, 3, 1, 2), wt, b, stride=2, padding=padding)
    return out.permute(0, 2, 3, 1)


def apply_conv_block(p, x, *, padding, padding2=None, downsample=False,
                     fused=False, max2d=False, fast=False):
    """conv + lrelu(0.1) then one of: fused downsample / conv + maxpool /
    stride-2 conv (+ maxpool if fast) / plain conv
    (reference: nnBlocks.py:397-466)."""
    pad2 = padding if padding2 is None else padding2
    out = N.leaky_relu(N.conv2d(x, p["conv1"]["w"], p["conv1"]["b"],
                                padding=padding))
    w, b = p["conv2"]["w"], p["conv2"]["b"]
    if downsample and fused:
        return N.leaky_relu(_fused_downsample(out, w, b, pad2))
    if downsample and max2d:
        out = N.max_pool(N.conv2d(out, w, b, padding=pad2), window=2,
                         stride=2, padding=0)
        return N.leaky_relu(out)
    if downsample and fast:
        out = N.max_pool(N.conv2d(out, w, b, stride=2, padding=0), window=2,
                         stride=2, padding=0)
        return N.leaky_relu(out)
    if downsample:
        return N.leaky_relu(N.conv2d(out, w, b, stride=2, padding=0))
    return N.leaky_relu(N.conv2d(out, w, b, padding=pad2))


# -------------------------------------------------------- TinyExtractor
TINY_SPECS = [
    # (cin, cout, downsample) with kernel 3 pad 0 (reference: nnBlocks.py:25-33)
    (32, 32, False), (32, 64, False), (64, 64, True),
    (64, 128, False), (128, 128, False), (128, None, True),
]


def init_tiny_extractor(generator, channels_out: int):
    stem = {"w": _conv_p(generator, 7, 3, 32)}  # bias-free stem
    blocks = [init_conv_block(generator, cin, cout or channels_out, 3,
                              downsample=down, max2d=down)
              for cin, cout, down in TINY_SPECS]
    fc = {"w": I.linear_kaiming_fan_in(generator, channels_out, channels_out,
                                       I.leaky_relu_gain(0.1)).T.contiguous(),
          "b": torch.zeros(channels_out)}
    return {"stem": stem, "blocks": blocks, "fc": fc}


def apply_tiny_extractor(params, x, channels_out: int):
    """x: [N, H, W, 3] -> [N, channels_out] (reference: nnBlocks.py:38-44;
    the stem uses ReLU, the blocks LeakyReLU(0.1))."""
    h = N.relu(N.conv2d(x, params["stem"]["w"], stride=2, padding=3))
    h = N.max_pool(h, window=3, stride=2, padding=1)
    for p, (_, _, down) in zip(params["blocks"], TINY_SPECS):
        h = apply_conv_block(p, h, padding=0, downsample=down, max2d=down)
    return N.linear(N.global_avg_pool(h), params["fc"]["w"],
                    params["fc"]["b"])


# ---------------------------------------------------- ConvToChannelOnly
def init_conv_to_channel_only(generator, cin, cout, input_dim_size):
    return {"conv1": {"w": _conv_p(generator, 1, cin, cout),
                      "b": torch.zeros(cout)},
            "conv2": {"w": _conv_p(generator, input_dim_size, cout, cout),
                      "b": torch.zeros(cout)}}


def apply_conv_to_channel_only(p, x):
    """1x1 conv -> SELU -> full-spatial conv -> SELU: [N, S, S, Cin] ->
    [N, 1, 1, Cout] (reference: nnBlocks.py:498-512)."""
    out = F.selu(N.conv2d(x, p["conv1"]["w"], p["conv1"]["b"]))
    return F.selu(N.conv2d(out, p["conv2"]["w"], p["conv2"]["b"]))


# ----------------------------------------------------------- MLClassifier
def init_ml_classifier(generator, features: int):
    return [{"w": I.linear_xavier_normal(generator, features, 1).T
             .contiguous(), "b": torch.zeros(1)} for _ in range(3)]


def apply_ml_classifier(params, x):
    """x: [3, O] -> [1, 3] logits through 3 per-channel linear heads
    (reference: gbm/model.py:63-85)."""
    outs = [N.linear(x[i], p["w"], p["b"]) for i, p in enumerate(params)]
    return torch.stack(outs).reshape(1, 3)


# ------------------------------------------------------------ reset_linear
@torch.no_grad()
def reset_linear(params, generator):
    """Re-initialize every 2-D (linear) weight with kaiming-tanh fan_in and
    zero its bias (reference: gbm/model.py:183-187; the legacy driver's
    ``--transfer``, gbm/classify.py:383); conv kernels stay. ``params`` is
    a tree of dicts/lists with ``w`` [in, out] leaves (returned anew) or
    an ``nn.Module`` whose ``weight`` [out, in] parameters are reset in
    place (returned)."""
    if isinstance(params, torch.nn.Module):
        named = dict(params.named_parameters())
        for name, p in named.items():
            if p.ndim == 2 and name.endswith("weight"):
                out_f, in_f = p.shape
                p.copy_(I.linear_kaiming_fan_in(generator, in_f, out_f,
                                                I.TANH_GAIN).to(p.device))
                bias = named.get(name[:-len("weight")] + "bias")
                if bias is not None:
                    bias.zero_()
        return params

    def visit(node):
        if isinstance(node, dict):
            w = node.get("w")
            if isinstance(w, torch.Tensor) and w.ndim == 2:
                out = dict(node)
                out["w"] = I.linear_kaiming_fan_in(
                    generator, w.shape[0], w.shape[1], I.TANH_GAIN).T \
                    .contiguous()
                if "b" in node:
                    out["b"] = torch.zeros_like(node["b"])
                return out
            return {k: visit(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(visit(v) for v in node)
        return node

    return visit(params)
