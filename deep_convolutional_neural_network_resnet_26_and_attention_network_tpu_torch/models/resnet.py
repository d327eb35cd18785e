"""ResNet-26 per-tile feature extractor (nn.Module, channels_last inside).

Counterpart of ``models/resnet.py`` in the JAX package, after the
reference's narrow, normalization-free ResNet (reference:
gbm/model.py:14-61 and nnBlocks.py:157-189):

  * stem: conv 7x7 stride 2 pad 3 (bias), LeakyReLU(0.1), maxpool 3x3 s2 p1
  * four stages of widths 20/40/60/80, each 3 BasicResBlocks
    (conv3x3 -> lrelu -> conv3x3 -> +shortcut -> lrelu, bias=True, no norm;
     1x1 stride-s conv shortcut, bias=False, when shape changes)
  * global average pool -> Linear(80 -> embed_dim, bias=False)

Module names follow the reference state dict (``conv1``,
``layer{s}.{b}.conv{1,2}``, ``layer{s}.{b}.downsample.0``, ``fc``), so
reference checkpoints and the JAX parameters (``utils/interop.py``) load
with ``strict=True``. The forward takes NHWC tiles like the JAX function;
the permute to NCHW is a ``channels_last`` view, and every conv runs in
that memory format. ``remat=True`` recomputes each residual block in the
backward pass (``torch.utils.checkpoint``, as the JAX package's
``jax.checkpoint``), trading compute for activation memory.

Two entries run the one trunk (the stages, the pool and ``fc``):
``forward`` on float tiles through cuDNN's stem, and ``forward_u8`` on
uint8 tiles through the fused stem of ``ops/u8_stem.py`` (in bf16 the
stem and its LeakyReLU and max-pool in one launch), which the streaming
path's chunk program takes on the card. ``stem``, ``stem_u8``,
``run_stage`` and ``head`` are the pieces, which the per-stage profile
times one by one.
"""

from typing import Sequence

import torch
from torch import nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .._device import resolve_device
from ..ops import init as I
from ..ops import nn as N
from ..ops import u8_stem
from ..utils import profiling

WIDTHS = (20, 40, 60, 80)
BLOCKS_PER_STAGE = (3, 3, 3, 3)
EMBED_DIM = 80


class BasicBlock(nn.Module):
    """conv3x3 -> lrelu -> conv3x3 -> + shortcut -> lrelu (no norm)."""

    def __init__(self, cin: int, cout: int, stride: int, device=None):
        super().__init__()
        device = resolve_device(device)
        self.stride = stride
        self.conv1 = nn.Conv2d(cin, cout, 3, stride, 1, device=device)
        self.conv2 = nn.Conv2d(cout, cout, 3, 1, 1, device=device)
        if stride != 1 or cin != cout:
            self.downsample = nn.Sequential(
                nn.Conv2d(cin, cout, 1, stride, 0, bias=False, device=device))
        else:
            self.downsample = None

    @torch.no_grad()
    def reset_parameters(self, generator):
        for conv in (self.conv1, self.conv2):
            o, i, kh, kw = conv.weight.shape
            conv.weight.copy_(I.conv_kernel(generator, kh, kw, i, o))
            conv.bias.zero_()
        if self.downsample is not None:
            o, i, _, _ = self.downsample[0].weight.shape
            self.downsample[0].weight.copy_(I.conv_kernel(generator, 1, 1, i, o))

    def forward(self, x, compute_dtype=None, act_fn=None):
        act = act_fn or N.leaky_relu
        out = N.conv2d_nchw(x, self.conv1.weight, self.conv1.bias,
                            stride=self.stride, padding=1,
                            compute_dtype=compute_dtype)
        out = act(out)
        out = N.conv2d_nchw(out, self.conv2.weight, self.conv2.bias,
                            stride=1, padding=1, compute_dtype=compute_dtype)
        if self.downsample is not None:
            identity = N.conv2d_nchw(x, self.downsample[0].weight,
                                     stride=self.stride, padding=0,
                                     compute_dtype=compute_dtype)
        else:
            identity = x
        return act(out + identity)


class ResNet26(nn.Module):
    """Tiles [N, H, W, 3] (NHWC) -> embeddings [N, embed_dim]. Its
    parameters lie on ``device``: the card unless the CPU (or ``"meta"``)
    is asked for."""

    def __init__(self, *, embed_dim: int = EMBED_DIM,
                 widths: Sequence[int] = WIDTHS,
                 blocks: Sequence[int] = BLOCKS_PER_STAGE, device=None):
        super().__init__()
        device = resolve_device(device)
        self.conv1 = nn.Conv2d(3, widths[0], 7, 2, 3, device=device)
        self.n_stages = len(widths)
        cin = widths[0]
        for s, (width, n_blocks) in enumerate(zip(widths, blocks)):
            stage = []
            for b in range(n_blocks):
                stride = 2 if (s > 0 and b == 0) else 1
                stage.append(BasicBlock(cin, width, stride, device=device))
                cin = width
            setattr(self, f"layer{s + 1}", nn.Sequential(*stage))
        # fc has no bias (reference: gbm/model.py:32)
        self.fc = nn.Linear(widths[-1], embed_dim, bias=False, device=device)

    def stages(self):
        return [getattr(self, f"layer{s + 1}") for s in range(self.n_stages)]

    @torch.no_grad()
    def reset_parameters(self, generator):
        """The reference's init (``ops/init.py``), drawn from ``generator``."""
        o, i, kh, kw = self.conv1.weight.shape
        self.conv1.weight.copy_(I.conv_kernel(generator, kh, kw, i, o))
        self.conv1.bias.zero_()
        o, i = self.fc.weight.shape
        self.fc.weight.copy_(I.linear_kaiming_fan_in(
            generator, i, o, I.leaky_relu_gain(0.1)))
        for stage in self.stages():
            for block in stage:
                block.reset_parameters(generator)

    def stem(self, x, *, compute_dtype=None, act_fn=None):
        """cuDNN's stem on float NHWC tiles: conv 7x7/s2/p3 with bias,
        LeakyReLU (or ``act_fn``), max-pool 3/2/1; returns NCHW
        (``channels_last``) activations."""
        h = N.conv2d_nchw(x.permute(0, 3, 1, 2), self.conv1.weight,
                          self.conv1.bias, stride=2, padding=3,
                          compute_dtype=compute_dtype)
        return F.max_pool2d((act_fn or N.leaky_relu)(h), 3, 2, 1)

    def stem_u8(self, x_u8, *, alpha, beta, compute_dtype=None):
        """The fused stem on uint8 NHWC tiles; returns NCHW
        (``channels_last``) activations. In bf16 one launch on the card
        does it all, ``ops/u8_stem.stem_u8_pool`` (the normalize ``x *
        alpha + beta``, the conv, the cast to bf16, LeakyReLU and the
        max-pool 3/2/1), and the tiles count as ``stem.pooled_tiles``.
        In any other ``compute_dtype`` ``ops/u8_stem.stem_u8_conv`` (the
        normalize and the conv), then its float32 output cast to
        ``compute_dtype``, LeakyReLU, max-pool 3/2/1."""
        if compute_dtype == torch.bfloat16:
            h = u8_stem.stem_u8_pool(self.conv1, x_u8, alpha=alpha, beta=beta)
            profiling.count("stem.pooled_tiles", x_u8.shape[0])
            return h.permute(0, 3, 1, 2)
        h = u8_stem.stem_u8_conv(self.conv1, x_u8, alpha=alpha, beta=beta)
        if compute_dtype is not None:
            h = h.to(compute_dtype)
        return F.max_pool2d(N.leaky_relu(h.permute(0, 3, 1, 2)), 3, 2, 1)

    def run_stage(self, s, h, *, compute_dtype=None, act_fn=None,
                  remat=False):
        """Stage ``s`` (from 0) of residual blocks on NCHW activations."""
        for block in self.stages()[s]:
            if remat and torch.is_grad_enabled():
                h = checkpoint(block, h, compute_dtype, act_fn,
                               use_reentrant=False)
            else:
                h = block(h, compute_dtype, act_fn)
        return h

    def head(self, h, *, compute_dtype=None):
        """NCHW activations -> (global average pool [N, C], embeddings
        [N, embed_dim] through ``fc``)."""
        pooled = h.mean(dim=(2, 3))
        return pooled, N.linear(pooled, self.fc.weight.T,
                                compute_dtype=compute_dtype)

    def _trunk(self, h, compute_dtype, taps, remat, act_fn):
        """Either stem's activations -> the stages and the head."""
        acts = {"stem": h.permute(0, 2, 3, 1)} if taps else None
        for s in range(self.n_stages):
            h = self.run_stage(s, h, compute_dtype=compute_dtype,
                               act_fn=act_fn, remat=remat)
            if taps:
                acts[f"stage{s + 1}"] = h.permute(0, 2, 3, 1)
        pooled, out = self.head(h, compute_dtype=compute_dtype)
        if taps:
            acts["pool"] = pooled
            return out, acts
        return out

    def forward(self, x, *, compute_dtype=None, taps: bool = False,
                remat: bool = False, act_fn=None):
        """x [N, H, W, 3] -> [N, embed_dim] through cuDNN's stem.
        ``taps=True`` also returns the ordered NHWC activations 'stem',
        'stage1'..'stage4' and 'pool'. ``remat=True`` keeps only each
        block's input for the backward pass and recomputes the rest there
        (a no-op without autograd). ``act_fn`` replaces every LeakyReLU
        (the stem's and the blocks'), as the JAX package's ``act_fn``
        does; guided backprop passes its guided activation."""
        h = self.stem(x.contiguous(), compute_dtype=compute_dtype,
                      act_fn=act_fn)
        return self._trunk(h, compute_dtype, taps, remat, act_fn)

    @torch.no_grad()
    def forward_u8(self, x_u8, *, alpha, beta, compute_dtype=None):
        """uint8 tiles [N, 300, 300, 3] -> [N, embed_dim] through the fused
        stem (:meth:`stem_u8`), where ``u8_stem.accepts`` this ``conv1``
        and the tiles. Serving only: it runs without autograd. The
        streaming path's chunk program calls it with the eval transform's
        normalize, ``alpha=2/255, beta=-1``."""
        h = self.stem_u8(x_u8, alpha=alpha, beta=beta,
                         compute_dtype=compute_dtype)
        return self._trunk(h, compute_dtype, False, False, None)


def init_resnet26(generator, *, embed_dim: int = EMBED_DIM,
                  widths: Sequence[int] = WIDTHS,
                  blocks: Sequence[int] = BLOCKS_PER_STAGE, device=None):
    """A ResNet26 on ``device`` (the card by default) with the reference's
    init drawn from ``generator``."""
    model = ResNet26(embed_dim=embed_dim, widths=widths, blocks=blocks,
                     device="meta").to_empty(device=resolve_device(device))
    model.reset_parameters(generator)
    return model


def apply_resnet26(model, x, *, compute_dtype=None, taps: bool = False,
                   act_fn=None, remat: bool = False):
    """Forward: x [N, H, W, 3] -> embeddings [N, embed_dim]."""
    return model(x, compute_dtype=compute_dtype, taps=taps, remat=remat,
                 act_fn=act_fn)
