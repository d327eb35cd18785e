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
"""

from typing import Sequence

import numpy as np
import torch
from torch import nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .._device import resolve_device
from ..ops import init as I
from ..ops import nn as N

WIDTHS = (20, 40, 60, 80)
BLOCKS_PER_STAGE = (3, 3, 3, 3)
EMBED_DIM = 80


def _s2d_index_maps():
    """Static index maps rearranging the [7,7,3,co] stem kernel into the
    equivalent [4,4,12,co] kernel over space-to-depth input.

    Derivation: out(i) = sum_u W7[u] x[2i+u-3]; write u-3 = 2m+dy with
    dy = (u-3) % 2, m = (u-3-dy)//2 — the tap lands at s2d row i+m,
    parity dy, i.e. conv4 tap a = m+2 with asymmetric padding (2, 1).
    Every (u, v, c) source maps to a unique (a, b, channel) slot; slots
    with no source stay zero.
    """
    src_u, src_v, src_c = [], [], []
    dst_a, dst_b, dst_ch = [], [], []
    for u in range(7):
        ky = u - 3
        dy = ky % 2
        a = (ky - dy) // 2 + 2
        for v in range(7):
            kx = v - 3
            dx = kx % 2
            b = (kx - dx) // 2 + 2
            for c in range(3):
                src_u.append(u)
                src_v.append(v)
                src_c.append(c)
                dst_a.append(a)
                dst_b.append(b)
                dst_ch.append((dy * 2 + dx) * 3 + c)
    return tuple(np.asarray(x, np.int64)
                 for x in (src_u, src_v, src_c, dst_a, dst_b, dst_ch))


_S2D_MAPS = _s2d_index_maps()


def stem_s2d_kernel(w7):
    """[7,7,3,co] HWIO stem weights -> the equivalent [4,4,12,co] HWIO
    kernel over space-to-depth input (see :func:`_s2d_index_maps`)."""
    su, sv, sc, da, db, dch = (torch.from_numpy(m).to(w7.device)
                               for m in _S2D_MAPS)
    w4 = w7.new_zeros((4, 4, 12, w7.shape[-1]))
    w4[da, db, dch] = w7[su, sv, sc]
    return w4


def space_to_depth2(x):
    """[N,2H,2W,C] -> [N,H,W,4C], channel index (dy*2+dx)*C + c."""
    n, h2, w2, c = x.shape
    y = x.reshape(n, h2 // 2, 2, w2 // 2, 2, c)
    y = y.permute(0, 1, 3, 2, 4, 5)
    return y.reshape(n, h2 // 2, w2 // 2, 4 * c)


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

    def _stem(self, x_nhwc, compute_dtype, stem, act=N.leaky_relu):
        w, b = self.conv1.weight, self.conv1.bias
        if stem == "s2d" and x_nhwc.shape[1] % 2 == 0 \
                and x_nhwc.shape[2] % 2 == 0:
            xc = (x_nhwc.to(compute_dtype) if compute_dtype is not None
                  else x_nhwc)
            w4 = stem_s2d_kernel(w.permute(2, 3, 1, 0)).permute(3, 2, 0, 1)
            h = N.conv2d_nchw(space_to_depth2(xc).permute(0, 3, 1, 2), w4, b,
                              stride=1, padding=[(2, 1), (2, 1)],
                              compute_dtype=compute_dtype)
        else:
            h = N.conv2d_nchw(x_nhwc.permute(0, 3, 1, 2), w, b, stride=2,
                              padding=3, compute_dtype=compute_dtype)
        return F.max_pool2d(act(h), 3, 2, 1)

    def forward(self, x, *, compute_dtype=None, taps: bool = False,
                stem: str = "conv7", remat: bool = False, act_fn=None):
        """x [N, H, W, 3] -> [N, embed_dim]. ``taps=True`` also returns the
        ordered NHWC activations 'stem', 'stage1'..'stage4' and 'pool'.
        ``stem="s2d"`` computes the stem as space-to-depth + conv4x4 (the
        same sum of products; conv7 for odd sizes). ``remat=True`` keeps
        only each block's input for the backward pass and recomputes the
        rest there (a no-op without autograd). ``act_fn`` replaces every
        LeakyReLU (the stem's and the blocks'), as the JAX package's
        ``act_fn`` does; guided backprop passes its guided activation."""
        x = x.contiguous()
        acts = {}
        act = act_fn or N.leaky_relu
        h = self._stem(x, compute_dtype, stem, act)
        if taps:
            acts["stem"] = h.permute(0, 2, 3, 1)
        for s, stage in enumerate(self.stages()):
            for block in stage:
                if remat and torch.is_grad_enabled():
                    h = checkpoint(block, h, compute_dtype, act_fn,
                                   use_reentrant=False)
                else:
                    h = block(h, compute_dtype, act_fn)
            if taps:
                acts[f"stage{s + 1}"] = h.permute(0, 2, 3, 1)
        h = h.mean(dim=(2, 3))
        out = N.linear(h, self.fc.weight.T, compute_dtype=compute_dtype)
        if taps:
            acts["pool"] = h
            return out, acts
        return out


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
                   act_fn=None, stem: str = "conv7", remat: bool = False):
    """Forward: x [N, H, W, 3] -> embeddings [N, embed_dim]."""
    return model(x, compute_dtype=compute_dtype, taps=taps, stem=stem,
                 remat=remat, act_fn=act_fn)
