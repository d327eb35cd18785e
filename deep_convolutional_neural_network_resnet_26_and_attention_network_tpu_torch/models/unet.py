"""LatentUNet encoder-decoder with a latent bottleneck, SMOTE jitter, and
a learnable cluster-assignment layer.

Counterpart of ``models/unet.py`` in the JAX package (reference:
Encoders.py:14-356): a U-Net whose deepest feature map flattens through a
fully-connected latent (1024*8*8 -> 1024 at the reference's size), 1x1
bottleneck taps at every level, merge modes concat / add / skip,
``smote_layer`` gaussian jitter and the ``ClusterLayer`` k-means style
assignment with its inertia and cross-term losses. Public functions take
NHWC images and flatten in (H, W, C) order, as the JAX package's do, so
its parameters carry over unchanged (``utils/interop.py``).

The encoder tap is resized to the decoder's map with
``mode="nearest-exact"``: ``jax.image.resize``'s "nearest" samples at
half-pixel centres, which PyTorch's plain "nearest" does not.
"""

import torch
from torch import nn
import torch.nn.functional as F

from .._device import resolve_device
from ..ops import init as I
from ..ops import nn as N
from .wae import (BatchNorm, batch_norm_2d, conv, conv_transpose_2x2,
                  reset_parameters)

MERGE_MODES = ("concat", "add", "skip")


def smote_layer(x, generator, epsilon: float = 0.005):
    """x + eps * N(0, 1) jitter (reference: Encoders.py:14-23); the draw is
    made on the generator's device and moved to ``x``'s."""
    z = torch.randn(x.shape, generator=generator, device=generator.device)
    return x + epsilon * z.to(x.device, x.dtype)


class ClusterLayer(nn.Module):
    """``centers`` [n_clusters, dim] (reference: Encoders.py:25-43)."""

    def __init__(self, n_clusters: int, dim: int = 16 * 8, device=None):
        super().__init__()
        self.centers = nn.Parameter(torch.empty(
            n_clusters, dim, device=resolve_device(device)))


def init_cluster_layer(generator, n_clusters: int, dim: int = 16 * 8,
                       device=None):
    """Xavier-normal centers, as the JAX package's."""
    layer = ClusterLayer(n_clusters, dim, device=device)
    with torch.no_grad():
        layer.centers.copy_(I.linear_xavier_normal(generator, dim,
                                                   n_clusters))
    return layer


def apply_cluster_layer(layer, x):
    """Nearest-center assignment. Returns (inertia / batch,
    cross-term / k, assignments) (reference: Encoders.py:32-43)."""
    centers = layer.centers
    n_clusters = centers.shape[0]
    flat = x.reshape(x.shape[0], -1)
    d2 = ((flat[:, None, :] - centers[None]) ** 2).sum(dim=2)     # [B, K]
    cl = torch.argmin(d2, dim=1)
    inertia = d2[torch.arange(d2.shape[0], device=d2.device), cl].sum()
    gram = centers @ centers.T
    sign = 2.0 * torch.eye(n_clusters, device=centers.device) - 1.0
    xe = (sign * gram).sum()
    return inertia / x.shape[0], xe / n_clusters, cl


def _relu_bn(x, layer, bn):
    return bn(F.relu(conv(x, layer)))


class DownBlock(nn.Module):
    """2x (conv3x3 -> relu -> BN), a 1x1 bottleneck tap, maxpool
    (reference: Encoders.py:95-130; dropout omitted, eval semantics)."""

    def __init__(self, cin, cout, latent_channels, device):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, cout, 3, padding=1, device=device)
        self.conv2 = nn.Conv2d(cout, cout, 3, padding=1, device=device)
        self.bn = BatchNorm(cout, device)
        self.bottle_in = nn.Conv2d(cout, latent_channels, 1, device=device)
        self.bn_in = BatchNorm(latent_channels, device)

    def forward(self, x, *, pooling):
        h = _relu_bn(x, self.conv1, self.bn)
        h = _relu_bn(h, self.conv2, self.bn)
        tap = _relu_bn(h, self.bottle_in, self.bn_in)
        if pooling:
            h = N.max_pool(h, window=2, stride=2, padding=0)
        return h, tap


class UpBlock(nn.Module):
    """Transpose-upconv, the 1x1 expansion of the encoder tap merged in,
    two convs (reference: Encoders.py:133-182)."""

    def __init__(self, cin, cout, latent_channels, concat, device):
        super().__init__()
        self.upconv = nn.ConvTranspose2d(cin, cout, 2, stride=2,
                                         device=device)
        # conv1 doubles its input only on the concat layer
        # (reference: Encoders.py:151-156)
        self.conv1 = nn.Conv2d(2 * cout if concat else cout, cout, 3,
                               padding=1, device=device)
        self.conv2 = nn.Conv2d(cout, cout, 3, padding=1, device=device)
        self.bn = BatchNorm(cout, device)
        self.bottle_out = nn.Conv2d(latent_channels, cout, 1, device=device)
        self.bn_out = BatchNorm(cout, device)

    def forward(self, from_down, from_up, *, merge_mode="skip"):
        """'skip' ignores the encoder tap ``from_down``."""
        if merge_mode not in MERGE_MODES:
            raise ValueError(f"merge_mode {merge_mode!r} is not one of "
                             f"{MERGE_MODES}")
        x = conv_transpose_2x2(from_up, self.upconv.weight, self.upconv.bias)
        if merge_mode != "skip":
            side = _relu_bn(from_down, self.bottle_out, self.bn_out)
            if side.shape[1:3] != x.shape[1:3]:
                side = F.interpolate(side.permute(0, 3, 1, 2),
                                     size=tuple(x.shape[1:3]),
                                     mode="nearest-exact").permute(0, 2, 3, 1)
            x = (torch.cat([x, side], dim=-1) if merge_mode == "concat"
                 else x + side)
        h = _relu_bn(x, self.conv1, self.bn)
        return _relu_bn(h, self.conv2, self.bn)


class LatentUNet(nn.Module):
    """The LatentUNet's parameters. The latent's flat size derives from
    ``input_size``, ``depth`` and ``start_filts``; the latent reshapes to
    16 planes of side sqrt(latent_dim / 16) (reference: Encoders.py:330).
    Up block ``concat_layer`` (-1: none) merges the encoder tap by
    concatenation, every other block skips it."""

    def __init__(self, *, in_channels=3, out_channels=3, depth=5,
                 start_filts=16, latent_channels=10, input_size=128,
                 latent_dim=1024, concat_layer=-1, device=None):
        super().__init__()
        device = resolve_device(device)
        self.concat_layer = concat_layer
        self.latent_dim = latent_dim
        down, outs = [], start_filts
        for i in range(depth):
            ins = in_channels if i == 0 else outs
            outs = start_filts * (2 ** i)
            down.append(DownBlock(ins, outs, latent_channels, device))
        self.down = nn.ModuleList(down)
        bottom = input_size // (2 ** (depth - 1))
        self.fcl = nn.Linear(outs * bottom * bottom, latent_dim,
                             device=device)
        self.bottle_out = nn.Conv2d(16, outs, 1, device=device)
        up, ins = [], outs
        for i in range(depth - 1):
            outs = ins // 2
            up.append(UpBlock(ins, outs, latent_channels, i == concat_layer,
                              device))
            ins = outs
        self.up = nn.ModuleList(up)
        self.final = nn.Conv2d(outs, out_channels, 1, device=device)


def init_latent_unet(generator, *, device=None, **kw):
    """A LatentUNet (``LatentUNet``'s keywords) on ``device`` with the
    JAX package's init drawn from ``generator``."""
    model = LatentUNet(device="meta", **kw).to_empty(
        device=resolve_device(device))
    return reset_parameters(model, generator)


def apply_latent_unet(model, x, *, generator=None, perturbation=False,
                      early_stop=False):
    """Forward (reference: Encoders.py:311-356). Returns
    (reconstruction, latent_flat, encoder_tap); with ``early_stop=True``
    (bottom_features, latent_flat, encoder_tap). ``perturbation`` jitters
    the encoder tap with :func:`smote_layer` from ``generator``."""
    depth = len(model.down)
    encoder_tap = None
    h = x
    for i, block in enumerate(model.down):
        h, tap = block(h, pooling=(i < depth - 1))
        if i == depth - model.concat_layer - 2:
            encoder_tap = tap
    flat = h.reshape(h.shape[0], -1)
    latent_flat = F.relu(N.linear(flat, model.fcl.weight.T, model.fcl.bias))
    if early_stop:
        return h, latent_flat, encoder_tap

    lat_side = int((model.latent_dim // 16) ** 0.5)
    latent = latent_flat.reshape(-1, lat_side, lat_side, 16)
    decoder_in = encoder_tap
    # the reference jitters the encoder TAP, not the latent, and at its
    # own concat_layer = -1 every up block skips the tap: SMOTE is a no-op
    # at default arguments there too (the JAX package keeps it so)
    if perturbation and generator is not None and decoder_in is not None:
        decoder_in = smote_layer(decoder_in, generator)
    g = F.relu(conv(latent, model.bottle_out))
    c = g.shape[-1]
    g = batch_norm_2d(g, torch.ones(c, device=g.device),
                      torch.zeros(c, device=g.device))
    for i, block in enumerate(model.up):
        merge = "concat" if i == model.concat_layer else "skip"
        g = block(decoder_in, g, merge_mode=merge)
    recon = conv(g, model.final)
    return recon, latent_flat, encoder_tap
