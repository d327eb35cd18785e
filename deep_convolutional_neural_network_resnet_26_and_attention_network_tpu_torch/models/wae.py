"""Wasserstein-autoencoder pieces: the conv Encoder, the Decoder and the
MLP latent Discriminator, with the shared DownConv / UpConv blocks.

Counterpart of ``models/wae.py`` in the JAX package (reference:
WAEGAN.py:40-194). The public functions take and return NHWC images, as
the JAX package's do; inside, the convs run in ``channels_last``. The
encoder's fc flattens its last feature map in (H, W, C) order and the
decoder's fc unflattens the same way, as in the JAX package, so its
parameters carry over unchanged (``utils/interop.py``).

Normalization: every BN uses the batch's statistics with the biased
variance (the JAX package's ``batch_norm_2d``), and one BN is shared by
both convs of a block. The dropout and Dropout2d masks are drawn from a
``generator`` or passed in, so the tests hand both packages the same
masks. ``conv_transpose_2x2`` is ``F.conv_transpose2d`` with stride 2,
the op the JAX package leaves to XLA.
"""

import torch
from torch import nn
import torch.nn.functional as F

from .._device import resolve_device
from ..ops import init as I
from ..ops import nn as N

ENCODER_CHANNELS = ((3, 16), (16, 40), (40, 60), (60, 150), (150, 250),
                    (250, 100))  # reference: WAEGAN.py:118
DECODER_CHANNELS = ((3, 16), (16, 30), (30, 64), (64, 100), (100, 200),
                    (200, 100))  # reference: WAEGAN.py:147
DISC_DIMS = (512, 1536, 1024, 256, 128, 1)  # dim_h ladder (WAEGAN.py:176-190)
LATENT = 512


def batch_norm_2d(x, gamma, beta, eps=1e-5):
    """BatchNorm2d with batch statistics. x: [N, H, W, C]."""
    mu = x.mean(dim=(0, 1, 2), keepdim=True)
    var = ((x - mu) ** 2).mean(dim=(0, 1, 2), keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * gamma + beta


def conv(x, layer):
    """A stride-1 ``nn.Conv2d`` (its weight, bias and padding) over NHWC
    ``x``."""
    return N.conv2d_nchw(x.permute(0, 3, 1, 2), layer.weight, layer.bias,
                         padding=layer.padding[0]).permute(0, 2, 3, 1)


def conv_transpose_2x2(x, w, b):
    """torch ConvTranspose2d(k=2, s=2): exact 2x upsample. x NHWC; ``w``
    [cin, cout, 2, 2] (``ConvTranspose2d``'s layout)."""
    return F.conv_transpose2d(x.permute(0, 3, 1, 2), w, b,
                              stride=2).permute(0, 2, 3, 1)


def keep_mask(generator, shape, p_keep, device):
    """Boolean mask of ``shape``, True with probability ``p_keep``, drawn
    on the generator's device and moved to ``device``."""
    return (torch.rand(shape, generator=generator, device=generator.device)
            < p_keep).to(device)


def drop(h, keep, rate):
    """Inverted dropout with the given keep mask (broadcasting)."""
    return torch.where(keep, h / (1.0 - rate), torch.zeros_like(h))


class BatchNorm(nn.Module):
    """The affine parameters of a batch-statistics BN (``weight`` =
    gamma, ``bias`` = beta); no running statistics."""

    def __init__(self, c: int, device=None):
        super().__init__()
        device = resolve_device(device)
        self.weight = nn.Parameter(torch.ones(c, device=device))
        self.bias = nn.Parameter(torch.zeros(c, device=device))

    def forward(self, x):
        return batch_norm_2d(x, self.weight, self.bias)


@torch.no_grad()
def reset_parameters(module, generator):
    """The JAX package's init: convs (and the transposed convs) kaiming
    fan-out for LeakyReLU(0.1), linears kaiming fan-in with the same
    gain, biases zero, BN gamma 1 / beta 0."""
    for m in module.modules():
        if isinstance(m, nn.ConvTranspose2d):
            i, o, kh, kw = m.weight.shape
            m.weight.copy_(I.conv_kernel(generator, kh, kw, i, o)
                           .permute(1, 0, 2, 3))
        elif isinstance(m, nn.Conv2d):
            o, i, kh, kw = m.weight.shape
            m.weight.copy_(I.conv_kernel(generator, kh, kw, i, o))
        elif isinstance(m, nn.Linear):
            o, i = m.weight.shape
            m.weight.copy_(I.linear_kaiming_fan_in(generator, i, o,
                                                   I.leaky_relu_gain(0.1)))
        elif isinstance(m, BatchNorm):
            m.weight.fill_(1.0)
        else:
            continue
        m.bias.zero_()
    return module


class DownConv(nn.Module):
    """conv5x5 + conv3x3 + shared BN (reference: WAEGAN.py:56-84)."""

    def __init__(self, cin: int, cout: int, device=None):
        super().__init__()
        device = resolve_device(device)
        self.conv1 = nn.Conv2d(cin, cout, 5, padding=2, device=device)
        self.conv2 = nn.Conv2d(cout, cout, 3, padding=1, device=device)
        self.bn = BatchNorm(cout, device)

    def masks(self, generator, n, h, w, device, dropout=0.5):
        """The three keep masks of a training call on an [n, h, w, cin]
        input: the two dropouts' (after each conv) and Dropout2d's
        [n, 1, 1, cout]."""
        c = self.conv1.out_channels
        return (keep_mask(generator, (n, h, w, c), 1.0 - dropout, device),
                keep_mask(generator, (n, h, w, c), 1.0 - dropout, device),
                keep_mask(generator, (n, 1, 1, c), 0.5, device))

    def forward(self, x, *, pooling=True, masks=None, dropout=0.5):
        """selu convs with BN, dropout where ``masks`` are given, then a
        2x2 maxpool (reference: WAEGAN.py:78-84)."""
        h = self.bn(F.selu(conv(x, self.conv1)))
        if masks is not None:
            h = drop(h, masks[0], dropout)
        h = self.bn(F.selu(conv(h, self.conv2)))
        if masks is not None:
            h = drop(drop(h, masks[1], dropout), masks[2], 0.5)
        if pooling:
            h = N.max_pool(h, window=2, stride=2, padding=0)
        return h


class UpConv(nn.Module):
    """transpose-upconv 2x2 + two conv3x3 + shared BN
    (reference: WAEGAN.py:86-111)."""

    def __init__(self, cin: int, cout: int, device=None):
        super().__init__()
        device = resolve_device(device)
        self.upconv = nn.ConvTranspose2d(cin, cout, 2, stride=2,
                                         device=device)
        self.conv1 = nn.Conv2d(cout, cout, 3, padding=1, device=device)
        self.conv2 = nn.Conv2d(cout, cout, 3, padding=1, device=device)
        self.bn = BatchNorm(cout, device)

    def forward(self, x):
        h = conv_transpose_2x2(x, self.upconv.weight, self.upconv.bias)
        h = self.bn(F.selu(conv(h, self.conv1)))
        return self.bn(F.selu(conv(h, self.conv2)))


class Encoder(nn.Module):
    """[N, S, S, 3] -> [N, 512] latent (reference: WAEGAN.py:112-138)."""

    def __init__(self, *, latent_size=8, channels=ENCODER_CHANNELS,
                 device=None):
        super().__init__()
        device = resolve_device(device)
        self.down = nn.ModuleList(DownConv(ci, co, device)
                                  for ci, co in channels)
        self.fc = nn.Linear(channels[-1][1] * latent_size * latent_size,
                            LATENT, device=device)

    def masks(self, generator, x, dropout=0.5):
        """Every block's keep masks for a training call on ``x``."""
        n, h, w, _ = x.shape
        out = []
        for block in self.down:
            out.append(block.masks(generator, n, h, w, x.device, dropout))
            h, w = h // 2, w // 2
        return out

    def forward(self, x, *, masks=None):
        for i, block in enumerate(self.down):
            x = block(x, pooling=True,
                      masks=None if masks is None else masks[i])
        x = x.reshape(x.shape[0], -1)
        return N.relu(N.linear(x, self.fc.weight.T, self.fc.bias))


class Decoder(nn.Module):
    """[N, 512] -> [N, S*2^d, S*2^d, 3] image (reference: WAEGAN.py:141-167)."""

    def __init__(self, *, latent_size=8, channels=DECODER_CHANNELS,
                 device=None):
        super().__init__()
        device = resolve_device(device)
        self.latent_size = latent_size
        self.cfinal = channels[-1][1]
        self.up = nn.ModuleList(UpConv(ci, co, device)
                                for co, ci in reversed(channels))
        self.fc = nn.Linear(LATENT, self.cfinal * latent_size * latent_size,
                            device=device)

    def forward(self, z):
        x = N.relu(N.linear(z, self.fc.weight.T, self.fc.bias))
        x = x.reshape(-1, self.latent_size, self.latent_size, self.cfinal)
        for block in self.up:
            x = block(x)
        return x


class WAEDiscriminator(nn.Module):
    """MLP latent critic with a sigmoid head (reference: WAEGAN.py:169-194);
    dropout after the first three hidden layers when training."""

    N_DROPOUT = 3

    def __init__(self, dims=DISC_DIMS, device=None):
        super().__init__()
        device = resolve_device(device)
        self.layers = nn.ModuleList(nn.Linear(i, o, device=device)
                                    for i, o in zip(dims[:-1], dims[1:]))

    def masks(self, generator, z):
        """The three dropout keep masks of a training call on ``z``."""
        return [keep_mask(generator, (z.shape[0], layer.out_features), 0.5,
                          z.device)
                for layer in self.layers[:self.N_DROPOUT]]

    def forward(self, z, *, masks=None):
        h = z
        last = len(self.layers) - 1
        for i, layer in enumerate(self.layers):
            h = N.linear(h, layer.weight.T, layer.bias)
            if i < last:
                h = N.relu(h)
                if masks is not None and i < self.N_DROPOUT:
                    h = drop(h, masks[i], 0.5)
        return torch.sigmoid(h)


def _init(cls, generator, device, **kw):
    model = cls(device="meta", **kw).to_empty(device=resolve_device(device))
    return reset_parameters(model, generator)


def init_encoder(generator, *, latent_size=8, channels=ENCODER_CHANNELS,
                 device=None):
    return _init(Encoder, generator, device, latent_size=latent_size,
                 channels=channels)


def init_decoder(generator, *, latent_size=8, channels=DECODER_CHANNELS,
                 device=None):
    return _init(Decoder, generator, device, latent_size=latent_size,
                 channels=channels)


def init_wae_discriminator(generator, *, dims=DISC_DIMS, device=None):
    return _init(WAEDiscriminator, generator, device, dims=dims)


def _train_masks(model, generator, masks, x, train):
    if not train:
        return None
    if masks is None and generator is not None:
        return model.masks(generator, x)
    return masks


def apply_encoder(model, x, *, train=False, generator=None, masks=None):
    """[N, S, S, 3] -> [N, 512]. ``train=True`` applies the dropouts, with
    the given ``masks`` (``Encoder.masks``' layout) or drawn from
    ``generator``; with neither it runs as in eval, as the JAX package
    does without a key."""
    return model(x, masks=_train_masks(model, generator, masks, x, train))


def apply_decoder(model, z):
    """[N, 512] -> [N, S*2^d, S*2^d, 3]."""
    return model(z)


def apply_wae_discriminator(model, z, *, train=False, generator=None,
                            masks=None):
    """[N, 512] -> [N, 1] in (0, 1); ``train`` as in :func:`apply_encoder`."""
    return model(z, masks=_train_masks(model, generator, masks, z, train))

