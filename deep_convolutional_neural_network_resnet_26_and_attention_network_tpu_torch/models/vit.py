"""ViT tile encoder: UNI's ViT-L/16 as the attention-MIL head's embedder.

UNI (Chen et al., *Towards a general-purpose foundation model for
computational pathology*, Nature Medicine 30, 2024; model card
huggingface.co/MahmoodLab/UNI) is timm's ``vit_large_patch16_224`` with
``init_values=1e-5`` and no classifier, trained with DINOv2 on 100k
slides. The JAX package has no transformer, so this module has no JAX
counterpart; ``benchmark/reference/vit_mil.py`` is its plain reference.

With N = 1 + (S / p)^2 tokens of width d (the head's L) for tiles of S px:

    x0 = [cls; PatchEmbed(img)] + pos          PatchEmbed: p x p stride p, 3 -> d
    x += g1 * Proj(MHSA(LN1(x)))               softmax(Q K^T / sqrt(d / heads)) V
    x += g2 * FC2(GELU(FC1(LN2(x))))           GELU in its erf form
    feature = LN_f(x)[cls]                     LayerNorm eps 1e-6

The tiles come from the eval transform in [-1, 1]; the encoder first maps
them to UNI's input, ((x + 1) / 2 - mean) / std with ImageNet's mean and
std, in float32. Module and parameter names are timm's, so a UNI
checkpoint loads with ``strict=True``. The patch embedding is the same sum
of products as timm's convolution, taken as one matrix product over the
flattened patches.

With ``compute_dtype`` the products (patch embedding, qkv, attention,
projection, MLP) take operands in that dtype, the weights cast on each
call as the ResNet's are; the residual stream, the LayerNorms and the
LayerScale stay in float32, as under autocast, and the features come out
in float32.
"""

from dataclasses import dataclass

import torch
from torch import nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .._device import resolve_device
from ..utils import profiling

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
LN_EPS = 1e-6


@dataclass(frozen=True)
class ViTConfig:
    """The encoder's sizes but its width (the head's ``L``): UNI's
    ViT-L/16 by default."""
    depth: int = 24
    heads: int = 16
    mlp: int = 4096
    patch: int = 16
    image: int = 224          # the tiles' side after the eval transform
    init_values: float = 1e-5  # LayerScale's initial gamma


class PatchEmbed(nn.Module):
    def __init__(self, dim, patch, device):
        super().__init__()
        self.proj = nn.Conv2d(3, dim, patch, patch, device=device)


class Attention(nn.Module):
    def __init__(self, dim, heads, device):
        super().__init__()
        self.heads = heads
        self.qkv = nn.Linear(dim, 3 * dim, device=device)
        self.proj = nn.Linear(dim, dim, device=device)


class LayerScale(nn.Module):
    def __init__(self, dim, device):
        super().__init__()
        self.gamma = nn.Parameter(torch.empty(dim, device=device))


class Mlp(nn.Module):
    def __init__(self, dim, hidden, device):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden, device=device)
        self.fc2 = nn.Linear(hidden, dim, device=device)


class Block(nn.Module):
    def __init__(self, dim, heads, hidden, device):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS, device=device)
        self.attn = Attention(dim, heads, device)
        self.ls1 = LayerScale(dim, device)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS, device=device)
        self.mlp = Mlp(dim, hidden, device)
        self.ls2 = LayerScale(dim, device)

    def forward(self, x, compute_dtype=None):
        """One pre-norm block over the float32 residual stream x [B, N, d]."""
        b, n, d = x.shape
        h = _lin(_ln(self.norm1, x), self.attn.qkv, compute_dtype)
        q, k, v = h.reshape(b, n, 3, self.attn.heads, -1).permute(
            2, 0, 3, 1, 4).unbind(0)                      # [B, heads, N, hd]
        a = F.scaled_dot_product_attention(q, k, v)
        a = _lin(a.transpose(1, 2).reshape(b, n, d), self.attn.proj,
                 compute_dtype)
        x = torch.addcmul(x, self.ls1.gamma, a)
        h = F.gelu(_lin(_ln(self.norm2, x), self.mlp.fc1, compute_dtype))
        return torch.addcmul(x, self.ls2.gamma,
                             _lin(h, self.mlp.fc2, compute_dtype))


class ViT(nn.Module):
    """Tiles [B, S, S, 3] (NHWC, in [-1, 1]) -> features [B, dim]. Its
    parameters lie on ``device``: the card unless the CPU (or ``"meta"``)
    is asked for."""

    def __init__(self, dim: int, cfg: ViTConfig = ViTConfig(), device=None):
        super().__init__()
        device = resolve_device(device)
        if cfg.image % cfg.patch or dim % cfg.heads:
            raise ValueError(f"a {cfg.image} px tile does not split into "
                             f"{cfg.patch} px patches, or {dim} into "
                             f"{cfg.heads} heads")
        self.cfg = cfg
        self.tokens = 1 + (cfg.image // cfg.patch) ** 2
        self.cls_token = nn.Parameter(torch.empty(1, 1, dim, device=device))
        self.pos_embed = nn.Parameter(torch.empty(1, self.tokens, dim,
                                                  device=device))
        self.patch_embed = PatchEmbed(dim, cfg.patch, device)
        self.blocks = nn.ModuleList(Block(dim, cfg.heads, cfg.mlp, device)
                                    for _ in range(cfg.depth))
        self.norm = nn.LayerNorm(dim, eps=LN_EPS, device=device)

    @torch.no_grad()
    def reset_parameters(self, generator):
        """timm's init, drawn from ``generator``: linears and ``pos_embed``
        truncated normal (std 0.02, cut at +-2), zero biases; ``cls_token``
        normal (std 1e-6); the patch convolution PyTorch's default (uniform
        within 1 / sqrt(fan_in)); LayerNorms one and zero; every LayerScale
        gamma ``init_values``."""
        def normal(p, std):
            p.copy_(torch.randn(p.shape, generator=generator,
                                device=generator.device) * std)

        def trunc_normal(p):
            p.copy_((torch.randn(p.shape, generator=generator,
                                 device=generator.device) * 0.02)
                    .clamp_(-2.0, 2.0))

        def uniform(p, bound):
            p.copy_((torch.rand(p.shape, generator=generator,
                                device=generator.device) * 2 - 1) * bound)

        trunc_normal(self.pos_embed)
        normal(self.cls_token, 1e-6)
        proj = self.patch_embed.proj
        bound = proj.weight[0].numel() ** -0.5
        uniform(proj.weight, bound)
        uniform(proj.bias, bound)
        for m in self.modules():
            if isinstance(m, nn.Linear):
                trunc_normal(m.weight)
                m.bias.zero_()
            elif isinstance(m, nn.LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
            elif isinstance(m, LayerScale):
                m.gamma.fill_(self.cfg.init_values)

    def forward(self, tiles, *, compute_dtype=None, remat: bool = False):
        """``remat=True`` keeps only each block's input for the backward
        pass and recomputes the rest there (a no-op without autograd)."""
        b, s = tiles.shape[0], tiles.shape[1]
        if s != self.cfg.image or tiles.shape[2] != s:
            raise ValueError(f"the encoder takes {self.cfg.image} px tiles, "
                             f"not {tuple(tiles.shape[1:3])}")
        mean = torch.tensor(IMAGENET_MEAN, device=tiles.device)
        std = torch.tensor(IMAGENET_STD, device=tiles.device)
        x = ((tiles.float() + 1.0) * 0.5 - mean) / std
        if compute_dtype is not None:
            x = x.to(compute_dtype)
        p, g = self.cfg.patch, s // self.cfg.patch
        # [B, g, p, g, p, 3] -> one row (3, p, p) a patch, the conv's order
        patches = x.reshape(b, g, p, g, p, 3).permute(0, 1, 3, 5, 2, 4)
        w = self.patch_embed.proj.weight
        x = _matmul(patches.reshape(b * g * g, -1), w.reshape(w.shape[0], -1),
                    self.patch_embed.proj.bias, compute_dtype)
        x = torch.cat([self.cls_token.expand(b, 1, -1),
                       x.reshape(b, g * g, -1).float()], dim=1) \
            + self.pos_embed
        for block in self.blocks:
            if remat and torch.is_grad_enabled():
                x = checkpoint(block, x, compute_dtype, use_reentrant=False)
            else:
                x = block(x, compute_dtype)
        return _ln(self.norm, x[:, 0])


def _ln(norm, x):
    return F.layer_norm(x, norm.normalized_shape, norm.weight, norm.bias,
                        norm.eps)


def _matmul(x, w, b, compute_dtype):
    """``x @ w.T + b`` with both operands in ``compute_dtype``."""
    if compute_dtype is not None:
        x, w, b = x.to(compute_dtype), w.to(compute_dtype), b.to(compute_dtype)
    return F.linear(x, w, b)


def _lin(x, layer, compute_dtype):
    return _matmul(x, layer.weight, layer.bias, compute_dtype)


def apply_vit(model: ViT, tiles, *, compute_dtype=None, remat: bool = False):
    """Forward: tiles [B, S, S, 3] in [-1, 1] -> float32 features [B, dim],
    under the span ``port.vit``; counts the tiles (``vit.tiles``) and their
    tokens (``vit.tokens``) while a profiler records."""
    profiling.count("vit.tiles", tiles.shape[0])
    profiling.count("vit.tokens", tiles.shape[0] * model.tokens)
    with profiling.annotate("port.vit"):
        return model(tiles, compute_dtype=compute_dtype, remat=remat)
