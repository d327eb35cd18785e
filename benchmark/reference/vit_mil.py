"""Plain reference of ``uni_vitl16_mil``: UNI's ViT-L/16 as the tile
embedder under the gated attention head, in float32.

After UNI's model card (huggingface.co/MahmoodLab/UNI: timm
``vit_large_patch16_224``, ``img_size=224``, ``patch_size=16``,
``init_values=1e-5``, ``num_classes=0``; Chen et al., Nature Medicine 30,
2024). With N = 1 + (S / p)^2 tokens of width d for tiles of S px: the
tile in [0, 1] normalised by ImageNet's mean and std; a p x p stride-p
convolution with bias to d channels, flattened to tokens after a class
token, plus a learned position embedding; then each of the blocks, pre-norm
(LayerNorm eps 1e-6):
x += g1 * Proj(MHSA(LN1(x))) with qkv and proj biases and attention written
out as softmax(Q K^T / sqrt(d / heads)) V, and x += g2 * FC2(GELU(FC1(LN2(x))))
with GELU in its erf form; the feature is LN_f(x) of the class token.
Imports nothing of the program under test.

Departures from UNI's pipeline:

* the resize from the tile's 256 px to 224 is the anti-aliased bilinear
  ``F.interpolate`` on float tiles (:func:`common.resize`), as the port's
  eval transform runs it; UNI's ``transforms.Resize(224)`` on a PIL image
  is PIL's anti-aliased bilinear, which rounds its output to uint8, and
  torchvision's resize of a tensor differs from both by a few levels;
* the normalisation is applied to the eval transform's [-1, 1] tiles as
  ((x + 1) / 2 - mean) / std, the same values as ToTensor then Normalize
  up to float32 rounding;
* the weights are drawn from the seed (UNI's trained weights are gated),
  and every LayerScale gamma is the configuration's ``gamma_weights``, not
  ``init_values`` (under 1e-5 every tile's feature is the same to about
  1e-5, and the head's batch norm over the bag would divide round-off).
"""

import math

import torch

from . import common as C

MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)
LN_EPS = 1e-6


def sizes(cfg):
    """The encoder's sizes at the configuration's ``width_mult``, read as
    the critic reads it: width d, heads (of d / heads), MLP width, patch,
    the side tiles are resized to (at most the tile's), depth."""
    wm = cfg["width_mult"]
    return {"dim": int(cfg["dim"] * wm), "heads": max(1, int(cfg["heads"] * wm)),
            "mlp": int(cfg["mlp_dim"] * wm), "patch": cfg["patch"],
            "image": min(cfg["resolution"], cfg["tile_px"]),
            "depth": cfg["depth"]}


def tokens(cfg):
    s = sizes(cfg)
    return 1 + (s["image"] // s["patch"]) ** 2


def param_shapes(cfg):
    """name -> (shape, init) for every parameter, timm's names under
    ``cnn.`` and the head's. Linears and the position embedding normal
    (std 0.02, timm's truncated normal without the cut it never reaches),
    zero biases; the class token normal (std 1e-6); the patch convolution
    normal with PyTorch's default variance (std 1 / sqrt(3 fan_in)), zero
    bias; LayerNorms one and zero; LayerScale ``gamma_weights``."""
    s = sizes(cfg)
    d, n = s["dim"], tokens(cfg)
    fan = 3 * s["patch"] ** 2
    out = {"cnn.cls_token": ((1, 1, d), ("normal", 1e-6)),
           "cnn.pos_embed": ((1, n, d), ("normal", 0.02)),
           "cnn.patch_embed.proj.weight": ((d, 3, s["patch"], s["patch"]),
                                           ("normal", 1 / math.sqrt(3 * fan))),
           "cnn.patch_embed.proj.bias": ((d,), ("const", 0.0))}

    def linear(name, dout, din):
        out[name + ".weight"] = ((dout, din), ("normal", 0.02))
        out[name + ".bias"] = ((dout,), ("const", 0.0))

    def norm(name):
        out[name + ".weight"] = ((d,), ("const", 1.0))
        out[name + ".bias"] = ((d,), ("const", 0.0))

    for i in range(s["depth"]):
        p = f"cnn.blocks.{i}"
        norm(p + ".norm1")
        linear(p + ".attn.qkv", 3 * d, d)
        linear(p + ".attn.proj", d, d)
        out[p + ".ls1.gamma"] = ((d,), ("const", cfg["gamma_weights"]))
        norm(p + ".norm2")
        linear(p + ".mlp.fc1", s["mlp"], d)
        linear(p + ".mlp.fc2", d, s["mlp"])
        out[p + ".ls2.gamma"] = ((d,), ("const", cfg["gamma_weights"]))
    norm("cnn.norm")
    out.update(C.head_shapes(d, cfg["D"], cfg["K"], cfg["O"]))
    return out


def layer_norm(x, w, b):
    mu = x.mean(dim=-1, keepdim=True)
    var = ((x - mu) ** 2).mean(dim=-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + LN_EPS) * w + b


def gelu(x):
    return 0.5 * x * (1.0 + torch.erf(x / math.sqrt(2.0)))


def attention(q, k, v, prec):
    """softmax(Q K^T / sqrt(hd)) V over [B, heads, N, hd], the softmax in
    float32."""
    s = C.rounded(q, prec) @ C.rounded(k, prec).transpose(-1, -2)
    p = torch.softmax(s / math.sqrt(q.shape[-1]), dim=-1)
    return C.rounded(p, prec) @ C.rounded(v, prec)


def encode(w, x, cfg, *, prec="f32"):
    """float32 NCHW tiles [B, 3, S, S] in [-1, 1] -> features [B, d]."""
    s = sizes(cfg)
    mean = torch.tensor(MEAN, device=x.device).reshape(1, 3, 1, 1)
    std = torch.tensor(STD, device=x.device).reshape(1, 3, 1, 1)
    x = ((x + 1.0) * 0.5 - mean) / std
    x = C.conv(x, w["cnn.patch_embed.proj.weight"],
               w["cnn.patch_embed.proj.bias"], stride=s["patch"], prec=prec)
    b, d = x.shape[0], x.shape[1]
    x = x.flatten(2).transpose(1, 2)                          # [B, N - 1, d]
    x = torch.cat([w["cnn.cls_token"].expand(b, 1, d), x], dim=1) \
        + w["cnn.pos_embed"]
    h = s["heads"]
    for i in range(s["depth"]):
        p = f"cnn.blocks.{i}"
        y = layer_norm(x, w[p + ".norm1.weight"], w[p + ".norm1.bias"])
        qkv = C.linear(y, w[p + ".attn.qkv.weight"], w[p + ".attn.qkv.bias"],
                       prec=prec)
        q, k, v = qkv.reshape(b, -1, 3, h, d // h).permute(2, 0, 3, 1, 4)
        a = attention(q, k, v, prec).transpose(1, 2).reshape(b, -1, d)
        x = x + w[p + ".ls1.gamma"] * C.linear(
            a, w[p + ".attn.proj.weight"], w[p + ".attn.proj.bias"],
            prec=prec)
        y = layer_norm(x, w[p + ".norm2.weight"], w[p + ".norm2.bias"])
        y = gelu(C.linear(y, w[p + ".mlp.fc1.weight"], w[p + ".mlp.fc1.bias"],
                          prec=prec))
        x = x + w[p + ".ls2.gamma"] * C.linear(
            y, w[p + ".mlp.fc2.weight"], w[p + ".mlp.fc2.bias"], prec=prec)
    return layer_norm(x[:, 0], w["cnn.norm.weight"], w["cnn.norm.bias"])


def features(w, raw_u8, cfg, *, block=64, prec="f32"):
    """Features [T, d] of a slide's uint8 tiles [T, H, W, 3] on the
    weights' device, ``block`` tiles at a time."""
    dev = w["cnn.pos_embed"].device
    image = sizes(cfg)["image"]
    parts = []
    with torch.no_grad():
        for lo in range(0, raw_u8.shape[0], block):
            x = torch.as_tensor(raw_u8[lo:lo + block]).to(dev)
            parts.append(encode(w, C.eval_tiles(x, image), cfg, prec=prec))
    return torch.cat(parts)


def slide(w, raw_u8, cfg, *, prec="f32", head_prec=None):
    """One slide's probs, Mterm and Aterm (host arrays); the head's
    products in ``head_prec`` where given, else in ``prec``."""
    with C.exact(), torch.no_grad():
        H = features(w, raw_u8, cfg, prec=prec)
        out = C.head(w, H, n_classes=cfg["n_classes"],
                     prec=head_prec or prec)
    return {k: v.float().cpu().numpy() for k, v in out.items()}


def tile_flops(cfg):
    """The analytic forward FLOPs of one tile (``benchmark/vit_flops.py``)."""
    from .. import vit_flops

    return vit_flops.tile_flops(cfg)
