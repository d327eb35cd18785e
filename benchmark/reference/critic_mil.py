"""Plain reference of ``critic_mil``: the legacy classifier, a StyleGAN
critic cut at ``disc_cutoff`` as a frozen tile embedder under the gated
attention head, in float32.

The critic is rosinality's progressive discriminator
(style-based-gan-pytorch, model.py:209-268 and 509-580): equalised-lr
convolutions (weights scaled by sqrt(2 / fan_in) when used), LeakyReLU(0.2),
a binomial 3x3 blur before each downsampling conv, the fused downsample
(the kernel zero-padded by one and averaged over its four shifts, stride
2) above 32 px and conv plus 2x2 average pool below, and in the last block
a minibatch-stddev plane. The legacy driver enters it at the tiles'
resolution step through from_rgb (a 1x1 conv and LeakyReLU) and runs the
blocks from that step down while ``i > step - cutoff``
(gbm/classify.py:33,37,116), then takes the spatial mean. Imports nothing
of the program under test.
"""

import math

import torch
import torch.nn.functional as F

from . import common as C

SLOPE = 0.2
# channels of the blocks at 4, 8, ..., 1024 px (model.py:380-390,512-521)
CHANNELS = (512, 512, 512, 512, 256, 128, 64, 32, 16)
BLUR = torch.tensor([[1.0, 2.0, 1.0], [2.0, 4.0, 2.0], [1.0, 2.0, 1.0]]) / 16.0


def layout(width_mult=1.0):
    """Blocks from the highest resolution down: (cin, cout, k1, pad1, k2,
    pad2, downsample, fused); the last takes the stddev plane."""
    ch = [max(4, int(c * width_mult)) for c in CHANNELS]
    return [
        (ch[8], ch[7], 5, 2, 5, 2, True, True),
        (ch[7], ch[6], 5, 2, 5, 2, True, True),
        (ch[6], ch[5], 5, 2, 5, 2, True, True),
        (ch[5], ch[4], 5, 2, 5, 2, True, True),
        (ch[4], ch[3], 3, 1, 3, 1, True, False),
        (ch[3], ch[2], 3, 1, 3, 1, True, False),
        (ch[2], ch[1], 3, 1, 3, 1, True, False),
        (ch[1], ch[0], 3, 1, 3, 1, True, False),
        (ch[0] + 1, ch[0], 3, 1, 4, 0, False, False),
    ], [ch[8], ch[7], ch[6], ch[5], ch[4], ch[3], ch[2], ch[1], ch[0]]


def blocks_run(step, cutoff):
    """The block steps the cut critic runs, from ``step`` down."""
    return list(range(step, max(step - cutoff, -1), -1))


def feature_dim(cfg):
    lay, _ = layout(cfg["width_mult"])
    return lay[len(lay) - blocks_run(cfg["step"], cfg["disc_cutoff"])[-1] - 1][1]


def param_shapes(cfg):
    """name -> (shape, init) of the whole critic (rosinality's names, under
    ``disc.``) and of the head (under ``head.``): raw N(0, 1) weights,
    zero biases, the blur's fixed kernels (``("value", tensor)``)."""
    lay, rgb = layout(cfg["width_mult"])
    out = {}
    for i, (cin, cout, k1, _, k2, _, down, fused) in enumerate(lay):
        p = f"disc.progression.{i}"
        out[p + ".conv1.0.conv.weight_orig"] = ((cout, cin, k1, k1),
                                                ("normal", 1.0))
        out[p + ".conv1.0.conv.bias"] = ((cout,), ("const", 0.0))
        if down:
            kernel = ("value", BLUR.reshape(1, 1, 3, 3).repeat(cout, 1, 1, 1))
            out[p + ".conv2.0.weight"] = ((cout, 1, 3, 3), kernel)
            out[p + ".conv2.0.weight_flip"] = ((cout, 1, 3, 3), kernel)
            if fused:
                out[p + ".conv2.1.weight"] = ((cout, cout, k2, k2),
                                              ("normal", 1.0))
                out[p + ".conv2.1.bias"] = ((cout,), ("const", 0.0))
            else:
                out[p + ".conv2.1.conv.weight_orig"] = ((cout, cout, k2, k2),
                                                        ("normal", 1.0))
                out[p + ".conv2.1.conv.bias"] = ((cout,), ("const", 0.0))
        else:
            out[p + ".conv2.0.conv.weight_orig"] = ((cout, cout, k2, k2),
                                                    ("normal", 1.0))
            out[p + ".conv2.0.conv.bias"] = ((cout,), ("const", 0.0))
    for i, c in enumerate(rgb):
        out[f"disc.from_rgb.{i}.0.conv.weight_orig"] = ((c, 3, 1, 1),
                                                        ("normal", 1.0))
        out[f"disc.from_rgb.{i}.0.conv.bias"] = ((c,), ("const", 0.0))
    out["disc.linear.linear.weight_orig"] = ((1, lay[-1][1]), ("normal", 1.0))
    out["disc.linear.linear.bias"] = ((1,), ("const", 0.0))
    L = feature_dim(cfg)
    for k, v in C.head_shapes(L, cfg["D"], cfg["K"], cfg["O"]).items():
        out["head." + k] = v
    return out


def _eq(w):
    return w * math.sqrt(2.0 / w[0].numel())


def blur(x, prec):
    k = BLUR.to(x.device).reshape(1, 1, 3, 3).repeat(x.shape[1], 1, 1, 1)
    return C.conv(x, k, padding=1, groups=x.shape[1], prec=prec)


def fused_kernel(w):
    w = F.pad(w, (1, 1, 1, 1))
    return (w[:, :, 1:, 1:] + w[:, :, :-1, 1:] + w[:, :, 1:, :-1]
            + w[:, :, :-1, :-1]) / 4.0


def block(w, i, spec, x, prec):
    cin, cout, k1, p1, k2, p2, down, fused = spec
    p = f"disc.progression.{i}"
    x = C.lrelu(C.conv(x, _eq(w[p + ".conv1.0.conv.weight_orig"]),
                       w[p + ".conv1.0.conv.bias"], padding=p1, prec=prec),
                SLOPE)
    if down and fused:
        x = C.conv(blur(x, prec), fused_kernel(_eq(w[p + ".conv2.1.weight"])),
                   w[p + ".conv2.1.bias"], stride=2, padding=p2, prec=prec)
    elif down:
        x = C.conv(blur(x, prec), _eq(w[p + ".conv2.1.conv.weight_orig"]),
                   w[p + ".conv2.1.conv.bias"], padding=p2, prec=prec)
        x = F.avg_pool2d(x, 2)
    else:
        x = C.conv(x, _eq(w[p + ".conv2.0.conv.weight_orig"]),
                   w[p + ".conv2.0.conv.bias"], padding=p2, prec=prec)
    return C.lrelu(x, SLOPE)


def stddev_plane(x):
    """The minibatch-stddev feature map over the whole bag."""
    mu = x.mean(dim=0)
    s = torch.sqrt(((x - mu) ** 2).mean(dim=0) + 1e-8).mean()
    return torch.cat([x, s.expand(x.shape[0], 1, x.shape[2], x.shape[3])], 1)


def features(w, raw_u8, cfg, *, block_tiles=128, prec="f32"):
    """Features [T, C] of a slide's uint8 tiles: the blocks above 4 px
    ``block_tiles`` tiles at a time, the last block over the whole bag."""
    lay, _ = layout(cfg["width_mult"])
    n = len(lay)
    steps = blocks_run(cfg["step"], cfg["disc_cutoff"])
    dev = w["disc.linear.linear.bias"].device

    def run(x, ids):
        for i in ids:
            idx = n - i - 1
            if i == cfg["step"]:
                x = C.lrelu(C.conv(
                    x, _eq(w[f"disc.from_rgb.{idx}.0.conv.weight_orig"]),
                    w[f"disc.from_rgb.{idx}.0.conv.bias"], prec=prec), SLOPE)
            if i == 0:
                x = stddev_plane(x)
            x = block(w, idx, lay[idx], x, prec)
        return x

    per_tile = [i for i in steps if i > 0]
    parts = []
    with torch.no_grad():
        for lo in range(0, raw_u8.shape[0], block_tiles):
            x = torch.as_tensor(raw_u8[lo:lo + block_tiles]).to(dev)
            parts.append(run(C.eval_tiles(x, cfg["tile_px"]), per_tile))
        out = torch.cat(parts)
        if steps[-1] == 0:
            out = run(out, [0] if per_tile else steps)
    return out.mean(dim=(2, 3))


def slide(w, raw_u8, cfg, *, prec="f32", head_prec=None):
    """One slide's probs, Mterm and Aterm (host arrays); the head's
    products in ``head_prec`` where given, else in ``prec``."""
    head_w = {k[len("head."):]: v for k, v in w.items()
              if k.startswith("head.")}
    with C.exact(), torch.no_grad():
        H = features(w, raw_u8, cfg, prec=prec)
        out = C.head(head_w, H, n_classes=cfg["n_classes"],
                     prec=head_prec or prec)
    return {k: v.float().cpu().numpy() for k, v in out.items()}


def tile_flops(cfg):
    """The analytic forward FLOPs of one tile (``benchmark/flops.py``)."""
    from .. import flops

    return flops.critic_tile_flops(cfg)
