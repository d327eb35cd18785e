"""Plain reference of ``resnet26_mil``: the live classifier's ResNet-26 tile
embedder and gated attention head, in float32.

After the reference repository's gbm/model.py:14-61 (the ResNet) and
89-264 (the head): a 7x7 stride-2 stem with bias, LeakyReLU(0.1), a 3x3
stride-2 max-pool; four stages of basic blocks (3x3 conv, LeakyReLU, 3x3
conv, plus a shortcut that is a 1x1 stride-s conv without bias where the
shape changes, LeakyReLU), no normalisation; a global mean and a linear
map to L features without bias. Imports nothing of the program under test.
"""

import math

import torch

from . import common as C

SLOPE = 0.1


def param_shapes(cfg):
    """name -> (shape, init) for every parameter, the reference's names
    (the embedder under ``cnn.``). Convolutions: Kaiming normal, fan out,
    LeakyReLU(0.1) gain, zero biases (gbm/model.py:161-181)."""
    gain = math.sqrt(2.0 / (1.0 + SLOPE ** 2))
    out = {}

    def conv(name, cout, cin, k, bias=True):
        out[name + ".weight"] = ((cout, cin, k, k),
                                 ("normal", gain / math.sqrt(cout * k * k)))
        if bias:
            out[name + ".bias"] = ((cout,), ("const", 0.0))

    widths, blocks = cfg["widths"], cfg["blocks"]
    conv("cnn.conv1", widths[0], 3, 7)
    cin = widths[0]
    for s, (wd, nb) in enumerate(zip(widths, blocks)):
        for b in range(nb):
            stride = 2 if (s > 0 and b == 0) else 1
            p = f"cnn.layer{s + 1}.{b}"
            conv(p + ".conv1", wd, cin, 3)
            conv(p + ".conv2", wd, wd, 3)
            if stride != 1 or cin != wd:
                conv(p + ".downsample.0", wd, cin, 1, bias=False)
            cin = wd
    out["cnn.fc.weight"] = ((cfg["L"], widths[-1]),
                            ("normal", gain / math.sqrt(widths[-1])))
    out.update(C.head_shapes(cfg["L"], cfg["D"], cfg["K"], cfg["O"]))
    return out


def embed(w, x, cfg, *, prec="f32"):
    """float32 NCHW tiles [N, 3, H, W] -> features [N, L]."""
    h = C.conv(x, w["cnn.conv1.weight"], w["cnn.conv1.bias"], stride=2,
               padding=3, prec=prec)
    h = torch.nn.functional.max_pool2d(C.lrelu(h, SLOPE), 3, 2, 1)
    cin = cfg["widths"][0]
    for s, (wd, nb) in enumerate(zip(cfg["widths"], cfg["blocks"])):
        for b in range(nb):
            stride = 2 if (s > 0 and b == 0) else 1
            p = f"cnn.layer{s + 1}.{b}"
            out = C.lrelu(C.conv(h, w[p + ".conv1.weight"],
                                 w[p + ".conv1.bias"], stride=stride,
                                 padding=1, prec=prec), SLOPE)
            out = C.conv(out, w[p + ".conv2.weight"], w[p + ".conv2.bias"],
                         padding=1, prec=prec)
            short = (C.conv(h, w[p + ".downsample.0.weight"], stride=stride,
                            prec=prec)
                     if stride != 1 or cin != wd else h)
            h = C.lrelu(out + short, SLOPE)
            cin = wd
    return C.linear(h.mean(dim=(2, 3)), w["cnn.fc.weight"], prec=prec)


def features(w, raw_u8, cfg, *, block=256, prec="f32"):
    """Features [T, L] of a slide's uint8 tiles [T, H, W, 3] on the
    weights' device, ``block`` tiles at a time."""
    dev = w["cnn.conv1.weight"].device
    parts = []
    with torch.no_grad():
        for lo in range(0, raw_u8.shape[0], block):
            x = torch.as_tensor(raw_u8[lo:lo + block]).to(dev)
            parts.append(embed(w, C.eval_tiles(x, cfg["tile_px"]), cfg,
                               prec=prec))
    return torch.cat(parts)


def slide(w, raw_u8, cfg, *, prec="f32", head_prec=None):
    """One slide's probs, Mterm and Aterm (host arrays); the head's
    products in ``head_prec`` where given, else in ``prec``."""
    with C.exact(), torch.no_grad():
        H = features(w, raw_u8, cfg, prec=prec)
        out = C.head(w, H, n_classes=cfg["n_classes"],
                     prec=head_prec or prec)
    return {k: v.float().cpu().numpy() for k, v in out.items()}


def bag_loss(w, raw_u8, noise, label, cfg, *, pad, prec="f32"):
    """One training bag's loss, with autograd on ``w``: the subsample of
    the tiles by ``noise["scores"]``, their training transform, the
    embedder and the head with ``noise["keep"]``'s dropout."""
    dev = w["cnn.conv1.weight"].device
    idx = C.subsample(noise["scores"], cfg["train_tile_fraction"])
    rows = idx.cpu().numpy()
    x = C.train_tiles(torch.as_tensor(raw_u8[rows]).to(dev),
                      noise["offsets"][idx], noise["flip_h"][idx],
                      noise["flip_v"][idx], pad=pad,
                      resolution=cfg["tile_px"])
    H = embed(w, x, cfg, prec=prec)
    return C.head(w, H, n_classes=cfg["n_classes"], label=label,
                  smoothing=cfg["smoothing"], dropout=cfg["dropout"],
                  keep=noise["keep"].to(dev), prec=prec)["loss"]


def train_steps(w0, windows, raw_of, cfg, *, lr, pad, prec="f32"):
    """The first Adam steps of training from the weights ``w0``, one a
    window of bags: the window's loss the mean of its bags', the gradient
    their sum, Adam with betas (0.9, 0.999) and eps 1e-8 (the reference's
    optimizer, gbm/classify_combined.py:388-454). ``windows``: lists of
    ``(offset, noise, label)``; ``raw_of(offset)`` the bag's uint8 tiles.
    Returns ``losses`` [steps], ``grad`` (leaf -> norm of the first step's
    gradient) and ``change`` (leaf -> norm of the parameters' change after
    the last step)."""
    b1, b2, eps = 0.9, 0.999, 1e-8
    w = {k: v.detach().clone().float().requires_grad_(True)
         for k, v in w0.items()}
    m = {k: torch.zeros_like(v) for k, v in w.items()}
    v2 = {k: torch.zeros_like(v) for k, v in w.items()}
    losses, grad = [], {}
    with C.exact():
        for t, window in enumerate(windows, start=1):
            total = 0.0
            for offset, noise, label in window:
                loss = bag_loss(w, raw_of(offset), noise, label, cfg,
                                pad=pad, prec=prec)
                loss.backward()
                total += float(loss.detach())
            losses.append(total / len(window))
            with torch.no_grad():
                for k, p in w.items():
                    g = p.grad if p.grad is not None else torch.zeros_like(p)
                    if t == 1:
                        grad[k] = float(torch.linalg.vector_norm(g))
                    m[k].mul_(b1).add_(g, alpha=1 - b1)
                    v2[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                    mhat = m[k] / (1 - b1 ** t)
                    vhat = v2[k] / (1 - b2 ** t)
                    p.sub_(lr * mhat / (torch.sqrt(vhat) + eps))
                    p.grad = None
    change = {k: float(torch.linalg.vector_norm(w[k].detach() - w0[k]))
              for k in w}
    return {"losses": losses, "grad": grad, "change": change}


def tile_flops(cfg):
    """The analytic forward FLOPs of one tile (``benchmark/flops.py``)."""
    from .. import flops

    return flops.resnet26_tile_flops(cfg)


def train_tile_flops(cfg):
    """The analytic training FLOPs of one subsampled tile
    (``benchmark/flops.py``)."""
    from .. import flops

    return flops.resnet26_train_tile_flops(cfg)
