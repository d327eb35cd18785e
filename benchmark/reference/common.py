"""What both plain references share: the precision of their products, the
tile transforms and the gated attention-MIL head.

Plain PyTorch in float32, written from the published description of the
model (gbm/model.py:89-264 of the reference repository, after Ilse et al.,
arXiv:1802.04712). Imports nothing of the program under test and takes
nothing it made: the weights are the benchmark's, the tiles the raw uint8
ones.

``prec`` names the arithmetic of every convolution and matrix product:

* ``"f32"``: float32 with TF32 off (:func:`exact`), the reference proper;
* ``"bf16"``: both operands rounded to bfloat16, the product accumulated
  in float32 (a control for float32 with TF32 on);
* ``"fp8"``: both operands scaled by their largest magnitude and rounded
  to float8 e4m3, the product accumulated in float32 (a control for
  bfloat16).

Reductions, normalisations and the softmax stay in float32 in all three.
"""

import contextlib
import math

import torch
import torch.nn.functional as F

FP8_MAX = 448.0  # the largest finite float8 e4m3 value


@contextlib.contextmanager
def exact():
    """float32 products without TF32, restored on exit."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


def rounded(x, prec):
    """``x`` as the operand of a product in ``prec``, held in float32. The
    rounding is the forward's; the gradient passes through it unchanged."""
    if prec == "f32":
        return x
    if prec == "bf16":
        q = x.to(torch.bfloat16).float()
    elif prec == "fp8":
        scale = x.detach().abs().amax().clamp_min(1e-30) / FP8_MAX
        q = (x / scale).to(torch.float8_e4m3fn).float() * scale
    else:
        raise ValueError(f"unknown precision {prec!r}")
    return x + (q - x).detach()


def conv(x, w, b=None, *, stride=1, padding=0, prec="f32", groups=1):
    return F.conv2d(rounded(x, prec), rounded(w, prec), b, stride=stride,
                    padding=padding, groups=groups)


def linear(x, w, b=None, *, prec="f32"):
    """``x @ w.T + b`` with ``w`` [out, in], as nn.Linear stores it."""
    out = rounded(x, prec) @ rounded(w, prec).T
    return out if b is None else out + b


def lrelu(x, slope):
    return torch.where(x >= 0, x, slope * x)


def resize(x_nchw, size):
    """Anti-aliased bilinear resize (PIL's, which the reference's
    torchvision Resize used); none when the size already fits."""
    if x_nchw.shape[-1] == size and x_nchw.shape[-2] == size:
        return x_nchw
    return F.interpolate(x_nchw, size=(size, size), mode="bilinear",
                         align_corners=False, antialias=True)


def eval_tiles(raw_u8, resolution):
    """uint8 [N, H, W, 3] -> float32 NCHW in [-1, 1]: Resize, ToTensor,
    Normalize(0.5, 0.5) (reference RoiBuilder.py:193-210)."""
    x = raw_u8.permute(0, 3, 1, 2).float() / 255.0
    return (resize(x, resolution) - 0.5) / 0.5


def train_tiles(raw_u8, offsets, flip_h, flip_v, *, pad, resolution):
    """The training transform: zero-pad by ``pad``, crop the tile's own
    size at ``offsets`` [N, 2] (row, column), flip left-right where
    ``flip_h``, upside-down where ``flip_v``, resize, normalise. Returns
    float32 NCHW."""
    n, h, w, _ = raw_u8.shape
    x = F.pad(raw_u8.permute(0, 3, 1, 2).float(), (pad, pad, pad, pad))
    out = torch.empty((n, 3, h, w), dtype=torch.float32, device=x.device)
    for i in range(n):
        r, c = int(offsets[i, 0]), int(offsets[i, 1])
        t = x[i, :, r:r + h, c:c + w]
        if bool(flip_h[i]):
            t = t.flip(-1)
        if bool(flip_v[i]):
            t = t.flip(-2)
        out[i] = t
    return (resize(out / 255.0, resolution) - 0.5) / 0.5


# ----------------------------------------------------------------- head
HEAD_SLOPE = 0.1


def head_shapes(L, D, K, O):
    """The head's parameters: name -> (shape, init), the reference's
    state-dict names. ``init`` is ``("normal", std)`` or ``("const",
    value)``."""
    tanh_gain = 5.0 / 3.0
    lrelu_gain = math.sqrt(2.0 / (1.0 + HEAD_SLOPE ** 2))
    return {
        "context.bn.weight": ((L,), ("const", 1.0)),
        "context.bn.bias": ((L,), ("const", 0.0)),
        "attention.lin1.weight": ((D, L), ("normal", tanh_gain / math.sqrt(L))),
        "attention.lin1.bias": ((D,), ("const", 0.0)),
        "attention.lin2.weight": ((K, D), ("normal", tanh_gain / math.sqrt(D))),
        "attention.lin2.bias": ((K,), ("const", 0.0)),
        "buffer.lin1.weight": ((D, L), ("normal", lrelu_gain / math.sqrt(L))),
        "buffer.lin1.bias": ((D,), ("const", 0.0)),
        "buffer.classifier.weight": ((O, D), ("normal",
                                              math.sqrt(2.0 / (D + O)))),
        "buffer.classifier.bias": ((O,), ("const", 0.0)),
        "weight_mask": ((K,), ("const", 0.25)),
    }


def softplus(x):
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-x.abs()))


def head(w, H, *, n_classes, label=None, smoothing=0.25, dropout=0.25,
         keep=None, prec="f32"):
    """The gated attention head over one bag's features ``H`` [T, L]
    (float32): the context layer (a batch norm over the bag's tiles, biased
    variance, eps 1e-5; a LeakyReLU branch, dropped out where ``keep`` [T,
    L] is False), the tanh attention MLP to K maps, the LeakyReLU
    instance-code MLP to O outputs, the gate sigmoid(-10 w) * softplus(a) +
    sigmoid(10 w), L1-normalised over the tiles, M = A^T B, logits M as
    [1, K * O]. Returns probs [C], Mterm [K, O], Aterm [K, T], the size
    of M's terms down to the features, ``Mscale`` [K, O] (each product
    and sum of the instance branch taken in absolute values: sum_t A_kt
    (|W_c| (|W_1| |Hm_t| + |b_1|) + |b_c|)_o, which bounds what a
    relative error of the features moves M by), the size of its terms at
    the instance outputs, ``Bscale`` = A^T |B| [K, O], and, given
    ``label``, the label-smoothed cross-entropy ``loss``."""
    mu = H.mean(dim=0, keepdim=True)
    var = ((H - mu) ** 2).mean(dim=0, keepdim=True)
    Hz = (H - mu) / torch.sqrt(var + 1e-5) * w["context.bn.weight"] \
        + w["context.bn.bias"]
    Hm = lrelu(H, HEAD_SLOPE)
    if keep is not None:
        Hm = torch.where(keep, Hm / (1.0 - dropout), torch.zeros_like(Hm))
    a = linear(torch.tanh(linear(Hz, w["attention.lin1.weight"],
                                 w["attention.lin1.bias"], prec=prec)),
               w["attention.lin2.weight"], w["attention.lin2.bias"],
               prec=prec)                                           # [T, K]
    b = linear(lrelu(linear(Hm, w["buffer.lin1.weight"],
                            w["buffer.lin1.bias"], prec=prec), HEAD_SLOPE),
               w["buffer.classifier.weight"], w["buffer.classifier.bias"],
               prec=prec)                                           # [T, O]
    wm = w["weight_mask"]
    gated = torch.sigmoid(-10.0 * wm) * softplus(a) + torch.sigmoid(10.0 * wm)
    A = gated / torch.clamp_min(gated.abs().sum(dim=0, keepdim=True), 1e-12)
    M = A.T @ b                                                     # [K, O]
    logits = M.reshape(1, -1)
    z = Hm.abs() @ w["buffer.lin1.weight"].abs().T \
        + w["buffer.lin1.bias"].abs()
    terms = z @ w["buffer.classifier.weight"].abs().T \
        + w["buffer.classifier.bias"].abs()                        # [T, O]
    out = {"probs": torch.softmax(logits, dim=1)[0], "Mterm": M,
           "Aterm": A.T, "Mscale": A.T @ terms, "Bscale": A.T @ b.abs()}
    if label is not None:
        off = smoothing / (n_classes - 1)
        target = torch.full((n_classes,), off, device=H.device)
        target[int(label)] = 1.0 - smoothing
        out["loss"] = -(target * torch.log_softmax(logits, dim=1)[0]).sum()
    return out


def subsample(scores, fraction):
    """The training subsample of a bag of ``T = len(scores)`` valid tiles:
    the ``max(1, int(T * fraction))`` highest Gumbel scores, equal scores
    lower index first (the reference's random choice of
    int(T * fraction) tiles, gbm/model.py:192-194)."""
    k = max(1, int(scores.shape[0] * fraction))
    return torch.sort(scores, descending=True, stable=True).indices[:k]
