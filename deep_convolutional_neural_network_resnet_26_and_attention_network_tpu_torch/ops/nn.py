"""NN primitives with the JAX package's layouts and compute-dtype policy.

The public functions take NHWC activations, HWIO conv kernels and
``[in, out]`` linear weights, like ``ops/nn.py`` of the JAX package. An
NHWC tensor permuted to NCHW is exactly a ``channels_last`` NCHW tensor,
so the layout change costs no copy. ``conv2d_nchw`` is the same conv for
callers that already hold NCHW activations and OIHW kernels (the ResNet
module).

Compute dtype: conv and linear cast their operands to ``compute_dtype``
and the output STAYS in it, with the bias added in it, as in the JAX
package; reductions and normalisations run in float32.

``tile_count`` and ``batch_norm_tiles`` take the tile group of a bag whose
tile axis is split across ranks (``group``, ``ops/collectives.py``): their
sums over tiles are then the whole bag's.
"""

import torch
import torch.nn.functional as F

from .collectives import all_reduce_, all_reduce_sum

LEAKY_SLOPE = 0.1  # reference uses LeakyReLU(0.1) everywhere (gbm/model.py:25)


class _LeakyReLU(torch.autograd.Function):
    """``F.leaky_relu`` whose derivative at 0 is 1, as that of the JAX
    package's ``where(x >= 0, x, slope * x)``; PyTorch's own takes the
    slope there, which moves a gradient wherever a pre-activation is
    exactly 0 (a black tile through zero biases)."""

    @staticmethod
    def forward(ctx, x, negative_slope):
        ctx.save_for_backward(x)
        ctx.negative_slope = negative_slope
        return F.leaky_relu(x, negative_slope)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return torch.where(x >= 0, g, g * ctx.negative_slope), None


def leaky_relu(x, negative_slope: float = LEAKY_SLOPE):
    """LeakyReLU; under autograd with the JAX package's derivative at 0
    (:class:`_LeakyReLU`), otherwise PyTorch's single kernel."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _LeakyReLU.apply(x, negative_slope)
    return F.leaky_relu(x, negative_slope)


def relu(x):
    """ReLU as the JAX package's ``jnp.maximum(x, 0.0)``: one kernel, and
    under autograd the derivative at 0 is 0.5 (``torch.maximum`` splits a
    tie's gradient, as JAX does), where ``F.relu``'s is 0."""
    return torch.maximum(x, x.new_zeros(()))


def _pairs(padding):
    """int | [(lo, hi), (lo, hi)] -> ((h_lo, h_hi), (w_lo, w_hi))."""
    if isinstance(padding, int):
        return (padding, padding), (padding, padding)
    (h_lo, h_hi), (w_lo, w_hi) = padding
    return (int(h_lo), int(h_hi)), (int(w_lo), int(w_hi))


def conv2d_nchw(x, w, b=None, *, stride=1, padding=0, compute_dtype=None):
    """Cross-correlation of NCHW ``x`` with an OIHW ``w``.

    ``padding`` is an int or the JAX form ``[(h_lo, h_hi), (w_lo, w_hi)]``;
    an asymmetric pair is applied with ``F.pad`` before the conv."""
    if compute_dtype is not None:
        x, w = x.to(compute_dtype), w.to(compute_dtype)
    (h_lo, h_hi), (w_lo, w_hi) = _pairs(padding)
    if h_lo == h_hi and w_lo == w_hi:
        pad = (h_lo, w_lo)
    else:
        x = F.pad(x, (w_lo, w_hi, h_lo, h_hi))
        pad = 0
    bias = None if b is None else b.to(x.dtype)
    return F.conv2d(x, w, bias, stride=stride, padding=pad)


def conv2d(x, w, b=None, *, stride=1, padding=0, compute_dtype=None):
    """2D convolution, x: [N,H,W,C], w: [kh,kw,cin,cout] (HWIO) -> NHWC."""
    out = conv2d_nchw(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), b,
                      stride=stride, padding=padding,
                      compute_dtype=compute_dtype)
    return out.permute(0, 2, 3, 1)


def max_pool(x, *, window=3, stride=2, padding=1):
    """Max pool over H,W of [N,H,W,C], -inf padding (torch semantics)."""
    out = F.max_pool2d(x.permute(0, 3, 1, 2), window, stride, padding)
    return out.permute(0, 2, 3, 1)


def global_avg_pool(x):
    """AdaptiveAvgPool2d((1,1)) + flatten: [N,H,W,C] -> [N,C]."""
    return x.mean(dim=(1, 2))


def linear(x, w, b=None, *, compute_dtype=None):
    """x: [..., in] @ w: [in, out] (+ b)."""
    if compute_dtype is not None:
        x, w = x.to(compute_dtype), w.to(compute_dtype)
    out = x @ w
    if b is not None:
        out = out + b.to(out.dtype)
    return out


def tile_count(x, mask=None, group=None):
    """The count of the valid rows (axis 0) of ``x``, at least 1, as a
    tensor of one element: with ``group`` the whole bag's, one all-reduce
    of 4 bytes. A bag split over a group counts once and hands the count
    to each of its means (:func:`batch_norm_tiles`, the bag's metrics)."""
    n = (torch.full((1,), float(x.shape[0]), dtype=x.dtype, device=x.device)
         if mask is None else mask.to(x.dtype).sum().reshape(1))
    return torch.clamp_min(all_reduce_(n.detach(), group), 1.0)


def _group_mean(x, m, n, group):
    """The mean over the whole bag's rows of ``x`` [t, C], this rank's rows
    weighted ``m`` [t, 1] of ``n`` (:func:`tile_count`): one all-reduce."""
    return all_reduce_sum((x * m).sum(dim=0, keepdim=True), group) / n


def masked_mean(x, mask=None, axis=0, keepdims=False):
    """Mean over `axis`, counting only mask>0 rows. mask broadcasts on axis."""
    if mask is None:
        return x.mean(dim=axis, keepdim=keepdims)
    shape = [1] * x.ndim
    shape[axis] = x.shape[axis]
    m = mask.reshape(shape).to(x.dtype)
    n = torch.clamp_min(m.sum(dim=axis, keepdim=keepdims), 1.0)
    return (x * m).sum(dim=axis, keepdim=keepdims) / n


def batch_norm_tiles(x, gamma, beta, *, mask=None, eps=1e-5, group=None,
                     count=None):
    """BatchNorm1d(track_running_stats=False) over the tile axis (axis 0),
    with biased variance; ``mask`` restricts the statistics to valid
    (un-padded) tiles. With ``group`` the statistics are the whole bag's:
    the count (``count``, :func:`tile_count`, or one all-reduce when not
    given), then two all-reduces, sum x * m and the centred sum
    (x - mu)^2 * m (the JAX package's ``shard_pool.py:55-59``)."""
    if group is not None:
        m = (torch.ones((x.shape[0], 1), dtype=x.dtype, device=x.device)
             if mask is None else mask.reshape(-1, 1).to(x.dtype))
        n = tile_count(x, mask, group) if count is None else count
        mu = _group_mean(x, m, n, group)
        var = _group_mean((x - mu) ** 2, m, n, group)
    else:
        mu = masked_mean(x, mask, axis=0, keepdims=True)
        var = masked_mean((x - mu) ** 2, mask, axis=0, keepdims=True)
    xhat = (x - mu) * torch.rsqrt(var + eps)
    return xhat * gamma + beta


def dropout(x, rate, keep, *, train: bool):
    """torch.nn.Dropout with an explicit boolean ``keep`` mask (so tests can
    inject the same mask into both packages): zero where ``keep`` is
    False, scale the kept values by 1/(1-rate)."""
    if not train or rate <= 0.0:
        return x
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


def l1_normalize(x, axis=0, eps=1e-12):
    """F.normalize(p=1): x / max(sum|x|, eps) along axis."""
    denom = torch.clamp_min(x.abs().sum(dim=axis, keepdim=True), eps)
    return x / denom


def l2_normalize(x, axis=0, eps=1e-12):
    """F.normalize(p=2): x / max(||x||_2, eps) along axis."""
    sq = (x * x).sum(dim=axis, keepdim=True)
    return x / torch.clamp_min(torch.sqrt(sq), eps)


def softplus(x):
    """log(1 + e^x) in the form of ``jax.nn.softplus`` (no threshold)."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-x.abs()))
