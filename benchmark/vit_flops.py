"""Analytic operations and bytes of the ViT encoder (``uni_vitl16_mil``),
counted from its sizes alone (``reference/vit_mil.sizes``), whatever
implements them.

With N tokens of width d, an MLP of width m and P = N - 1 patches of p x p
pixels, one tile costs: the patch embedding 2 P (3 p^2) d; a layer's linear
maps 2 N d (3d + d + 2m), 24 N d^2 at m = 4d; its attention 4 N^2 d (Q K^T
and the product with V, over all heads). Elementwise work (LayerNorm,
GELU, softmax, LayerScale, residuals) is left out. At 224 px, d 1024,
24 layers: 119.0 GFLOP of linear maps, 3.8 of attention, 0.31 of patch
embedding, 123.1 in all.
"""

from .reference import vit_mil


def linear_flops(cfg):
    """FLOPs of one tile's matrix products by weights: the patch embedding
    and every layer's qkv, projection and MLP."""
    s = vit_mil.sizes(cfg)
    n, d, m = vit_mil.tokens(cfg), s["dim"], s["mlp"]
    patch = 2.0 * (n - 1) * 3 * s["patch"] ** 2 * d
    return patch + s["depth"] * 2.0 * n * d * (4 * d + 2 * m)


def attention_cost(cfg, dtype_bytes=2):
    """(FLOPs, bytes) of one tile's attention in one layer: Q K^T and the
    product with V over all heads (4 N^2 d), reading Q, K and V and
    writing the output once (4 N d elements of ``dtype_bytes``)."""
    s = vit_mil.sizes(cfg)
    n, d = vit_mil.tokens(cfg), s["dim"]
    return 4.0 * n * n * d, 4.0 * n * d * dtype_bytes


def tile_flops(cfg):
    """The encoder's forward FLOPs for one tile."""
    return linear_flops(cfg) + vit_mil.sizes(cfg)["depth"] * \
        attention_cost(cfg)[0]
