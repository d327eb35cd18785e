"""Analytic operations and bytes of the work the benchmark asks for, counted
from shapes alone, whatever implements them.

``conv_flops`` and ``segment_flops`` are frozen copies of the port's
measuring tool (``tools/torch_profile_stages.py``); the critic's count
follows the shapes of rosinality's discriminator blocks
(``reference/critic_mil.layout``), and the pool's bytes the kernels'
inputs and outputs, each read or written once.
"""

from .reference import critic_mil as critic_ref


def conv_flops(h, w, kh, kw, cin, cout):
    """MACs*2 for one conv producing an h x w x cout map."""
    return 2.0 * h * w * kh * kw * cin * cout


def segment_flops(res=300, widths=(20, 40, 60, 80), blocks=(3, 3, 3, 3),
                  embed_dim=80):
    """Analytic per-tile FLOPs for stem / each stage / fc at ``res``."""
    out = {}
    h = (res + 1) // 2  # stem conv s2 p3
    out["stem"] = conv_flops(h, h, 7, 7, 3, widths[0])
    h = (h + 1) // 2  # maxpool s2 p1
    cin = widths[0]
    for si, (wd, nb) in enumerate(zip(widths, blocks)):
        f = 0.0
        for b in range(nb):
            stride = 2 if (si > 0 and b == 0) else 1
            ho = (h + stride - 1) // stride
            f += conv_flops(ho, ho, 3, 3, cin, wd)      # conv1
            f += conv_flops(ho, ho, 3, 3, wd, wd)       # conv2
            if stride != 1 or cin != wd:
                f += conv_flops(ho, ho, 1, 1, cin, wd)  # downsample
            h, cin = ho, wd
        out[f"stage{si + 1}"] = f
    out["pool_fc"] = 2.0 * widths[-1] * embed_dim
    return out


def resnet26_tile_flops(cfg):
    """The ResNet-26's forward FLOPs for one tile of ``cfg``."""
    return sum(segment_flops(cfg["tile_px"], cfg["widths"], cfg["blocks"],
                             cfg["L"]).values())


def resnet26_train_tile_flops(cfg):
    """Forward and the backward that training needs, for one tile through
    the embedder: the backward takes twice the forward (the gradients of
    the inputs and of the weights of every layer), less the gradient of
    the stem's input, the tile, which nothing needs."""
    seg = segment_flops(cfg["tile_px"], cfg["widths"], cfg["blocks"],
                        cfg["L"])
    fwd = sum(seg.values())
    return 3.0 * fwd - seg["stem"]


def critic_block_flops(cfg):
    """``[(step, flops a tile)]`` of each block the cut critic runs, its
    from_rgb counted with the first; a block at step i takes a map 4 * 2**i
    px square."""
    lay, rgb = critic_ref.layout(cfg["width_mult"])
    n = len(lay)
    out = []
    for i in critic_ref.blocks_run(cfg["step"], cfg["disc_cutoff"]):
        idx = n - i - 1
        cin, cout, k1, p1, k2, p2, down, fused = lay[idx]
        s = 4 * 2 ** i
        f = 0.0
        if i == cfg["step"]:
            f += conv_flops(s, s, 1, 1, 3, rgb[idx])
        f += conv_flops(s, s, k1, k1, cin, cout)
        if down:                # the depthwise binomial blur
            f += conv_flops(s, s, 3, 3, 1, cout)
        if down and fused:      # the averaged kernel is (k2 + 1) square
            f += conv_flops(s // 2, s // 2, k2 + 1, k2 + 1, cout, cout)
        elif down:              # a full-size conv, then the 2x2 mean
            f += conv_flops(s, s, k2, k2, cout, cout)
        else:
            so = s + 2 * p2 - k2 + 1
            f += conv_flops(so, so, k2, k2, cout, cout)
        out.append((i, f))
    return out


def critic_tile_flops(cfg):
    return sum(f for _, f in critic_block_flops(cfg))


def pool_fwd_cost(T, K, O):
    """(operations, bytes) of the gated pool's forward over ``T`` tiles:
    it reads A_raw [T, K], B [T, O], the mask [T] and the gate [K] and
    writes M [K, O], A1^T [K, T] and wROIs [K, T], float32; per tile and
    map a softplus (3), the gate (2), the sum and the division (2), M and
    wROIs (2 O + 1)."""
    nbytes = 4 * (T * (K + O + 1) + K + K * O + 2 * K * T)
    return T * K * (8 + 2 * O), nbytes


def pool_bwd_cost(T, K, O):
    """(operations, bytes) of the pool's backward with the cotangent of M
    alone (the training path's): it reads A_raw, B, the mask, the gate,
    A1^T and dM and writes dA_raw [T, K], dB [T, O] and dw [K]."""
    nbytes = 4 * (T * (K + O + 1) + K + K * T + K * O
                  + T * (K + O) + K)
    return T * K * (14 + 4 * O), nbytes
