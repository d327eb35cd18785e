"""The ViT encoder's matrix products against the bf16 peak: the FLOPs of
the linear maps of every tile the port encoded in the window (its counter
``vit.tiles`` times ``vit_flops.linear_flops``, 119.3 GFLOP a 224 px tile
with the patch embedding) over the device time of the window's GEMM
kernels at 989 TFLOP/s, from the traced run.

GEMM kernels are those whose name holds one of :data:`GEMM`. The first
card trace of the cell (torch 2.11.0+cu128, NVIDIA H100 80GB HBM3) named
every matrix product of the encoder a cuBLAS ``nvjet_tst_*`` kernel
(``nvjet_tst_256x128_64x4_1x2_h_bz_coopA_bias_TNT``,
``nvjet_tst_192x192_64x4_1x2_h_bz_coopB_bias_TNN`` and, for tail chunks,
``nvjet_tst_128x288_64x4_2x1_v_bz_coopA_bias_TNT``); ``gemm`` takes
cuBLAS's and CUTLASS's older names (``sm90_xmma_gemm_*``). The head's
float32 products match too, and count against the share: they are a
millionth of the encoder's FLOPs. Returns None without the counter or
without such kernels, as with a port that has no ViT.
"""

from benchmark import peaks, spans, vit_flops

GEMM = ("gemm", "nvjet")


def gemm_seconds(trace):
    return sum((b - a) * 1e-6 for a, b, n, c in trace.ops
               if c == "kernel" and any(m in n for m in GEMM))


def read(run):
    tiles = spans.port_counters().get("vit.tiles", 0)
    secs = gemm_seconds(run.trace)
    if tiles <= 0 or secs <= 0:
        return None
    flops = tiles * vit_flops.linear_flops(run.cfg)
    return 100.0 * flops / (secs * peaks.FLOPS["bf16"])
