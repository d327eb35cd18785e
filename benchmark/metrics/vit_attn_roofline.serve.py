"""The ViT encoder's attention kernels against their roofline: the least
time of the attention of every tile the port encoded in the window (its
counter ``vit.tiles``) in every layer, each the larger of its operations
(4 N^2 d) at the bf16 peak and its bytes (Q, K, V and the output, 4 N d
bf16 values) at 3.35 TB/s (``vit_flops.attention_cost``), over the device
time of the window's attention kernels, from the traced run.

Attention kernels are those whose name holds one of :data:`ATTENTION`.
The first card trace of the cell (torch 2.11.0+cu128, NVIDIA H100 80GB
HBM3) named one a layer, cuDNN's
``cudnn_generated_fort_native_sdpa_sm90_flash_fprop_wgmma_f16_knob_7_64x128x64_4x1x1_cga1x1x1_kernel0_0``;
``flash`` and ``fmha`` take the other backends of
``scaled_dot_product_attention`` (``pytorch_flash::flash_fwd_kernel``,
``fmha_cutlassF_*``). Returns None without the counter or without such
kernels, as with a port that has no ViT.
"""

from benchmark import peaks, spans, vit_flops
from benchmark.reference import vit_mil

ATTENTION = ("flash", "fmha", "sdpa")


def attention_seconds(trace):
    return sum((b - a) * 1e-6 for a, b, n, c in trace.ops
               if c == "kernel" and any(m in n for m in ATTENTION))


def read(run):
    tiles = spans.port_counters().get("vit.tiles", 0)
    secs = attention_seconds(run.trace)
    if tiles <= 0 or secs <= 0:
        return None
    layers = tiles * vit_mil.sizes(run.cfg)["depth"]
    least = layers * peaks.roofline_s(*vit_flops.attention_cost(run.cfg),
                                      "bf16")
    return 100.0 * least / secs
