"""The benchmark's counts and readers for the ViT cell
(``benchmark/vit_flops.py``, ``metrics/vit_gemm_mfu.serve.py``,
``metrics/vit_attn_roofline.serve.py``): the count of a 224 px tile pinned
to the sums by hand, and each reader on a hand-built trace whose kernels
and counters are known, or absent."""

import json
import os
from types import SimpleNamespace

import pytest
import torch

import conftest  # noqa: F401

from benchmark import harness, vit_flops
from benchmark.tracing import DeviceTrace
from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.utils import (
    profiling,
)

with open(os.path.join(harness.HERE, "configs", "uni_vitl16_mil.json")) as _f:
    UNI = json.load(_f)
GEMM_MFU = harness.metric_reader("vit_gemm_mfu.serve")
ATTN_ROOFLINE = harness.metric_reader("vit_attn_roofline.serve")


def test_tile_flops_at_224px():
    # 197 tokens of width 1024, 24 layers, MLP 4096
    n, d = 197, 1024
    linear = 24 * 24 * n * d * d                    # 119.0 GFLOP
    attention = 24 * 4 * n * n * d                  # 3.8 GFLOP
    patch = 2 * 196 * 768 * d                       # 0.31 GFLOP
    assert vit_flops.linear_flops(UNI) == linear + patch
    assert vit_flops.tile_flops(UNI) == linear + attention + patch
    assert vit_flops.tile_flops(UNI) == pytest.approx(123.1e9, rel=1e-3)
    assert vit_flops.attention_cost(UNI) == (4 * n * n * d, 4 * n * d * 2)


def _x(name, a, b, cat):
    return {"ph": "X", "name": name, "cat": cat, "ts": a, "dur": b - a,
            "tid": 1}


def _run(kernels):
    """A window of 0-1000 us holding ``kernels`` ``(name, start, end)``."""
    events = [_x("bench.window", 0, 1000, "user_annotation")]
    events += [_x(n, a, b, "kernel") for n, a, b in kernels]
    return SimpleNamespace(trace=DeviceTrace(events), cfg=UNI)


# the GEMMs 400 us, the attention 100 us, an elementwise pass 100 us
KERNELS = [
    ("nvjet_tst_256x128_64x4_1x2_h_bz_coopA_NNT", 0, 300),
    ("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x256x64", 300, 400),
    ("void pytorch_flash::flash_fwd_kernel<Flash_fwd_kernel_traits<64>>",
     400, 500),
    ("void at::native::vectorized_elementwise_kernel<4, GeluCUDAKernelImpl>",
     500, 600),
]


@pytest.fixture
def two_tiles():
    """The port's counters as a traced window leaves them: 2 tiles
    encoded."""
    profiling.reset_counters()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        profiling.count("vit.tiles", 2)
    yield
    profiling.reset_counters()


def test_readers_on_a_known_trace(two_tiles):
    run = _run(KERNELS)
    # 2 tiles x 119.292297216 GFLOP over 400 us at 989 TFLOP/s
    assert GEMM_MFU(run) == pytest.approx(
        100 * 2 * 119.292297216e9 / (400e-6 * 989e12))
    # 2 tiles x 24 layers, each 1,613,824 B at 3.35 TB/s (its 0.159 GFLOP
    # take less at the bf16 peak), over 100 us
    assert ATTN_ROOFLINE(run) == pytest.approx(
        100 * 2 * 24 * (1613824 / 3.35e12) / 100e-6)


def test_readers_find_nothing_without_the_counter_or_the_kernels(two_tiles):
    elementwise = _run(KERNELS[3:])
    assert GEMM_MFU(elementwise) is None
    assert ATTN_ROOFLINE(elementwise) is None
    profiling.reset_counters()
    full = _run(KERNELS)
    assert GEMM_MFU(full) is None
    assert ATTN_ROOFLINE(full) is None
