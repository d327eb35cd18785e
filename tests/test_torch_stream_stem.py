"""The streaming path's default per-chunk program and the fused uint8 stem.

``parallel.inference.make_transform_extract`` runs the ResNet's uint8
entry (``ResNet26.forward_u8``, the fused stem) where
``fused_stem_applies``: a CUDA chunk of uint8 300 px tiles served at 300 px
through the bf16 ResNet-26.
Elsewhere it runs the eval transform and cuDNN's stem. The stem is the
``torch.library`` op ``u8_stem.OP``, so an exported bundle holds it.

The CPU tests hold the gate over each of its conditions (on a model built
on the ``meta`` device, the device argument faked), the op's CPU version
to the plain stem bit for bit, its export, the pooled op (``u8_stem.POOL_OP``,
the stem with its cast, LeakyReLU and max-pool, which ``ResNet26.stem_u8``
takes in bf16) to that composition bit for bit, saved programs holding
either op, the ``stem.kernel_tiles`` and ``stem.pooled_tiles`` counters,
and the fused program, the gate forced open on the CPU (where the ops take
their plain versions), to the default program and through a bundle. The
tests marked ``card`` run the kernels on the card and skip without one.

This file imports no JAX, so that its ``card`` tests run on the card's
machine alone: ``python -m pytest --noconftest tests/test_torch_stream_stem.py``.
"""

import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.export import Dim
from torch.profiler import ProfilerActivity, profile

from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch import deploy  # noqa: E501
from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.data import transforms  # noqa: E501
from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.models import attention_mil as amil  # noqa: E501
from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.models import resnet  # noqa: E501
from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.models import vit  # noqa: E501
from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.ops import gated_pool, u8_stem  # noqa: E501
from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.ops import nn as N  # noqa: E501
from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.parallel import inference  # noqa: E501
from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.utils import profiling  # noqa: E501

SMALL = dict(widths=(20, 8, 8, 8), blocks=(1, 1, 1, 1))
CONVENTIONS = [(1 / 255.0, 0.0), (2 / 255.0, -1.0)]
SERVE = dict(alpha=2 / 255.0, beta=-1.0)


def _tiles(n, px=300, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).integers(
        0, 256, (n, px, px, 3), dtype=np.uint8))


def _edge_tiles():
    """Tiles whose extremes fall on pooled rows and columns 0 and 74: all
    0, all 255, and 0 or 255 blocks at the corners and edge middles of
    the other value."""
    lo = np.zeros((300, 300, 3), np.uint8)
    hi = np.full((300, 300, 3), 255, np.uint8)
    spots_hi, spots_lo = lo.copy(), hi.copy()
    for r in (slice(0, 5), slice(145, 155), slice(293, 300)):
        for c in (slice(0, 5), slice(145, 155), slice(293, 300)):
            spots_hi[r, c] = 255
            spots_lo[r, c] = 0
    return torch.from_numpy(np.stack([lo, hi, spots_hi, spots_lo]))


def _composition(conv1, x, alpha, beta):
    """The stem's sums, then the epilogue as ``ResNet26.stem_u8`` ran it
    before the pooled op: the cast to bf16, LeakyReLU, max-pool 3/2/1;
    NHWC."""
    h = u8_stem.stem_u8_conv(conv1, x, alpha=alpha, beta=beta)
    h = N.leaky_relu(h.to(torch.bfloat16).permute(0, 3, 1, 2))
    return F.max_pool2d(h, 3, 2, 1).permute(0, 2, 3, 1)


def _op_targets(prog):
    return [n.target for n in prog.graph.nodes if n.op == "call_function"
            and n.target in (
                torch.ops.resnet26_attention_mil_torch.u8_stem_forward
                .default,
                torch.ops.resnet26_attention_mil_torch.u8_stem_pool_forward
                .default)]


def _model(cfg, device, seed=0):
    return amil.init_attention_mil(torch.Generator().manual_seed(seed), cfg,
                                   device=device)


def _cudnn_program(cfg, resolution=300, compute_dtype=torch.bfloat16):
    """The chunk program without the fused stem: the eval transform, then
    the configured embedder."""
    def extract(cnn, raw_u8):
        tiles = transforms.eval_transform(raw_u8, resolution=resolution)
        return amil.embed(cnn, tiles, cfg, compute_dtype=compute_dtype)
    return extract


class _TileCache:
    """A RoiBuilder stand-in whose tile cache is ``raw``."""

    def __init__(self, raw, device, resolution=300):
        self.raw, self.device = raw, device
        self.coords = np.zeros((raw.shape[0], 2), np.int64)
        self.params = {"resolution": resolution}

    def update_resolution_and_buffer(self, resolution):
        self.params["resolution"] = int(resolution)

    def _load_cache(self, with_coords=False, mmap=False):
        return (self.raw, self.coords) if with_coords else self.raw


@pytest.fixture
def fused_on_cpu(monkeypatch):
    """The gate forced open, so that the CPU runs the fused program (the
    op takes its plain version there)."""
    monkeypatch.setattr(inference, "fused_stem_applies",
                        lambda *a, **k: True)


# --------------------------------------------------------------- the gate
GATE_CASES = {
    # case: (MILConfig changes, tile side, tile dtype, resolution,
    #        compute dtype, device, engages)
    "resnet_bf16_300_cuda": ({}, 300, torch.uint8, 300, torch.bfloat16,
                             "cuda", True),
    "cpu": ({}, 300, torch.uint8, 300, torch.bfloat16, "cpu", False),
    "f32": ({}, 300, torch.uint8, 300, None, "cuda", False),
    "fp16": ({}, 300, torch.uint8, 300, torch.float16, "cuda", False),
    "vit": ({"extractor": "vit", "L": 32,
             "vit": vit.ViTConfig(depth=1, heads=2, mlp=64)}, 300,
            torch.uint8, 300, torch.bfloat16, "cuda", False),
    "conv1_16_out": ({"widths": (16, 8, 8, 8)}, 300, torch.uint8, 300,
                     torch.bfloat16, "cuda", False),
    "float_tiles": ({}, 300, torch.float32, 300, torch.bfloat16, "cuda",
                    False),
    "tiles_1200": ({}, 1200, torch.uint8, 300, torch.bfloat16, "cuda",
                   False),
    "resolution_224": ({}, 300, torch.uint8, 224, torch.bfloat16, "cuda",
                       False),
}


@pytest.mark.parametrize("case", list(GATE_CASES))
def test_fused_stem_gate(case):
    """Exactly the streaming ResNet bf16 300 px chunk on a CUDA device
    engages the fused stem; the model lies on ``meta`` and the device is
    the argument the program passes from its chunk."""
    changes, px, dtype, res, cdt, device, engages = GATE_CASES[case]
    cfg = amil.MILConfig(**{**SMALL, **changes})
    model = amil.AttentionMIL(cfg, device="meta")
    raw = torch.empty((4, px, px, 3), dtype=dtype, device="meta")
    assert inference.fused_stem_applies(
        cfg, model.cnn, raw, device=torch.device(device), resolution=res,
        compute_dtype=cdt) is engages


@pytest.mark.parametrize("case", ["no_bias", "stride_1", "padding_0"])
def test_fused_stem_gate_needs_the_kernels_conv1(case):
    """A stem conv the kernel does not compute keeps cuDNN's stem."""
    cfg = amil.MILConfig(**SMALL)
    model = amil.AttentionMIL(cfg, device="meta")
    kw = {"no_bias": {"bias": False}, "stride_1": {"stride": 1},
          "padding_0": {"padding": 0}}[case]
    model.cnn.conv1 = torch.nn.Conv2d(3, 20, 7, **{"stride": 2, "padding": 3,
                                                   **kw}, device="meta")
    raw = torch.empty((4, 300, 300, 3), dtype=torch.uint8, device="meta")
    assert not inference.fused_stem_applies(
        cfg, model.cnn, raw, device=torch.device("cuda"), resolution=300,
        compute_dtype=torch.bfloat16)


# ----------------------------------------------------------------- the op
@pytest.mark.parametrize("alpha,beta", CONVENTIONS)
def test_op_on_the_cpu_is_the_plain_stem(alpha, beta):
    """The op's CPU version equals ``stem_u8_conv_reference`` bit for bit,
    contiguous as the kernel's output; ``opcheck`` holds its schema and
    fake against it; the CPU launches no kernel."""
    conv1 = torch.nn.Conv2d(3, 20, 7, 2, 3)
    x = _tiles(2, seed=1)
    n = u8_stem.LAUNCHES
    with torch.no_grad():
        got = u8_stem.u8_stem_forward(x, conv1.weight, conv1.bias, alpha,
                                      beta)
    want = u8_stem.stem_u8_conv_reference(conv1, x, alpha=alpha, beta=beta)
    assert got.is_contiguous() and got.dtype == torch.float32
    assert torch.equal(got, want)
    assert torch.equal(u8_stem.stem_u8_conv(conv1, x, alpha=alpha,
                                            beta=beta), want)
    assert u8_stem.LAUNCHES == n
    torch.library.opcheck(u8_stem.u8_stem_forward,
                          (x[:1], conv1.weight.detach(),
                           conv1.bias.detach(), alpha, beta))


def test_export_holds_the_op():
    """``torch.export`` of a function calling the stem holds the op as one
    node whose output has the fake's shape and dtype, for a dynamic tile
    count; the exported program computes what the eager call does."""
    conv1 = torch.nn.Conv2d(3, 20, 7, 2, 3)

    class Stem(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.conv1 = conv1

        def forward(self, x):
            return u8_stem.stem_u8_conv(self.conv1, x, **SERVE)

    x = _tiles(2, seed=2)
    with torch.no_grad():
        prog = torch.export.export(Stem(), (x,), dynamic_shapes=(
            {0: Dim("N", min=1, max=16)},))
    nodes = [n for n in prog.graph.nodes
             if n.op == "call_function"
             and n.target == torch.ops.resnet26_attention_mil_torch
             .u8_stem_forward.default]
    assert len(nodes) == 1
    val = nodes[0].meta["val"]
    assert val.dtype == torch.float32
    assert tuple(val.shape[1:]) == (u8_stem.OUT, u8_stem.OUT, u8_stem.C_OUT)
    assert str(val.shape[0]) == str(
        next(n for n in prog.graph.nodes if n.name == "x").meta["val"]
        .shape[0])
    x3 = _tiles(3, seed=3)
    with torch.no_grad():
        assert torch.equal(prog.module()(x3),
                           u8_stem.stem_u8_conv(conv1, x3, **SERVE))


POOL_CASES = {
    # case: (tiles, alpha, beta)
    "noise_serve": (lambda: _tiles(2, seed=11), 2 / 255.0, -1.0),
    "noise_unit": (lambda: _tiles(2, seed=12), 1 / 255.0, 0.0),
    "edges_serve": (_edge_tiles, 2 / 255.0, -1.0),
    "edges_unit": (_edge_tiles, 1 / 255.0, 0.0),
}


@pytest.mark.parametrize("case", list(POOL_CASES))
def test_pooled_op_on_the_cpu_is_the_composition(case):
    """The pooled op's CPU version equals the stem's sums cast to bf16,
    LeakyReLU and max-pool 3/2/1 bit for bit, as contiguous bf16 NHWC
    ``[B, 75, 75, 20]``, on noise and on tiles of all 0, all 255 and
    extremes at pooled rows and columns 0 and 74; the CPU launches no
    kernel."""
    tiles, alpha, beta = POOL_CASES[case]
    conv1 = torch.nn.Conv2d(3, 20, 7, 2, 3)
    x = tiles()
    n, n_pooled = u8_stem.LAUNCHES, u8_stem.POOLED_LAUNCHES
    with torch.no_grad():
        got = u8_stem.u8_stem_pool_forward(x, conv1.weight, conv1.bias,
                                           alpha, beta)
        want = _composition(conv1, x, alpha, beta)
    assert got.is_contiguous() and got.dtype == torch.bfloat16
    assert tuple(got.shape) == (x.shape[0], u8_stem.POOL_OUT,
                                u8_stem.POOL_OUT, u8_stem.C_OUT)
    assert torch.equal(got, want)
    assert torch.equal(u8_stem.stem_u8_pool(conv1, x, alpha=alpha,
                                            beta=beta), want)
    assert torch.equal(u8_stem.stem_u8_pool_reference(
        conv1, x, alpha=alpha, beta=beta), want)
    assert (u8_stem.LAUNCHES, u8_stem.POOLED_LAUNCHES) == (n, n_pooled)


def test_pooled_op_passes_opcheck_and_its_fake_has_the_kernels_shape():
    """``opcheck`` holds the pooled op's schema and fake against its CPU
    version; under ``torch.export`` the op is one node whose output is
    bf16 ``[N, 75, 75, 20]`` for a dynamic tile count, and the exported
    program computes what the eager call does."""
    conv1 = torch.nn.Conv2d(3, 20, 7, 2, 3)
    x = _tiles(2, seed=13)
    torch.library.opcheck(u8_stem.u8_stem_pool_forward,
                          (x[:1], conv1.weight.detach(),
                           conv1.bias.detach(), *SERVE.values()))

    class Stem(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.conv1 = conv1

        def forward(self, x):
            return u8_stem.stem_u8_pool(self.conv1, x, **SERVE)

    with torch.no_grad():
        prog = torch.export.export(Stem(), (x,), dynamic_shapes=(
            {0: Dim("N", min=1, max=16)},))
    nodes = [n for n in prog.graph.nodes
             if n.op == "call_function"
             and n.target == torch.ops.resnet26_attention_mil_torch
             .u8_stem_pool_forward.default]
    assert len(nodes) == 1
    val = nodes[0].meta["val"]
    assert val.dtype == torch.bfloat16
    assert tuple(val.shape[1:]) == (u8_stem.POOL_OUT, u8_stem.POOL_OUT,
                                    u8_stem.C_OUT)
    assert str(val.shape[0]) == str(
        next(n for n in prog.graph.nodes if n.name == "x").meta["val"]
        .shape[0])
    x3 = _tiles(3, seed=14)
    with torch.no_grad():
        assert torch.equal(prog.module()(x3),
                           u8_stem.stem_u8_pool(conv1, x3, **SERVE))


STEM_DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32, "none": None,
               "fp16": torch.float16}


@pytest.mark.parametrize("dtype", list(STEM_DTYPES))
def test_stem_u8_takes_the_pooled_op_exactly_in_bf16(dtype):
    """``ResNet26.stem_u8`` holds the pooled op alone where its compute
    dtype is bf16, and the stem op alone (then the cast, LeakyReLU and
    max-pool) anywhere else; both give the composition's activations."""
    cdt = STEM_DTYPES[dtype]
    cnn = resnet.ResNet26(widths=SMALL["widths"], blocks=SMALL["blocks"],
                          device="cpu")

    class Stem(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.cnn = cnn

        def forward(self, x):
            return self.cnn.stem_u8(x, compute_dtype=cdt, **SERVE)

    x = _tiles(1, seed=15)
    with torch.no_grad():
        prog = torch.export.export(Stem(), (x,))
        got = cnn.stem_u8(x, compute_dtype=cdt, **SERVE)
    pooled = cdt == torch.bfloat16
    assert _op_targets(prog) == [
        torch.ops.resnet26_attention_mil_torch.u8_stem_pool_forward.default
        if pooled else
        torch.ops.resnet26_attention_mil_torch.u8_stem_forward.default]
    assert got.dtype == (cdt or torch.float32)
    if pooled:
        want = _composition(cnn.conv1, x, **SERVE).permute(0, 3, 1, 2)
        assert torch.equal(got, want)
        assert got.stride() == want.stride()


@pytest.mark.parametrize("dtype", ["bf16", "none"])
def test_pooled_counter_counts_the_bf16_chunks_only(dtype):
    """Under a recording profiler ``stem.pooled_tiles`` adds the tiles of
    each ``forward_u8`` call in bf16, and nothing in float32."""
    cnn = resnet.ResNet26(widths=SMALL["widths"], blocks=SMALL["blocks"],
                          device="cpu")
    profiling.reset_counters()
    try:
        with torch.no_grad(), profile(activities=[ProfilerActivity.CPU]):
            for n in (3, 2):
                cnn.forward_u8(_tiles(n, seed=16 + n),
                               compute_dtype=STEM_DTYPES[dtype], **SERVE)
        counts = profiling.counters()
    finally:
        profiling.reset_counters()
    assert counts.get("stem.pooled_tiles", 0) == (5 if dtype == "bf16"
                                                  else 0)


@pytest.mark.parametrize("pooled", [False, True], ids=["conv", "pooled"])
def test_saved_program_holding_a_stem_op_loads_and_runs(pooled, tmp_path):
    """A program that holds either stem op, saved with ``torch.export``,
    loads in this process (the module has registered both ops) and
    computes what the eager call does; so bundles exported before the
    pooled op existed still load."""
    conv1 = torch.nn.Conv2d(3, 20, 7, 2, 3)
    stem = u8_stem.stem_u8_pool if pooled else u8_stem.stem_u8_conv

    class Stem(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.conv1 = conv1

        def forward(self, x):
            return stem(self.conv1, x, **SERVE)

    x = _tiles(2, seed=19)
    with torch.no_grad():
        prog = torch.export.export(Stem(), (x,))
    path = str(tmp_path / "stem.pt2")
    torch.export.save(prog, path)
    loaded = torch.export.load(path)
    assert len(_op_targets(loaded)) == 1
    with torch.no_grad():
        assert torch.equal(loaded.module()(x), stem(conv1, x, **SERVE))


# ------------------------------------------------- the default chunk program
@pytest.mark.parametrize("fused", [True, False], ids=["fused", "cudnn"])
def test_counter_counts_the_fused_chunks_only(fused, monkeypatch):
    """Under a recording profiler ``stem.kernel_tiles`` adds a chunk's
    tiles where the program takes the fused stem, and nothing where it
    takes the eval transform and cuDNN's stem (the CPU); so does
    ``stem.pooled_tiles``, the program's compute dtype being bf16."""
    if fused:
        monkeypatch.setattr(inference, "fused_stem_applies",
                            lambda *a, **k: True)
    cfg = amil.MILConfig(**SMALL)
    model = _model(cfg, "cpu")
    extract = inference.make_transform_extract(cfg, resolution=300)
    profiling.reset_counters()
    try:
        with torch.no_grad(), profile(activities=[ProfilerActivity.CPU]):
            extract(model.cnn, _tiles(3, seed=4))
            extract(model.cnn, _tiles(2, seed=5))
        counts = profiling.counters()
    finally:
        profiling.reset_counters()
    assert counts.get("stem.kernel_tiles", 0) == (5 if fused else 0)
    assert counts.get("stem.pooled_tiles", 0) == (5 if fused else 0)


def test_fused_program_matches_the_cudnn_program(fused_on_cpu):
    """The fused program's features equal the eval transform's and the
    embedder's within the stem test's bf16 bound, 1e-2 x max|ref| (the
    same sum of products)."""
    cfg = amil.MILConfig(**SMALL)
    model = _model(cfg, "cpu", seed=1)
    x = _tiles(3, seed=6)
    with torch.no_grad():
        got = inference.make_transform_extract(cfg)(model.cnn, x)
        want = _cudnn_program(cfg)(model.cnn, x)
    assert got.dtype == torch.float32 and got.shape == want.shape == (3, 80)
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= 1e-2 * scale


def test_bundle_holds_the_stem_op_where_the_gate_engages(tmp_path,
                                                         fused_on_cpu):
    """Where the gate engages the bundle's extractor program holds the
    pooled stem op (forced open on the CPU here; the bundle is bf16),
    loads with it registered and classifies as the live streaming path
    does."""
    cfg = amil.MILConfig(**SMALL)
    model = _model(cfg, "cpu", seed=2)
    out = str(tmp_path / "bundle")
    deploy.export_serving_bundle(model, cfg, out, resolution=300,
                                 roi_size=300, chunk=4, tiles=16,
                                 compute_dtype=torch.bfloat16)
    clf = deploy.DeployedClassifier(out, device="cpu")
    targets = {str(n.target) for n in
               clf._programs["extract"].graph.nodes
               if n.op == "call_function"}
    assert any(u8_stem.POOL_OP.replace("::", ".") in t for t in targets), (
        targets)
    raw = _tiles(7, seed=7).numpy()
    probs_dep, outs_dep = clf.classify(raw)
    probs_live, outs_live, _ = inference.classify_slide_streaming(
        model, cfg, _TileCache(raw, torch.device("cpu")), resolution=300,
        chunk=4)
    np.testing.assert_allclose(probs_dep, probs_live, atol=1e-5)
    np.testing.assert_allclose(outs_dep["Aterm"], outs_live["Aterm"],
                               atol=1e-4)


# ------------------------------------------------------------ on the card
@pytest.fixture
def card():
    """The CUDA card, or a skip where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card on this host")
    return torch.device("cuda", 0)


@pytest.fixture
def full_model(card):
    cfg = amil.MILConfig()
    return cfg, _model(cfg, card, seed=3)


@pytest.mark.card
@pytest.mark.parametrize("n", [1024, 37])
def test_default_program_on_the_card_matches_cudnn(full_model, card, n):
    """At full width the default chunk program launches the pooled stem
    kernel once a chunk and the stem kernel never, and its features equal
    the eval transform's and cuDNN's within 1e-2 x max|ref| (the stem
    test's bf16 bound)."""
    cfg, model = full_model
    x = _tiles(n, seed=8).to(card)
    extract = inference.make_transform_extract(cfg)
    with torch.no_grad():
        launches = (u8_stem.LAUNCHES, u8_stem.POOLED_LAUNCHES)
        got = extract(model.cnn, x)
        torch.cuda.synchronize(card)
        assert (u8_stem.LAUNCHES, u8_stem.POOLED_LAUNCHES) == (
            launches[0], launches[1] + 1)
        want = _cudnn_program(cfg)(model.cnn, x)
        assert (u8_stem.LAUNCHES, u8_stem.POOLED_LAUNCHES) == (
            launches[0], launches[1] + 1)
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    print(f"n={n} max|diff|={err:.3e} max|ref|={scale:.3e}")
    assert err <= 1e-2 * scale


@pytest.mark.card
def test_streamed_slide_on_the_card_launches_one_stem_a_chunk(full_model,
                                                             card):
    """A streamed slide of 2,500 tiles at chunk 1024: one pooled stem
    launch per chunk, no launch of the stem kernel, one pool launch; every
    tile counted as ``stem.kernel_tiles``, ``stem.pooled_tiles`` and
    ``stage.tiles``; the probabilities within 1e-3 of the eval transform's
    and cuDNN's program (the bf16 contract)."""
    cfg, model = full_model
    raw = _tiles(2500, seed=9).numpy()
    stem0, pool0 = u8_stem.LAUNCHES, gated_pool.LAUNCHES
    pooled0 = u8_stem.POOLED_LAUNCHES
    profiling.reset_counters()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            probs, outs, _ = inference.classify_slide_streaming(
                model, cfg, _TileCache(raw, card), resolution=300,
                chunk=1024)
        counts = profiling.counters()
    finally:
        profiling.reset_counters()
    assert u8_stem.POOLED_LAUNCHES - pooled0 == 3
    assert u8_stem.LAUNCHES - stem0 == 0
    assert gated_pool.LAUNCHES - pool0 == 1
    assert (counts["stem.kernel_tiles"] == counts["stem.pooled_tiles"]
            == counts["stage.tiles"] == 2500)
    probs_cudnn, outs_cudnn, _ = inference.classify_slide_streaming(
        model, cfg, _TileCache(raw, card), resolution=300, chunk=1024,
        transform_extract=_cudnn_program(cfg))
    assert u8_stem.POOLED_LAUNCHES - pooled0 == 3
    assert u8_stem.LAUNCHES - stem0 == 0
    gap = float(np.abs(probs - probs_cudnn).max())
    print(f"probs gap {gap:.3e}")
    assert gap <= 1e-3
    assert outs["Aterm"].shape == outs_cudnn["Aterm"].shape == (cfg.K, 2500)


@pytest.mark.card
def test_bundle_on_the_card_holds_the_stem_op(full_model, card, tmp_path):
    """``deploy.py`` exports a bf16 bundle at roi 300 on the card whose
    extractor program holds the pooled stem op; the bundle's outputs match
    the live streaming path's, and its chunks launch the pooled kernel."""
    cfg, model = full_model
    out = str(tmp_path / "bundle")
    deploy.export_serving_bundle(model, cfg, out, resolution=300,
                                 roi_size=300, chunk=1024, tiles=4096,
                                 compute_dtype=torch.bfloat16)
    clf = deploy.DeployedClassifier(out, device=card)
    targets = {str(n.target) for n in
               clf._programs["extract"].graph.nodes
               if n.op == "call_function"}
    assert any(u8_stem.POOL_OP.replace("::", ".") in t for t in targets), (
        targets)
    raw = _tiles(2500, seed=10).numpy()
    stem0, pooled0 = u8_stem.LAUNCHES, u8_stem.POOLED_LAUNCHES
    probs_dep, outs_dep = clf.classify(raw)
    torch.cuda.synchronize(card)
    assert u8_stem.POOLED_LAUNCHES - pooled0 == 3
    assert u8_stem.LAUNCHES - stem0 == 0
    probs_live, outs_live, _ = inference.classify_slide_streaming(
        model, cfg, _TileCache(raw, card), resolution=300, chunk=1024)
    gap = float(np.abs(probs_dep - probs_live).max())
    a_gap = float(np.abs(outs_dep["Aterm"] - outs_live["Aterm"]).max())
    print(f"bundle vs live: probs {gap:.3e}, Aterm {a_gap:.3e}")
    assert gap <= 1e-5
    assert a_gap <= 1e-4


CARD_CONVENTIONS = {"serve": (2 / 255.0, -1.0), "unit": (1 / 255.0, 0.0)}


@pytest.mark.card
@pytest.mark.parametrize("conv", list(CARD_CONVENTIONS))
@pytest.mark.parametrize("n", [1, 37, 1024])
def test_pooled_kernel_on_the_card_is_the_composition(card, n, conv):
    """The pooled kernel equals the stem kernel's output cast to bf16,
    LeakyReLU and max-pool 3/2/1 bit for bit, at 1, 37 and 1,024 tiles
    (from 4 tiles on, the first four all 0, all 255 and extremes at
    pooled rows and columns 0 and 74), with a random bias; one launch a
    call, and no launch of the stem kernel. It lies within one bf16 ulp
    of max|ref| of its plain version, ``stem_u8_pool_reference``, whose
    float32 sums differ from the kernel's in their order alone."""
    alpha, beta = CARD_CONVENTIONS[conv]
    torch.manual_seed(n)
    conv1 = torch.nn.Conv2d(3, 20, 7, 2, 3, device=card)
    x = _tiles(n, seed=20 + n)
    if n >= 4:
        x[:4] = _edge_tiles()
    x = x.to(card)
    with torch.no_grad():
        stem0, pooled0 = u8_stem.LAUNCHES, u8_stem.POOLED_LAUNCHES
        got = u8_stem.stem_u8_pool(conv1, x, alpha=alpha, beta=beta)
        torch.cuda.synchronize(card)
        assert (u8_stem.LAUNCHES, u8_stem.POOLED_LAUNCHES) == (
            stem0, pooled0 + 1)
        want = _composition(conv1, x, alpha, beta)
        plain = u8_stem.stem_u8_pool_reference(conv1, x, alpha=alpha,
                                               beta=beta)
    assert got.dtype == torch.bfloat16 and got.is_contiguous()
    assert got.shape == want.shape == (n, 75, 75, 20)
    diff = (got.float() - want.float()).abs()
    print(f"n={n} {conv}: {int((diff > 0).sum())} values differ, "
          f"max|diff| {float(diff.max()):.3e}")
    assert torch.equal(got, want)
    scale = float(plain.float().abs().max())
    err = float((got.float() - plain.float()).abs().max())
    print(f"n={n} {conv}: vs the plain version max|diff| {err:.3e}, "
          f"max|ref| {scale:.3e}")
    assert err <= 2.0 ** (math.floor(math.log2(scale)) - 7)


@pytest.mark.card
def test_program_holding_the_stem_op_loads_and_runs_on_the_card(card,
                                                                tmp_path):
    """A program exported on the card that holds the stem op (as bundles
    exported before the pooled op did) loads, launches the stem kernel
    once a call and equals the eager call."""
    torch.manual_seed(0)
    conv1 = torch.nn.Conv2d(3, 20, 7, 2, 3, device=card)

    class Stem(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.conv1 = conv1

        def forward(self, x):
            return u8_stem.stem_u8_conv(self.conv1, x, **SERVE)

    x = _tiles(37, seed=24).to(card)
    with torch.no_grad():
        prog = torch.export.export(Stem(), (x,))
    path = str(tmp_path / "stem.pt2")
    torch.export.save(prog, path)
    loaded = torch.export.load(path)
    assert _op_targets(loaded) == [
        torch.ops.resnet26_attention_mil_torch.u8_stem_forward.default]
    with torch.no_grad():
        stem0 = u8_stem.LAUNCHES
        got = loaded.module()(x)
        torch.cuda.synchronize(card)
        assert u8_stem.LAUNCHES == stem0 + 1
        assert torch.equal(got, u8_stem.stem_u8_conv(conv1, x, **SERVE))
