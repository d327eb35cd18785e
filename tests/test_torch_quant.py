"""The port's W8A8 int8 extractor (ops/quant.py), held to the JAX package's.

The six tier-1 tests of tests/test_quant.py, mirrored on the port. Then
both packages on the same carried-over full-width weights: the int8
weights equal bit for bit and their scales equal; the activation scales
within 1e-6 relative (the float32 calibration forwards sum in other
orders); ``_conv_i8`` bit-identical to JAX's for each lowering on the
same int8 operands at strides 1 and 2 and paddings 0, 1 and 3; the port's
three lowerings bit-identical to each other end to end; the full-width
int8 forward equal to JAX's given JAX's qparams and scales (measured 0.0;
held to 1e-6 x max|ref|) and, each package calibrating on its own,
within 5 % of max|ref| (measured 1.8 %: one requantization step apart
here and there, from the 7e-7 relative scale gap); through the MIL head,
the slide probability within 2e-3 of the float32 path with the argmax
kept."""

import numpy as np
import pytest
import torch

import conftest  # noqa: F401
import jax
import jax.numpy as jnp

from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu.models import (
    attention_mil as jamil,
    resnet as jresnet,
)
from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu.ops import (
    quant as jquant,
)
from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.models import (
    attention_mil as amil,
    resnet as R,
)
from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.ops import (
    quant as Q,
)
from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.parallel import (
    steps,
)
from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.utils import (
    interop,
)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def _uniform(seed, shape):
    return np.array(jax.random.uniform(jax.random.PRNGKey(seed), shape))


@pytest.fixture(scope="module")
def full_width():
    """JAX's full-width ResNet-26 (PRNGKey(0)) in both packages, each
    package's own qparams and scales from the same 64 calibration tiles,
    and JAX's carried over to the port."""
    jp = jresnet.init_resnet26(jax.random.PRNGKey(0))
    calib = _uniform(2, (64, 64, 64, 3))
    jqp, jsc = jquant.quantize_and_calibrate(jp, jnp.asarray(calib))
    cnn = interop.load_jax_params(R.ResNet26(device="cpu"), _np_tree(jp))
    qp, sc = Q.quantize_and_calibrate(cnn, torch.from_numpy(calib))
    return {"jp": jp, "jqp": jqp, "jsc": jsc, "cnn": cnn, "qp": qp, "sc": sc,
            "carried": (interop.qparams_from_jax(_np_tree(jqp)),
                        interop.scales_from_jax(_np_tree(jsc)))}


# ------------------------------------------- tests/test_quant.py, mirrored
def test_weight_quantization_roundtrip(full_width):
    """Dequantized int8 weights sit within half a step of the originals,
    per output channel, and the per-channel scales differ."""
    w = full_width["cnn"].conv1.weight.detach().double().numpy()
    wq = full_width["qp"]["conv1"]["wq"].double().numpy()
    sw = full_width["qp"]["conv1"]["sw"].double().numpy()
    err = np.abs(wq * sw[:, None, None, None] - w)
    assert err.max() <= 0.5 * sw.max() + 1e-9
    assert np.std(sw) > 0


def test_int8_conv_site_matches_f32_on_grid():
    """The int32-accumulated int8 conv equals the same conv in float32 on
    the quantized grid, for each lowering (no hidden saturation or
    rounding)."""
    g = torch.Generator().manual_seed(3)
    x = torch.randint(-127, 128, (4, 8, 16, 16), generator=g).to(torch.int8)
    w = torch.randint(-127, 128, (16, 8, 3, 3), generator=g).to(torch.int8)
    site = {"wq": w, "sw": torch.ones(16), "b": torch.zeros(16)}
    ref = torch.nn.functional.conv2d(x.double(), w.double(), padding=1)
    for impl in Q.IMPLS:
        out = Q._conv_i8(site, x, torch.tensor(1.0), stride=1, padding=1,
                         impl=impl)
        assert torch.equal(out.double(), ref), impl


def test_quantized_embeddings_close_to_f32(full_width):
    """Through all 26 no-norm layers at full widths the int8 embeddings
    stay aligned with the float32 forward (cosine > 0.995, relative error
    < 8 %, the JAX test's bounds)."""
    x = torch.from_numpy(_uniform(1, (16, 64, 64, 3)))
    with torch.no_grad():
        ref = R.apply_resnet26(full_width["cnn"], x).double().numpy()
    out = Q.apply_resnet26_int8(full_width["qp"], full_width["sc"],
                                x).double().numpy()
    cos = np.sum(ref * out, -1) / (np.linalg.norm(ref, axis=-1)
                                   * np.linalg.norm(out, axis=-1))
    rel = np.linalg.norm(ref - out, axis=-1) / np.linalg.norm(ref, axis=-1)
    assert cos.min() > 0.995
    assert rel.max() < 0.08


def test_int8_dot_impl_bit_exact_vs_conv(full_width):
    """The im2col and shift-add lowerings are the same integer math as the
    float32-on-grid conv: the three agree bit for bit end to end."""
    x = torch.from_numpy(_uniform(5, (4, 64, 64, 3)))
    qp, sc = full_width["qp"], full_width["sc"]
    a = Q.apply_resnet26_int8(qp, sc, x)
    for impl in ("dot", "shift"):
        assert torch.equal(a, Q.apply_resnet26_int8(qp, sc, x, impl=impl)), \
            impl


def test_int8_extractor_slide_probability_drift():
    """Plugged into the full MIL head, the int8 extractor moves the slide
    probability by under 2e-3 and keeps the argmax (JAX's bound; the
    head carries JAX's PRNGKey(0) weights)."""
    cfg = amil.MILConfig()
    model = interop.load_jax_params(
        amil.AttentionMIL(cfg, device="cpu"),
        _np_tree(jamil.init_attention_mil(jax.random.PRNGKey(0),
                                          jamil.MILConfig())))
    tiles = torch.from_numpy(_uniform(1, (48, 64, 64, 3)))
    calib = torch.from_numpy(_uniform(2, (64, 64, 64, 3)))
    ext = Q.make_int8_extractor(model.cnn, calib)
    ref = amil.apply_attention_mil(model, tiles, 1, cfg)["y_pred"]
    out = amil.apply_attention_mil(model, tiles, 1, cfg,
                                   extractor=ext)["y_pred"]
    assert float((ref - out).abs().max()) < 2e-3
    assert int(ref.argmax()) == int(out.argmax())
    # the bag forward of the steps module takes the same extractor
    fwd = steps.make_bag_forward(cfg, extractor=ext)
    outs = fwd(model, tiles, torch.ones(48), 1)
    assert torch.equal(outs["y_pred"], out)


def test_calibration_scales_share_block_input(full_width):
    """conv1 and downsample of a transition block read the same tensor:
    one scale for it (no downsample key), every scale a positive scalar."""
    sc = full_width["sc"]
    for stage in sc["stages"]:
        for block_scales in stage:
            assert set(block_scales) == {"conv1", "conv2"}
    for _, leaf in _leaves(sc):
        assert leaf.shape == () and float(leaf) > 0


# ---------------------------------------------------------- against JAX
def test_quantized_weights_equal_jax(full_width):
    """Every int8 weight bit-identical and every weight scale equal."""
    carried = dict(_leaves(full_width["carried"][0]))
    port = dict(_leaves(full_width["qp"]))
    assert sorted(carried) == sorted(port)
    for k in carried:
        assert carried[k].dtype == port[k].dtype, k
        assert torch.equal(carried[k], port[k]), k


def test_calibration_scales_match_jax(full_width):
    carried = dict(_leaves(full_width["carried"][1]))
    port = dict(_leaves(full_width["sc"]))
    assert sorted(carried) == sorted(port)
    for k in carried:
        np.testing.assert_allclose(float(port[k]), float(carried[k]),
                                   rtol=1e-6, err_msg=k)


def _jax_conv_i8(impl, w_hwio, x_nhwc, stride, padding):
    site = {"wq": jnp.asarray(w_hwio), "sw": jnp.ones((w_hwio.shape[-1],))}
    return np.asarray(jquant._conv_i8(site, jnp.asarray(x_nhwc),
                                      jnp.float32(1.0), stride=stride,
                                      padding=padding, impl=impl))


@pytest.mark.parametrize("impl", Q.IMPLS)
@pytest.mark.parametrize("stride,padding,k", [(1, 0, 1), (1, 1, 3),
                                              (1, 3, 7), (2, 0, 1),
                                              (2, 1, 3), (2, 3, 7)])
def test_conv_i8_bit_identical_to_jax(impl, stride, padding, k):
    """One int8 conv site on the same int8 operands (Cin 20, Cout 40 and
    a 7x7 stem-like site with Cin 3): JAX's int32 accumulation and the
    port's, through the same dequantization, equal bit for bit."""
    rng = np.random.default_rng(100 * stride + 10 * padding + k)
    cin, cout = (3, 20) if k == 7 else (20, 40)
    x = rng.integers(-127, 128, (2, 19, 19, cin)).astype(np.int8)
    w = rng.integers(-127, 128, (k, k, cin, cout)).astype(np.int8)
    want = _jax_conv_i8(impl, w, x, stride, padding)
    site = {"wq": torch.from_numpy(np.ascontiguousarray(
        w.transpose(3, 2, 0, 1))), "sw": torch.ones(cout)}
    got = Q._conv_i8(site, torch.from_numpy(x).permute(0, 3, 1, 2),
                     torch.tensor(1.0), stride=stride, padding=padding,
                     impl=impl)
    assert np.array_equal(got.permute(0, 2, 3, 1).numpy(), want)


def test_unknown_impl_raises():
    x = torch.zeros((1, 3, 8, 8), dtype=torch.int8)
    with pytest.raises(ValueError, match="impl"):
        Q._conv_i8_acc(torch.zeros((4, 3, 3, 3), dtype=torch.int8), x,
                       stride=1, padding=1, impl="xla")


@pytest.mark.parametrize("impl", Q.IMPLS)
def test_int8_forward_equals_jax_with_its_scales(full_width, impl):
    """Given JAX's qparams and scales, the port's full-width int8 forward
    is JAX's (measured 0.0; held to 1e-6 x max|ref|)."""
    x = _uniform(1, (16, 64, 64, 3))
    want = np.asarray(jquant.apply_resnet26_int8(
        full_width["jqp"], full_width["jsc"], jnp.asarray(x)))
    got = Q.apply_resnet26_int8(*full_width["carried"], torch.from_numpy(x),
                                impl=impl).numpy()
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()


def test_int8_forward_with_own_calibration_near_jax(full_width):
    """Each package calibrated on its own: the features within 5 % of
    max|ref| of JAX's (measured 1.8 %)."""
    x = _uniform(1, (16, 64, 64, 3))
    want = np.asarray(jquant.apply_resnet26_int8(
        full_width["jqp"], full_width["jsc"], jnp.asarray(x)))
    got = Q.apply_resnet26_int8(full_width["qp"], full_width["sc"],
                                torch.from_numpy(x)).numpy()
    assert np.abs(got - want).max() <= 0.05 * np.abs(want).max()


def test_int8_transform_extract_matches_the_extractor(full_width, tmp_path,
                                                      monkeypatch):
    """The streaming program on raw uint8 tiles equals the extractor on
    their eval transform; the builder's calibration tiles are the first
    ``want`` tiles of its cache, and a tile-less cache gives None."""
    from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.data import (
        roibuilder,
        transforms,
    )

    monkeypatch.setenv("CACHE_DIR", str(tmp_path))
    rng = np.random.default_rng(0)
    raw = rng.integers(0, 256, (12, 32, 32, 3)).astype(np.uint8)
    for name, tiles in (("full", raw), ("empty", raw[:0])):
        np.save(tmp_path / f"data_{name}_rois_size32_hsvcut_v3.npy", tiles)
        np.save(tmp_path / f"coor_{name}_rois_size32_hsvcut_v3.npy",
                np.zeros((len(tiles), 2), np.int64))
    b = roibuilder.RoiBuilder(str(tmp_path / "full.npy"), {"roi_size": 32},
                              device="cpu")
    calib = Q.calib_tiles_from_builder(b, 5, 16)
    want = transforms.eval_transform(torch.from_numpy(raw[:5]),
                                     resolution=16)
    assert torch.equal(calib, want)
    empty = roibuilder.RoiBuilder(str(tmp_path / "empty.npy"),
                                  {"roi_size": 32}, device="cpu")
    assert Q.calib_tiles_from_builder(empty, 5, 16) is None

    cnn = full_width["cnn"]
    qp_sc = (full_width["qp"], full_width["sc"])
    run = Q.make_int8_transform_extract(cnn, None, 16, qp_sc=qp_sc)
    ext = Q.make_int8_extractor(cnn, None, qp_sc=qp_sc)
    assert torch.equal(run(cnn, torch.from_numpy(raw)),
                       ext(cnn, transforms.eval_transform(
                           torch.from_numpy(raw), resolution=16)))
