"""The port's fused uint8 stem against the JAX package's Pallas stem.

On the CPU the port's wrapper takes its plain version (f32 conv of the
bf16-rounded normalized input with bf16-rounded weights); the JAX stem runs
its Pallas kernel in interpret mode, as tests/test_pallas_and_inference.py
runs it. Tolerances:

* plain vs JAX stem: max|diff| <= 5e-3 x max|ref|. JAX rounds the conv
  output to bf16 before the bias and adds a float32 boundary correction
  computed with float32 weights, while its products use bf16 weights; the
  port's output stays float32. One bf16 rounding is up to 2^-8 = 3.9e-3
  relative.
* the pooled stem (the stem, its cast to bf16, LeakyReLU and max-pool in
  one op) vs the JAX stem and that epilogue: 1e-2 x max|ref|, the stems'
  5e-3 and one more bf16 rounding of each side.
* plain vs the float32 conv of the float32-normalized input: 2e-2 x
  max|ref|, JAX's own bound for its stem (bf16 operands).
* the whole extractor (``ResNet26.forward_u8`` vs JAX's ``fwd_b`` composition
  of tools/exp_stem_pallas.py) in bf16: 1e-2 x max|ref|, about five bf16
  roundings. Both run the residual tail in bf16, and the stems' one-ulp
  output differences pass through LeakyReLU, max-pool and four bf16
  stages (measured on this input: 3.2e-3 and 4.4e-3; the stems alone
  differ by 3.0e-3 and 3.4e-3).

The CUDA kernel itself is held to the plain version on the card by
chip_smoke.py."""

import numpy as np
import pytest
import torch

import conftest  # noqa: F401
import jax
import jax.numpy as jnp

from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu.models import (
    resnet as jresnet,
)
from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu.ops import (
    nn as JN,
    pallas_stem,
)
from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.models import (
    resnet as tresnet,
)
from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.ops import (
    u8_stem,
)
from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.utils import (
    interop,
)

WIDTHS = (20, 8, 8, 8)
BLOCKS = (1, 1, 1, 1)
CONVENTIONS = [(1 / 255.0, 0.0), (2 / 255.0, -1.0)]


@pytest.fixture(scope="module")
def nets():
    jp = jresnet.init_resnet26(jax.random.PRNGKey(3), widths=WIDTHS,
                               blocks=BLOCKS)
    jp = jax.tree_util.tree_map(np.asarray, jp)
    cnn = tresnet.ResNet26(widths=WIDTHS, blocks=BLOCKS, device="cpu")
    cnn.load_state_dict(interop.state_dict_from_jax(jp), strict=True)
    return jp, cnn.eval()


@pytest.fixture(scope="module")
def tiles():
    return np.random.default_rng(0).integers(0, 256, (2, 300, 300, 3),
                                             dtype=np.uint8)


@pytest.mark.parametrize("alpha,beta", CONVENTIONS)
def test_plain_stem_matches_pallas(nets, tiles, alpha, beta):
    jp, cnn = nets
    want = np.asarray(pallas_stem.stem_u8_conv(
        jp["conv1"], jnp.asarray(tiles), alpha=alpha, beta=beta,
        interpret=True))
    n = u8_stem.LAUNCHES
    got = u8_stem.stem_u8_conv(cnn.conv1, torch.from_numpy(tiles),
                               alpha=alpha, beta=beta)
    assert u8_stem.LAUNCHES == n  # the CPU path launches no kernel
    assert tuple(got.shape) == want.shape == (2, 150, 150, 20)
    assert got.dtype == torch.float32
    scale = float(np.abs(want).max())
    err = float(np.abs(got.numpy() - want).max())
    assert err <= 5e-3 * scale, (err, scale)


@pytest.mark.parametrize("alpha,beta", CONVENTIONS)
def test_pooled_stem_matches_pallas_and_its_epilogue(nets, tiles, alpha,
                                                     beta):
    """The pooled op (on the CPU its plain version) against the JAX stem
    followed by the epilogue the JAX ResNet runs after it (cast to bf16,
    LeakyReLU, max-pool 3/2/1): within 1e-2 x max|ref|, the stems' 5e-3
    and one more bf16 rounding of each side (2^-8 relative each; measured
    on this input: 3.0e-3 and 5.2e-3)."""
    jp, cnn = nets
    h = pallas_stem.stem_u8_conv(jp["conv1"], jnp.asarray(tiles),
                                 alpha=alpha, beta=beta, interpret=True)
    h = JN.leaky_relu(h.astype(jnp.bfloat16))
    want = np.asarray(JN.max_pool(h, window=3, stride=2, padding=1),
                      np.float32)
    n = u8_stem.POOLED_LAUNCHES
    got = u8_stem.stem_u8_pool(cnn.conv1, torch.from_numpy(tiles),
                               alpha=alpha, beta=beta)
    assert u8_stem.POOLED_LAUNCHES == n  # the CPU path launches no kernel
    assert tuple(got.shape) == want.shape == (2, 75, 75, 20)
    assert got.dtype == torch.bfloat16
    scale = float(np.abs(want).max())
    err = float(np.abs(got.float().numpy() - want).max())
    print(f"max|diff| {err:.3e} max|ref| {scale:.3e}")
    assert err <= 1e-2 * scale, (err, scale)


@pytest.mark.parametrize("alpha,beta", CONVENTIONS)
def test_plain_stem_matches_f32_conv(nets, tiles, alpha, beta):
    _, cnn = nets
    x = torch.from_numpy(tiles).float() * alpha + beta
    with torch.no_grad():
        ref = torch.nn.functional.conv2d(
            x.permute(0, 3, 1, 2), cnn.conv1.weight, cnn.conv1.bias,
            stride=2, padding=3).permute(0, 2, 3, 1)
    got = u8_stem.stem_u8_conv(cnn.conv1, torch.from_numpy(tiles),
                               alpha=alpha, beta=beta)
    scale = float(ref.abs().max())
    assert float((got - ref).abs().max()) <= 2e-2 * scale


def test_plain_stem_rounds_operands_to_bf16(nets):
    """One tile of all-equal pixels away from the border: each output is
    the bias plus the bf16 input times the sum of the bf16 weights,
    exactly as the kernel computes it."""
    _, cnn = nets
    x = torch.full((1, 300, 300, 3), 77, dtype=torch.uint8)
    got = u8_stem.stem_u8_conv(cnn.conv1, x, alpha=2 / 255.0, beta=-1.0)
    xv = torch.tensor(77.0) * (2 / 255.0) + (-1.0)
    xv = xv.to(torch.bfloat16).float()
    wsum = cnn.conv1.weight.to(torch.bfloat16).float().sum(dim=(1, 2, 3))
    want = cnn.conv1.bias + xv * wsum
    np.testing.assert_allclose(got[0, 75, 75].numpy(), want.detach().numpy(),
                               rtol=1e-5, atol=1e-5)


def _u8(*shape):
    return torch.zeros(shape, dtype=torch.uint8)


# case: (the stem conv's Conv2d arguments, the tiles); the kernel's conv is
# Conv2d(3, 20, 7, 2, 3) on uint8 [N >= 1, 300, 300, 3] tiles
REFUSED = {
    "float_input": ((3, 20, 7, 2, 3), lambda: _u8(1, 300, 300, 3).float()),
    "size_299": ((3, 20, 7, 2, 3), lambda: _u8(1, 299, 299, 3)),
    "conv1_16_out": ((3, 16, 7, 2, 3), lambda: _u8(1, 300, 300, 3)),
    "no_tiles": ((3, 20, 7, 2, 3), lambda: _u8(0, 300, 300, 3)),
    "no_bias": ((3, 20, 7, 2, 3, 1, 1, False), lambda: _u8(1, 300, 300, 3)),
    "stride_1": ((3, 20, 7, 1, 3), lambda: _u8(1, 300, 300, 3)),
    "padding_0": ((3, 20, 7, 2, 0), lambda: _u8(1, 300, 300, 3)),
}
STEM_CASES = {
    "kernel_conv": ((3, 20, 7, 2, 3), lambda: _u8(1, 300, 300, 3)),
    "three_tiles": ((3, 20, 7, 2, 3), lambda: _u8(3, 300, 300, 3)),
    "dilation_2": ((3, 20, 7, 2, 3, 2), lambda: _u8(1, 300, 300, 3)),
    "tiles_elsewhere": ((3, 20, 7, 2, 3),
                        lambda: torch.empty((1, 300, 300, 3),
                                            dtype=torch.uint8,
                                            device="meta")),
    **REFUSED,
}


@pytest.mark.parametrize("case", list(REFUSED))
def test_stem_rejects_what_the_kernel_does_not_take(case):
    conv_args, tiles = REFUSED[case]
    conv1 = torch.nn.Conv2d(*conv_args)
    with pytest.raises(ValueError, match="fused stem expects"):
        u8_stem.stem_u8_conv(conv1, tiles(), alpha=1.0, beta=0.0)


@pytest.mark.parametrize("case", list(STEM_CASES))
def test_accepts_is_false_exactly_where_the_stem_raises(case):
    """``u8_stem.accepts``, the streaming gate's test of the stem, is true
    exactly where ``stem_u8_conv`` computes (on the CPU, its plain version)
    and false exactly where it raises."""
    conv_args, tiles = STEM_CASES[case]
    conv1, x = torch.nn.Conv2d(*conv_args), tiles()
    if u8_stem.accepts(conv1, x):
        out = u8_stem.stem_u8_conv(conv1, x, alpha=1.0, beta=0.0)
        assert tuple(out.shape) == (x.shape[0], 150, 150, 20)
    else:
        with pytest.raises(ValueError, match="fused stem expects"):
            u8_stem.stem_u8_conv(conv1, x, alpha=1.0, beta=0.0)
    assert u8_stem.accepts(conv1, x) == (case in ("kernel_conv",
                                                   "three_tiles"))


def _jax_fwd_b(p, x, alpha, beta):
    """tools/exp_stem_pallas.py's fwd_b for one batch, from the JAX
    package's public functions: the stem, bf16 LeakyReLU, max-pool, the
    residual tail in bf16."""
    h = pallas_stem.stem_u8_conv(p["conv1"], x, alpha=alpha, beta=beta,
                                 interpret=True)
    h = JN.leaky_relu(h.astype(jnp.bfloat16))
    h = JN.max_pool(h, window=3, stride=2, padding=1)
    for s, stage in enumerate(p["stages"]):
        for bi, block in enumerate(stage):
            stride = 2 if (s > 0 and bi == 0) else 1
            h = jresnet.apply_block(block, h, stride,
                                    compute_dtype=jnp.bfloat16)
    h = JN.global_avg_pool(h)
    return JN.linear(h, p["fc"]["w"], compute_dtype=jnp.bfloat16)


@pytest.mark.parametrize("alpha,beta", CONVENTIONS)
def test_forward_u8_matches_jax_composition(nets, tiles, alpha, beta):
    jp, cnn = nets
    want = np.asarray(_jax_fwd_b(jp, jnp.asarray(tiles), alpha, beta),
                      np.float32)
    got = cnn.forward_u8(torch.from_numpy(tiles), alpha=alpha, beta=beta,
                         compute_dtype=torch.bfloat16).float()
    assert tuple(got.shape) == want.shape == (2, 80)
    scale = float(np.abs(want).max())
    assert float(np.abs(got.numpy() - want).max()) <= 1e-2 * scale


def test_forward_u8_f32_matches_the_float_forward(nets, tiles):
    """In float32 the ResNet's uint8 entry with the serving normalize is
    its float entry on the normalized tiles, up to the stem's bf16
    operands (the JAX stem's 2e-2 bound)."""
    _, cnn = nets
    x = torch.from_numpy(tiles)
    got = cnn.forward_u8(x, alpha=2 / 255.0, beta=-1.0)
    assert got.dtype == torch.float32
    with torch.no_grad():
        want = tresnet.apply_resnet26(cnn, x.float() * (2 / 255.0) - 1.0)
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= 2e-2 * scale


def _emulate_kernel_gemm(conv1, x_u8, alpha, beta):
    """The CUDA kernel's arithmetic in plain torch: space-to-depth planes of
    the zero-bordered, normalized bf16 input (12 channels padded to 16),
    the 16 tap shifts (a, b) side by side as K = 256, times the packed
    ``[24, 256]`` weights, the first 20 columns plus the bias."""
    n = x_u8.shape[0]
    xn = (x_u8.float() * alpha + beta).to(torch.bfloat16).float()
    xp = torch.nn.functional.pad(xn, (0, 0, 3, 3, 3, 3))       # [n,306,306,3]
    p = xp.reshape(n, 153, 2, 153, 2, 3).permute(0, 1, 3, 2, 4, 5)
    p = torch.nn.functional.pad(p.reshape(n, 153, 153, 12), (0, 4, 0, 3, 0, 3))
    cols = torch.cat([p[:, a:a + 150, b:b + 150] for a in range(4)
                      for b in range(4)], dim=-1)              # [n,150,150,256]
    w2 = u8_stem.pack_weights(conv1.weight).float()
    assert tuple(w2.shape) == (u8_stem.N_PAD, u8_stem.K_PAD)
    out = cols @ w2.T
    return out[..., :u8_stem.C_OUT] + conv1.bias.detach()


@pytest.mark.parametrize("alpha,beta", CONVENTIONS)
def test_packed_gemm_matches_plain_stem(nets, tiles, alpha, beta):
    """The kernel's K order and packing compute the stem: the emulated GEMM
    equals the plain version to 1e-5 x max|ref| (the same exact bf16
    products, summed in another order)."""
    _, cnn = nets
    x = torch.from_numpy(tiles)
    with torch.no_grad():
        got = _emulate_kernel_gemm(cnn.conv1, x, alpha, beta)
    want = u8_stem.stem_u8_conv_reference(cnn.conv1, x, alpha=alpha,
                                          beta=beta)
    scale = float(want.abs().max())
    assert tuple(got.shape) == tuple(want.shape) == (2, 150, 150, 20)
    assert float((got - want).abs().max()) <= 1e-5 * scale


def test_packed_weights_match_pallas_prep(nets):
    """Rows 0-19 of the packed weights are the JAX kernel's ``_prep_w2`` of
    the same (HWIO) weights; rows 20-23, the N padding, are zero."""
    jp, cnn = nets
    got = u8_stem.pack_weights(cnn.conv1.weight)
    assert got.dtype == torch.bfloat16
    want = np.asarray(pallas_stem._prep_w2(jnp.asarray(jp["conv1"]["w"])),
                      np.float32)
    assert want.shape == (20, 256)
    np.testing.assert_array_equal(got[:20].float().numpy(), want)
    assert not torch.any(got[20:])
