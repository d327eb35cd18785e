"""The port's ops (nn primitives, losses, init) against the JAX package.

Same numpy inputs from a seed go through both; tolerances are the JAX
package's own (1e-5 for the primitives, 1e-6 for the losses)."""

import numpy as np
import pytest
import torch

import conftest  # noqa: F401
import jax
import jax.numpy as jnp

from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu.ops import (
    loss as JL,
    nn as JN,
)
from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.models import (
    attention_mil as tamil,
    resnet as tresnet,
)
from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.ops import (
    init as TI,
    loss as TL,
    nn as TN,
)


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _pair(fn_jax, fn_torch, *arrays, **kw):
    want = np.asarray(fn_jax(*[jnp.asarray(a) for a in arrays], **kw))
    got = fn_torch(*[torch.from_numpy(a) for a in arrays], **kw).numpy()
    return got, want


CONV_CASES = [
    # (x shape, w shape, stride, padding)
    ((2, 9, 9, 3), (3, 3, 3, 4), 1, 1),
    ((2, 16, 16, 3), (7, 7, 3, 5), 2, 3),
    ((2, 8, 8, 12), (4, 4, 12, 5), 1, [(2, 1), (2, 1)]),
    ((1, 10, 7, 2), (3, 2, 2, 3), 1, [(0, 2), (1, 0)]),
    ((2, 9, 9, 4), (1, 1, 4, 6), 2, 0),
]


@pytest.mark.parametrize("xs,ws,stride,padding", CONV_CASES)
def test_conv2d_matches_jax(xs, ws, stride, padding):
    rng = np.random.default_rng(0)
    x, w, b = _rand(rng, *xs), _rand(rng, *ws), _rand(rng, ws[-1])
    got, want = _pair(
        lambda x, w, b: JN.conv2d(x, w, b, stride=stride, padding=padding),
        lambda x, w, b: TN.conv2d(x, w, b, stride=stride, padding=padding),
        x, w, b)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_conv2d_compute_dtype_keeps_output_dtype():
    rng = np.random.default_rng(1)
    x, w, b = _rand(rng, 2, 8, 8, 3), _rand(rng, 3, 3, 3, 4), _rand(rng, 4)
    got = TN.conv2d(torch.from_numpy(x), torch.from_numpy(w),
                    torch.from_numpy(b), padding=1,
                    compute_dtype=torch.bfloat16)
    want = JN.conv2d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                     padding=1, compute_dtype=jnp.bfloat16)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    scale = float(np.abs(np.asarray(want, np.float32)).max())
    err = np.abs(got.float().numpy() - np.asarray(want, np.float32)).max()
    assert err <= 2e-2 * scale


UNARY = {
    "leaky_relu": (JN.leaky_relu, TN.leaky_relu, (6, 7)),
    "softplus": (JN.softplus, TN.softplus, (6, 7)),
    "max_pool": (JN.max_pool, TN.max_pool, (2, 9, 9, 3)),
    "global_avg_pool": (JN.global_avg_pool, TN.global_avg_pool, (2, 5, 5, 3)),
    "l1_normalize": (JN.l1_normalize, TN.l1_normalize, (11, 3)),
    "l2_normalize": (JN.l2_normalize, TN.l2_normalize, (11, 3)),
}


@pytest.mark.parametrize("name", sorted(UNARY))
def test_unary_primitive_matches_jax(name):
    fj, ft, shape = UNARY[name]
    rng = np.random.default_rng(2)
    x = _rand(rng, *shape) * 4.0
    if name == "softplus":  # the tails too: no threshold in either
        x.flat[:4] = [-40.0, -25.0, 25.0, 40.0]
    got, want = _pair(fj, ft, x)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-6)


def test_normalize_zero_column_uses_eps():
    x = np.zeros((4, 2), np.float32)
    for fj, ft in ((JN.l1_normalize, TN.l1_normalize),
                   (JN.l2_normalize, TN.l2_normalize)):
        got, want = _pair(fj, ft, x)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("bias", [True, False])
def test_linear_matches_jax(bias):
    rng = np.random.default_rng(3)
    x, w, b = _rand(rng, 5, 7), _rand(rng, 7, 4), _rand(rng, 4)
    args = (x, w, b) if bias else (x, w)
    got, want = _pair(JN.linear, TN.linear, *args)
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("keepdims", [True, False])
def test_masked_mean_matches_jax(masked, keepdims):
    rng = np.random.default_rng(4)
    x = _rand(rng, 10, 3)
    mask = (rng.random(10) > 0.4).astype(np.float32) if masked else None
    want = JN.masked_mean(jnp.asarray(x), None if mask is None
                          else jnp.asarray(mask), axis=0, keepdims=keepdims)
    got = TN.masked_mean(torch.from_numpy(x), None if mask is None
                         else torch.from_numpy(mask), axis=0,
                         keepdims=keepdims)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("masked", [True, False])
def test_batch_norm_tiles_matches_jax(masked):
    rng = np.random.default_rng(5)
    x = _rand(rng, 16, 6) * 3.0 + 1.0
    g, b = _rand(rng, 6), _rand(rng, 6)
    mask = np.ones(16, np.float32)
    if masked:
        mask[11:] = 0.0
        x[11:] = 100.0  # padded rows must not move the statistics
    want = JN.batch_norm_tiles(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b),
                               mask=jnp.asarray(mask))
    got = TN.batch_norm_tiles(torch.from_numpy(x), torch.from_numpy(g),
                              torch.from_numpy(b), mask=torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("train", [True, False])
def test_dropout_with_jax_keep_mask(train):
    """The JAX dropout draws its keep mask from its key; the port takes the
    mask, so the same draw is injected."""
    rng = np.random.default_rng(6)
    x = _rand(rng, 8, 5)
    key, rate = jax.random.PRNGKey(3), 0.25
    keep = np.array(jax.random.bernoulli(key, 1.0 - rate, x.shape))
    want = JN.dropout(jnp.asarray(x), rate, key, train=train)
    got = TN.dropout(torch.from_numpy(x), rate, torch.from_numpy(keep),
                     train=train)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


@pytest.mark.parametrize("weighted", [True, False])
@pytest.mark.parametrize("reduction", ["none", "mean", "sum"])
def test_smoothed_ce_loss_matches_jax(weighted, reduction):
    rng = np.random.default_rng(7)
    logits = _rand(rng, 6, 3) * 2.0
    labels = rng.integers(0, 3, 6)
    weight = np.asarray([0.5, 1.0, 2.0], np.float32) if weighted else None
    want = JL.smoothed_ce_loss(
        jnp.asarray(logits), jnp.asarray(labels), num_classes=3,
        smoothing=0.25, weight=None if weight is None else jnp.asarray(weight),
        reduction=reduction)
    got = TL.smoothed_ce_loss(
        torch.from_numpy(logits), torch.from_numpy(labels), num_classes=3,
        smoothing=0.25,
        weight=None if weight is None else torch.from_numpy(weight),
        reduction=reduction)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def test_loss_rejects_bad_arguments():
    logits = torch.zeros(2, 3)
    with pytest.raises(ValueError, match="reduction"):
        TL.cross_entropy_with_probs(logits, logits, reduction="max")
    with pytest.raises(ValueError, match="smoothing"):
        TL.smooth_one_hot(torch.tensor([0]), 3, smoothing=1.0)


def test_init_statistics():
    """Conv kernels match kaiming fan_out std for leaky_relu(0.1), as
    tests/test_resnet.py::test_init_statistics checks the JAX init."""
    model = tresnet.init_resnet26(torch.Generator().manual_seed(2),
                                  device="cpu")
    w = model.layer4[0].conv1.weight.detach()  # [80, 60, 3, 3]
    expected_std = np.sqrt(2.0 / (1.0 + 0.01)) / np.sqrt(80 * 9)
    assert abs(float(w.std()) - expected_std) / expected_std < 0.05
    assert float(model.conv1.bias.abs().max()) == 0.0


def test_head_init_statistics():
    """The attention MLP takes tanh-gain kaiming fan_in, the buffer lin1
    leaky-relu kaiming fan_in, every bias zero, the gate 0.25."""
    cfg = tamil.MILConfig(L=400, D=200)
    model = tamil.init_attention_mil(torch.Generator().manual_seed(0), cfg,
                                     device="cpu")
    w_att = model.attention["lin1"].weight.detach()
    assert abs(float(w_att.std()) - TI.TANH_GAIN / np.sqrt(400)) \
        < 0.05 * TI.TANH_GAIN / np.sqrt(400)
    w_buf = model.buffer["lin1"].weight.detach()
    want = TI.leaky_relu_gain(0.1) / np.sqrt(400)
    assert abs(float(w_buf.std()) - want) < 0.05 * want
    assert float(model.attention["lin1"].bias.abs().max()) == 0.0
    np.testing.assert_array_equal(model.weight_mask.detach().numpy(),
                                  np.full(3, 0.25, np.float32))
    assert float(model.context.bn.weight.min()) == 1.0
