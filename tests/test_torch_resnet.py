"""The port's ResNet-26 against the JAX extractor, weights carried across
by utils/interop.py.

f32 is held to a relative 1e-6 of the embedding scale (summation order is
all that differs), bf16 to a relative 2e-2 (bf16 rounds at different
places in the two frameworks), and the full-width golden embedding to a
relative 2e-6 (|emb| reaches ~47 there, so an absolute 1e-5 would fail on
summation order alone)."""

import os

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
from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.models import (
    resnet as tresnet,
)
from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.utils import (
    interop,
)

TINY_W, TINY_B = (8, 12, 12, 16), (1, 2, 1, 1)
GOLDEN = os.path.join(os.path.dirname(__file__), "goldens",
                      "attention_mil_fullwidth.npz")


_jax_init = jax.jit(jresnet.init_resnet26,
                    static_argnames=("embed_dim", "widths", "blocks"))
_jax_apply = jax.jit(jresnet.apply_resnet26,
                     static_argnames=("compute_dtype", "taps"))


def _pair(seed, widths, blocks, embed_dim):
    jp = _jax_init(jax.random.PRNGKey(seed), embed_dim=embed_dim,
                   widths=widths, blocks=blocks)
    model = tresnet.ResNet26(embed_dim=embed_dim, widths=widths,
                             blocks=blocks, device="cpu")
    interop.load_jax_params(model, jp)
    return jp, model


def _rel_err(got, want):
    want = np.asarray(want, np.float32)
    return (np.abs(np.asarray(got, np.float32) - want).max()
            / np.abs(want).max())


@pytest.mark.parametrize("size", [32, 33])
def test_resnet_f32_matches_jax(size):
    jp, model = _pair(0, TINY_W, TINY_B, 24)
    x = np.random.default_rng(1).standard_normal(
        (3, size, size, 3)).astype(np.float32)
    want = _jax_apply(jp, jnp.asarray(x))
    with torch.no_grad():
        got = tresnet.apply_resnet26(model, torch.from_numpy(x))
    assert got.shape == want.shape
    assert _rel_err(got.numpy(), want) <= 1e-6


def test_resnet_bf16_matches_jax():
    jp, model = _pair(1, TINY_W, TINY_B, 24)
    x = np.random.default_rng(2).standard_normal(
        (3, 32, 32, 3)).astype(np.float32)
    want = _jax_apply(jp, jnp.asarray(x), compute_dtype=jnp.bfloat16)
    with torch.no_grad():
        got = tresnet.apply_resnet26(model, torch.from_numpy(x),
                                     compute_dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    assert _rel_err(got.float().numpy(), want) <= 2e-2


def test_resnet_taps_match_jax():
    jp, model = _pair(2, TINY_W, TINY_B, 24)
    x = np.random.default_rng(3).standard_normal(
        (2, 32, 32, 3)).astype(np.float32)
    want_out, want_acts = _jax_apply(jp, jnp.asarray(x), taps=True)
    with torch.no_grad():
        got_out, got_acts = tresnet.apply_resnet26(
            model, torch.from_numpy(x), taps=True)
    # jit returns the JAX dict with sorted keys; the port keeps its order
    assert list(got_acts) == ["stem", "stage1", "stage2", "stage3",
                              "stage4", "pool"]
    assert set(got_acts) == set(want_acts)
    for name, want in want_acts.items():
        assert tuple(got_acts[name].shape) == want.shape, name
        assert _rel_err(got_acts[name].numpy(), want) <= 1e-6, name
    assert _rel_err(got_out.numpy(), want_out) <= 1e-6


def test_fullwidth_golden_embedding():
    """JAX PRNGKey(7) full-width params carried across; the embedding of
    the golden's 4 tiles at 300 px against its frozen ``emb``."""
    g = np.load(GOLDEN)
    jp = jamil.init_attention_mil(jax.random.PRNGKey(7), jamil.MILConfig())
    model = tresnet.ResNet26(device="cpu")
    interop.load_jax_params(model, jp["cnn"])
    tiles = np.random.default_rng(2024).standard_normal(
        (4, 300, 300, 3)).astype(np.float32)
    with torch.no_grad():
        emb = tresnet.apply_resnet26(model, torch.from_numpy(tiles)).numpy()
    assert emb.shape == g["emb"].shape
    assert _rel_err(emb, g["emb"]) <= 2e-6
