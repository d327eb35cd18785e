"""The port's attention-MIL eval forward against the JAX package, with the
JAX parameters carried across by utils/interop.py.

Every key of the 13-key dict is held to 1e-5 (the bucketed-pool tolerance
of tests/test_pallas_and_inference.py), the goldens' outputs to 1e-5, and
a bf16 bag forward to the 1e-3 slide-probability contract (BASELINE.md)."""

import os

import numpy as np
import pytest
import torch

import conftest  # noqa: F401
import jax
import jax.numpy as jnp

from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu.models import (
    attention_mil as jamil,
)
from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu.utils import (
    torch_interop,
)
from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.models import (
    attention_mil as tamil,
    resnet as tresnet,
)
from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.utils import (
    interop,
)

GOLDENS = os.path.join(os.path.dirname(__file__), "goldens")
KEYS = ("Aterm", "wROIs", "Bterm", "Mterm", "Fterm", "Aterm_mu", "Aterm_var",
        "loss", "l2", "KLD", "y_pred", "y_pred_hat", "error")
TINY = dict(widths=(8, 12, 12, 16), blocks=(1, 1, 1, 1), L=16, D=8)
# jitted JAX init draws the same parameters as eager init to ~1e-7, far
# inside the goldens' 1e-5, at a fraction of eager's per-op compile cost
_jax_init = jax.jit(jamil.init_attention_mil, static_argnums=1)
_jax_apply = jax.jit(
    lambda p, t, label, cfg, mask: jamil.apply_attention_mil(
        p, t, label, cfg, mask=mask, train=False), static_argnums=3)


def _port_cfg(jcfg):
    return tamil.MILConfig(
        L=jcfg.L, D=jcfg.D, K=jcfg.K, O=jcfg.O, n_classes=jcfg.n_classes,
        smoothing=jcfg.smoothing, class_weights=jcfg.class_weights,
        widths=jcfg.widths, blocks=jcfg.blocks)


def _port_model(jparams, jcfg):
    model = tamil.AttentionMIL(_port_cfg(jcfg), device="cpu")
    return interop.load_jax_params(model, jparams).eval()


@pytest.fixture(scope="module")
def tiny():
    jcfg = jamil.MILConfig(class_weights=(0.5, 1.0, 2.0), **TINY)
    jp = _jax_init(jax.random.PRNGKey(3), jcfg)
    return jcfg, jp, _port_model(jp, jcfg)


def _run_both(jcfg, jp, model, tiles, label, mask=None, compute_dtype=None):
    want = _jax_apply(jp, jnp.asarray(tiles), label, jcfg,
                      None if mask is None else jnp.asarray(mask))
    got = tamil.apply_attention_mil(
        model, torch.from_numpy(tiles), label, _port_cfg(jcfg),
        mask=None if mask is None else torch.from_numpy(mask),
        compute_dtype=compute_dtype)
    return got, want


def _assert_dicts_close(got, want, atol=1e-5):
    assert set(got) == set(want) == set(KEYS)
    for k in KEYS:
        g, w = got[k].numpy(), np.asarray(want[k])
        assert g.shape == w.shape, k
        if k == "y_pred_hat":
            assert int(g) == int(w)
        else:
            np.testing.assert_allclose(g, w, atol=atol, err_msg=k)


@pytest.mark.parametrize("padded", [False, True])
@pytest.mark.parametrize("label", [0, 2])
def test_eval_dict_matches_jax(tiny, padded, label):
    jcfg, jp, model = tiny
    rng = np.random.default_rng(10)
    tiles = rng.standard_normal((13, 32, 32, 3)).astype(np.float32)
    mask = None
    if padded:
        tiles = np.concatenate([tiles, np.zeros((3, 32, 32, 3), np.float32)])
        mask = np.r_[np.ones(13), np.zeros(3)].astype(np.float32)
    got, want = _run_both(jcfg, jp, model, tiles, label, mask)
    _assert_dicts_close(got, want)


def test_padded_bag_equals_ragged(tiny):
    jcfg, _, model = tiny
    cfg = _port_cfg(jcfg)
    tiles = np.random.default_rng(11).standard_normal(
        (13, 32, 32, 3)).astype(np.float32)
    padded = np.concatenate([tiles, np.ones((19, 32, 32, 3), np.float32)])
    mask = torch.zeros(32)
    mask[:13] = 1.0
    a = tamil.apply_attention_mil(model, torch.from_numpy(tiles), 1, cfg)
    b = tamil.apply_attention_mil(model, torch.from_numpy(padded), 1, cfg,
                                  mask=mask)
    for k in ("y_pred", "Mterm", "loss", "KLD", "Aterm_var", "Aterm_mu"):
        np.testing.assert_allclose(b[k].numpy(), a[k].numpy(), atol=1e-5,
                                   err_msg=k)
    np.testing.assert_allclose(b["Aterm"][:, :13].numpy(),
                               a["Aterm"].numpy(), atol=1e-6)
    assert not b["Aterm"][:, 13:].any()


@pytest.mark.parametrize("make", [
    lambda **kw: tamil.AttentionMIL(tamil.MILConfig(**TINY), **kw),
    lambda **kw: tresnet.ResNet26(**kw),
    lambda **kw: tresnet.BasicBlock(8, 16, 2, **kw),
], ids=["AttentionMIL", "ResNet26", "BasicBlock"])
def test_modules_default_to_the_card(monkeypatch, make):
    """A module built with no device goes to the card: with none present it
    raises rather than holding its parameters on the host."""
    assert {p.device.type for p in make(device="cpu").parameters()} == {"cpu"}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make()


def test_module_forward_and_gate_match(tiny):
    jcfg, jp, model = tiny
    tiles = torch.from_numpy(np.random.default_rng(12).standard_normal(
        (5, 32, 32, 3)).astype(np.float32))
    a = model(tiles, 1)
    b = tamil.apply_attention_mil(model, tiles, 1, model.cfg)
    np.testing.assert_array_equal(a["y_pred"].numpy(), b["y_pred"].numpy())
    np.testing.assert_allclose(tamil.gate_coefficients(model).numpy(),
                               np.asarray(jamil.gate_coefficients(jp)),
                               atol=1e-7)


def test_reference_state_dict_loads_strict(tiny):
    """``torch_interop.export_state_dict`` output (reference keys, with
    DataParallel's ``module.`` segment) loads into the port with
    strict=True and gives the same forward as the JAX tree."""
    jcfg, jp, model = tiny
    sd = torch_interop.export_state_dict(jp)
    assert any(k.startswith("cnn.module.") for k in sd)
    other = tamil.AttentionMIL(_port_cfg(jcfg), device="cpu")
    interop.load_jax_params(other, sd)
    for k, v in model.state_dict().items():
        np.testing.assert_array_equal(other.state_dict()[k].numpy(),
                                      v.numpy(), err_msg=k)


def test_bf16_bag_within_contract_of_jax_f32(tiny):
    jcfg, jp, model = tiny
    tiles = np.random.default_rng(13).standard_normal(
        (24, 32, 32, 3)).astype(np.float32)
    got, want = _run_both(jcfg, jp, model, tiles, 1,
                          compute_dtype=torch.bfloat16)
    drift = np.abs(got["y_pred"].numpy() - np.asarray(want["y_pred"])).max()
    assert drift < 1e-3, drift


def test_tiny_golden():
    """tests/goldens/attention_mil_tiny.npz: JAX PRNGKey(42) params carried
    across, default_rng(123) tiles, label 1."""
    g = np.load(os.path.join(GOLDENS, "attention_mil_tiny.npz"))
    jcfg = jamil.MILConfig(**TINY)
    model = _port_model(
        _jax_init(jax.random.PRNGKey(42), jcfg), jcfg)
    tiles = np.random.default_rng(123).standard_normal(
        (12, 32, 32, 3)).astype(np.float32)
    out = tamil.apply_attention_mil(model, torch.from_numpy(tiles), 1,
                                    model.cfg)
    for k in ("y_pred", "Mterm", "Aterm", "loss", "KLD", "Aterm_var"):
        np.testing.assert_allclose(out[k].numpy(), g[k], atol=1e-5,
                                   err_msg=k)


def test_fullwidth_golden():
    """tests/goldens/attention_mil_fullwidth.npz: JAX PRNGKey(7) full-width
    params carried across, default_rng(2024) 300 px tiles, label 2."""
    g = np.load(os.path.join(GOLDENS, "attention_mil_fullwidth.npz"))
    jcfg = jamil.MILConfig()
    model = _port_model(
        _jax_init(jax.random.PRNGKey(7), jcfg), jcfg)
    tiles = np.random.default_rng(2024).standard_normal(
        (4, 300, 300, 3)).astype(np.float32)
    out = tamil.apply_attention_mil(model, torch.from_numpy(tiles), 2,
                                    model.cfg)
    for k in ("y_pred", "Mterm", "Aterm", "loss"):
        np.testing.assert_allclose(out[k].numpy(), g[k], atol=1e-5,
                                   err_msg=k)
