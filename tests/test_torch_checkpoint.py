"""The port's checkpoints against the JAX package's: one file format, both
directions.

``utils/interop.jax_params_from_module`` is the exact inverse of the weight
carry-over (arrays equal bit for bit); a ``.model`` file written by either
package restores into the other with ``strict=True``; the transfer filter
keeps the same keys; and one checkpoint gives the same bag forward in both
packages, ``y_pred`` within 1e-5 in float32 (the goldens' bound)."""

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
from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu.train import (
    checkpoint as jckpt,
)
from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.models import (
    attention_mil as tamil,
    resnet as tresnet,
)
from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.train import (
    checkpoint as tckpt,
)
from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.utils import (
    interop,
)

TINY = dict(widths=(8, 8, 8, 8), blocks=(1, 1, 1, 1))
CFGS = {"tiny": (jamil.MILConfig(**TINY), tamil.MILConfig(**TINY)),
        "full": (jamil.MILConfig(), tamil.MILConfig())}


def _jax_params(cfg, seed):
    p = jax.jit(jamil.init_attention_mil, static_argnums=1)(
        jax.random.PRNGKey(seed), cfg)
    return jax.tree_util.tree_map(np.asarray, p)


def _port_model(tcfg, seed):
    return tamil.init_attention_mil(torch.Generator().manual_seed(seed),
                                    tcfg, device="cpu")


def _assert_trees_equal(a, b):
    fa, fb = tckpt._flatten(a), tckpt._flatten(b)
    assert fa.keys() == fb.keys()
    for k in fa:
        assert fa[k].shape == fb[k].shape, k
        assert fa[k].dtype == np.float32, k
        np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)


def _bag(seed, t=6, res=32):
    return np.random.default_rng(seed).uniform(
        -1, 1, (t, res, res, 3)).astype(np.float32)


@pytest.mark.parametrize("arch", sorted(CFGS))
def test_jax_params_round_trip_bit_exact(arch):
    jcfg, tcfg = CFGS[arch]
    jp = _jax_params(jcfg, 1)
    model = interop.load_jax_params(tamil.AttentionMIL(tcfg, device="cpu"),
                                    jp)
    back = interop.jax_params_from_module(model)
    _assert_trees_equal(back, jp)
    assert isinstance(back["cnn"]["stages"], list)
    assert isinstance(back["cnn"]["stages"][0], list)


def test_resnet_params_round_trip_bit_exact():
    jp = jax.tree_util.tree_map(np.asarray, jresnet.init_resnet26(
        jax.random.PRNGKey(2), **TINY))
    cnn = tresnet.ResNet26(device="cpu", **TINY)
    cnn.load_state_dict(interop.state_dict_from_jax(jp), strict=True)
    _assert_trees_equal(interop.jax_params_from_module(cnn), jp)


def test_jax_checkpoint_restores_into_port(tmp_path):
    jcfg, tcfg = CFGS["tiny"]
    jp = _jax_params(jcfg, 3)
    path = jckpt.save(str(tmp_path / "train_step-004.model"), jp,
                      extra={"epoch": 4})
    model = _port_model(tcfg, 0)
    model, loaded, skipped = tckpt.restore_params(model, path, strict=True)
    assert not skipped and len(loaded) == len(tckpt._flatten(jp))
    _assert_trees_equal(interop.jax_params_from_module(model), jp)
    bag = _bag(0)
    want = jamil.apply_attention_mil(jp, jnp.asarray(bag), 1, jcfg)
    got = tamil.apply_attention_mil(model, torch.from_numpy(bag), 1, tcfg)
    np.testing.assert_allclose(got["y_pred"].numpy(),
                               np.asarray(want["y_pred"]), atol=1e-5)


def test_port_checkpoint_restores_into_jax(tmp_path):
    jcfg, tcfg = CFGS["tiny"]
    model = _port_model(tcfg, 5)
    path = tckpt.save(tckpt.checkpoint_path(str(tmp_path), 7), model)
    assert os.path.basename(path) == "train_step-007.model"
    assert sorted(os.listdir(tmp_path)) == ["train_step-007.model"]  # no tmp
    raw = tckpt.load_raw(path)
    assert all(k.startswith("classifier/") for k in raw)
    assert "classifier/cnn/stages/0/0/conv1/w" in raw
    jp, loaded, skipped = jckpt.restore_params(_jax_params(jcfg, 0), path,
                                               strict=True)
    assert not skipped
    _assert_trees_equal(jax.tree_util.tree_map(np.asarray, jp),
                        interop.jax_params_from_module(model))
    bag = _bag(1)
    want = jamil.apply_attention_mil(jp, jnp.asarray(bag), 0, jcfg)
    got = tamil.apply_attention_mil(model, torch.from_numpy(bag), 0, tcfg)
    np.testing.assert_allclose(got["y_pred"].numpy(),
                               np.asarray(want["y_pred"]), atol=1e-5)


def test_transfer_restores_only_resnet_convs(tmp_path):
    jcfg, tcfg = CFGS["tiny"]
    src = _port_model(tcfg, 11)
    path = tckpt.save(str(tmp_path / "src.model"), src)
    fresh = _port_model(tcfg, 12)
    before = interop.jax_params_from_module(fresh)
    _, loaded, _ = tckpt.restore_params(fresh, path, transfer=True,
                                        strict=True)
    _, jloaded, _ = jckpt.restore_params(_jax_params(jcfg, 0), path,
                                         transfer=True)
    assert sorted(loaded) == sorted(jloaded)
    assert loaded and all("cnn" in k and "conv" in k for k in loaded)
    after = tckpt._flatten(interop.jax_params_from_module(fresh))
    want = tckpt._flatten(interop.jax_params_from_module(src))
    old = tckpt._flatten(before)
    for k in after:
        np.testing.assert_array_equal(after[k],
                                      want[k] if k in loaded else old[k],
                                      err_msg=k)
    assert "cnn/fc/w" not in loaded and "weight_mask" not in loaded


def test_restore_strict_and_lenient(tmp_path):
    _, tcfg = CFGS["tiny"]
    model = _port_model(tcfg, 0)
    blob = {f"classifier/{k}": v for k, v in tckpt._flatten(
        interop.jax_params_from_module(model)).items()}
    blob["classifier/cnn/conv1/w"] = np.zeros((3, 3, 3, 8), np.float32)
    blob["classifier/bogus/w"] = np.zeros((2,), np.float32)
    path = tckpt.save_blob(str(tmp_path / "odd.model"), blob)
    with pytest.raises((KeyError, ValueError)):
        tckpt.restore_params(model, path, strict=True)
    _, loaded, skipped = tckpt.restore_params(model, path)
    assert sorted(skipped) == ["bogus/w", "cnn/conv1/w"]
    assert "cnn/conv1/b" in loaded
    del blob["classifier/bogus/w"], blob["classifier/cnn/conv1/w"]
    path = tckpt.save_blob(str(tmp_path / "short.model"), blob)
    with pytest.raises(KeyError, match="missing"):
        tckpt.restore_params(model, path, strict=True)


def test_checkpoint_names_and_latest_match_jax(tmp_path):
    assert tckpt.checkpoint_path("d", 3) == jckpt.checkpoint_path("d", 3)
    assert (tckpt.checkpoint_path("d", 40, final=True)
            == jckpt.checkpoint_path("d", 40, final=True))
    for name in ("train_step-002.model", "train_step-010_FINAL.model",
                 "train_step-009.model", "notes.txt"):
        (tmp_path / name).write_bytes(b"")
    assert tckpt.latest_checkpoint(str(tmp_path)) == \
        jckpt.latest_checkpoint(str(tmp_path)) == \
        str(tmp_path / "train_step-010_FINAL.model")
