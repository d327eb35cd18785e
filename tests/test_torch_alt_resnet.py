"""The port's torchvision-template ResNet against the JAX package's
``models/alt_resnet.py``: the forward on carried-over weights (f32,
relative 1e-5), ``from_torch_state_dict`` (the same names loaded, the
BatchNorm ``downsample.1.*`` keys skipped, as JAX's), the offline
``from_pretrained`` error and its delegation with ``torch.hub``
monkeypatched (nothing is downloaded), and the init's scales."""

import numpy as np
import pytest
import torch

import conftest  # noqa: F401
import jax
import jax.numpy as jnp

from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu.models import (
    alt_resnet as jalt,
)
from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.models import (
    alt_resnet,
)
from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.utils import (
    interop,
)


def _tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _rel(got, want):
    want = np.asarray(want, np.float32)
    return float(np.abs(np.asarray(got, np.float32) - want).max()
                 / np.abs(want).max())


@pytest.mark.parametrize("layers,widths", [
    ((1, 1, 1, 1), (8, 8, 8, 8)), ((2, 1, 2, 1), (8, 16, 16, 24))])
def test_forward_matches_jax(layers, widths):
    jp = _tree(jalt.init_resnet(jax.random.PRNGKey(1), list(layers),
                                num_classes=5, widths=widths))
    model = interop.aux_module_from_jax("alt_resnet", jp, device="cpu")
    x = np.random.default_rng(0).standard_normal(
        (2, 32, 32, 3)).astype(np.float32)
    want = jalt.apply_resnet(jp, jnp.asarray(x))
    with torch.no_grad():
        got = alt_resnet.apply_resnet(model, torch.from_numpy(x))
    assert got.shape == (2, 5)
    assert _rel(got.numpy(), want) <= 1e-5
    back = interop.aux_params_from_module(model)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(jp)):
        np.testing.assert_array_equal(a, b)


def test_torchvision_names_and_sizes():
    m = alt_resnet.resnet34(torch.Generator().manual_seed(0), device="meta")
    names = [n for n, _ in m.named_parameters()]
    assert names[:2] == ["conv1.weight", "layer1.0.conv1.weight"]
    assert "layer2.0.downsample.0.weight" in names
    assert "layer1.0.downsample.0.weight" not in names
    assert names[-2:] == ["fc.weight", "fc.bias"]
    assert [len(s) for s in m.stages()] == [3, 4, 6, 3]
    jp = jalt.resnet34(jax.random.PRNGKey(0))
    assert sum(p.numel() for p in m.parameters()) == sum(
        np.size(v) for v in jax.tree_util.tree_leaves(jp))


def test_init_scales_match_jax():
    jp = _tree(jalt.resnet18(jax.random.PRNGKey(0), num_classes=100))
    m = alt_resnet.resnet18(torch.Generator().manual_seed(0),
                            num_classes=100, device="cpu")
    ours = interop.aux_params_from_module(m)
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(jp),
                            jax.tree_util.tree_leaves(ours)):
        if path[-1].key == "b":
            np.testing.assert_array_equal(b, 0.0)
        elif np.size(a) >= 1000:
            assert abs(np.std(b) / np.std(a) - 1.0) < 0.1, path


def _state_dict(jp):
    """The torchvision-named state dict of a JAX tree, as numpy."""
    model = interop.aux_module_from_jax("alt_resnet", jp, device="cpu")
    return {k: v.numpy() for k, v in model.state_dict().items()}


def test_from_torch_state_dict_matches_jax():
    src = _tree(jalt.init_resnet(jax.random.PRNGKey(2), [1, 1, 1, 1],
                                 num_classes=5, widths=(8, 8, 8, 8)))
    sd = _state_dict(src)
    sd["layer1.0.bn1.weight"] = np.ones(8, np.float32)     # not mapped
    sd["bn1.running_mean"] = np.zeros(8, np.float32)
    fresh = alt_resnet.init_resnet(torch.Generator().manual_seed(3),
                                   [1, 1, 1, 1], num_classes=5,
                                   widths=(8, 8, 8, 8), device="cpu")
    model, loaded = alt_resnet.from_torch_state_dict(fresh, sd)
    assert model is fresh
    jfresh = jalt.init_resnet(jax.random.PRNGKey(3), [1, 1, 1, 1],
                              num_classes=5, widths=(8, 8, 8, 8))
    restored, jloaded = jalt.from_torch_state_dict(jfresh, sd)
    assert loaded == jloaded and len(loaded) == len(sd) - 2
    x = np.ones((1, 32, 32, 3), np.float32)
    with torch.no_grad():
        got = alt_resnet.apply_resnet(model, torch.from_numpy(x))
    assert _rel(got.numpy(), jalt.apply_resnet(restored, jnp.asarray(x))) \
        <= 1e-5


def test_from_torch_state_dict_skips_downsample_batchnorm():
    model = alt_resnet.init_resnet(torch.Generator().manual_seed(0),
                                   [2, 2, 2, 2], device="cpu")
    jp = jalt.init_resnet(jax.random.PRNGKey(0), [2, 2, 2, 2])
    w = model.layer2[0].downsample[0].weight
    conv = np.random.default_rng(0).standard_normal(
        tuple(w.shape)).astype(np.float32)
    c = w.shape[0]
    sd = {"layer2.0.downsample.0.weight": conv,
          "layer2.0.downsample.1.weight": np.ones((c,), np.float32),
          "layer2.0.downsample.1.bias": np.zeros((c,), np.float32),
          "layer2.0.downsample.1.running_mean": np.zeros((c,), np.float32)}
    _, loaded = alt_resnet.from_torch_state_dict(model, sd)
    _, jloaded = jalt.from_torch_state_dict(jp, sd)
    assert loaded == jloaded == ["layer2.0.downsample.0.weight"]
    np.testing.assert_array_equal(w.detach().numpy(), conv)


def test_from_pretrained_offline_error_and_delegation(monkeypatch):
    model = alt_resnet.resnet18(torch.Generator().manual_seed(0),
                                device="cpu")
    seen = {}

    def boom(url, **kw):
        seen["url"] = url
        raise OSError("no egress")

    monkeypatch.setattr(torch.hub, "load_state_dict_from_url", boom)
    with pytest.raises(RuntimeError, match="from_torch_state_dict"):
        alt_resnet.from_pretrained(model, "resnet18")
    assert seen["url"] == alt_resnet.MODEL_URLS["resnet18"] \
        == jalt.MODEL_URLS["resnet18"]

    sd = {"conv1.weight": torch.zeros(64, 3, 7, 7),
          "bn1.weight": torch.ones(64)}
    monkeypatch.setattr(torch.hub, "load_state_dict_from_url",
                        lambda *a, **k: sd)
    out, loaded = alt_resnet.from_pretrained(model, "resnet34",
                                             url="file:///nowhere.pth")
    assert loaded == ["conv1.weight"]
    assert float(out.conv1.weight.detach().abs().max()) == 0.0
