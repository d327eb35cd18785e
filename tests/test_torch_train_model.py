"""The port's training forward and bag gradient against the JAX package.

JAX's and torch's random streams differ, so both packages get the same
noise: the Gumbel scores of the tile subsample and the dropout keep mask
are made with numpy and injected (the JAX side through its own
``jax.random.gumbel`` / ``jax.random.bernoulli`` calls, patched to return
them). The JAX parameters are carried across by utils/interop.py. Every
gradient leaf is held to max abs <= 2e-5 x max(1, max|g_jax|)."""

import numpy as np
import pytest
import torch

import conftest  # noqa: F401
import jax
import jax.numpy as jnp

from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu.models import (
    attention_mil as jamil,
)
from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.models import (
    attention_mil as tamil,
)
from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.utils import (
    interop,
)

TINY = dict(widths=(8, 12, 12, 16), blocks=(1, 1, 1, 1), L=16, D=8)
T, PX = 20, 16


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], f"{prefix}{k}/"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}{i}/"))
        return out
    return {prefix[:-1]: np.asarray(tree)}


@pytest.fixture(scope="module")
def tiny():
    jcfg = jamil.MILConfig(class_weights=(0.5, 1.0, 2.0), **TINY)
    jp = jax.jit(jamil.init_attention_mil, static_argnums=1)(
        jax.random.PRNGKey(5), jcfg)
    cfg = tamil.MILConfig(class_weights=jcfg.class_weights, **TINY)
    model = interop.load_jax_params(tamil.AttentionMIL(cfg, device="cpu"), jp)
    return jcfg, jp, cfg, model


def _bag(padded, seed=0):
    rng = np.random.default_rng(seed)
    tiles = rng.uniform(-1, 1, (T, PX, PX, 3)).astype(np.float32)
    mask = np.ones(T, np.float32)
    if padded:
        mask[-5:] = 0.0
        tiles[-5:] = 0.0
    scores = rng.gumbel(size=T).astype(np.float32)
    k = max(1, int(T * 0.2))
    keep = rng.random((k, TINY["L"])) < 0.75
    return tiles, mask, scores, keep


def _patch_jax_noise(monkeypatch, scores, keep):
    monkeypatch.setattr(jax.random, "gumbel",
                        lambda key, shape, *a, **k: jnp.asarray(scores))
    monkeypatch.setattr(jax.random, "bernoulli",
                        lambda key, p, shape, *a, **k: jnp.asarray(keep))


def _jax_grad(jp, jcfg, tiles, mask, label):
    def loss_fn(p):
        outs = jamil.apply_attention_mil(
            p, jnp.asarray(tiles), label, jcfg, mask=jnp.asarray(mask),
            train=True, rng=jax.random.PRNGKey(0))
        return outs["loss"], outs

    return jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(jp)


def _port_grad(model, cfg, tiles, mask, scores, keep, label):
    model.zero_grad(set_to_none=True)
    outs = tamil.apply_attention_mil(
        model, torch.from_numpy(tiles), label, cfg,
        mask=torch.from_numpy(mask), train=True,
        scores=torch.from_numpy(scores), keep=torch.from_numpy(keep))
    outs["loss"].backward()
    return outs, interop.jax_params_from_module(model, lambda p: p.grad)


@pytest.mark.parametrize("padded", [False, True])
def test_bag_gradient_matches_jax(tiny, monkeypatch, padded):
    jcfg, jp, cfg, model = tiny
    tiles, mask, scores, keep = _bag(padded)
    _patch_jax_noise(monkeypatch, scores, keep)
    (jloss, jouts), jgrads = _jax_grad(jp, jcfg, tiles, mask, 2)
    outs, grads = _port_grad(model, cfg, tiles, mask, scores, keep, 2)
    np.testing.assert_allclose(float(outs["loss"].detach()), float(jloss),
                               atol=1e-5)
    for key in ("y_pred", "Mterm", "Aterm", "KLD", "Aterm_var"):
        np.testing.assert_allclose(outs[key].numpy(), np.asarray(jouts[key]),
                                   atol=1e-5)
    jflat, flat = _flat(jgrads), _flat(grads)
    assert sorted(jflat) == sorted(flat)
    for name, gj in jflat.items():
        assert flat[name].shape == gj.shape, name
        tol = 2e-5 * max(1.0, float(np.abs(gj).max()))
        assert float(np.abs(flat[name] - gj).max()) <= tol, name


def test_only_loss_carries_a_gradient(tiny):
    _, _, cfg, model = tiny
    tiles, mask, scores, keep = _bag(False)
    outs = tamil.apply_attention_mil(
        model, torch.from_numpy(tiles), 0, cfg, train=True,
        scores=torch.from_numpy(scores), keep=torch.from_numpy(keep))
    assert outs["loss"].requires_grad
    assert not any(v.requires_grad for k, v in outs.items() if k != "loss")
    assert outs["Aterm"].shape == (cfg.K, int(T * cfg.train_tile_fraction))
    evals = tamil.apply_attention_mil(model, torch.from_numpy(tiles), 0, cfg)
    assert not evals["loss"].requires_grad
    assert evals["Aterm"].shape == (cfg.K, T)


def test_remat_gives_the_same_gradients(tiny):
    _, _, cfg, model = tiny
    tiles, mask, scores, keep = _bag(True, seed=3)
    _, plain = _port_grad(model, cfg, tiles, mask, scores, keep, 1)
    remat_model = tamil.AttentionMIL(
        tamil.MILConfig(**{**cfg.__dict__, "remat": True}), device="cpu")
    remat_model.load_state_dict(model.state_dict())
    _, remat = _port_grad(remat_model, remat_model.cfg, tiles, mask, scores,
                          keep, 1)
    for name, g in _flat(plain).items():
        np.testing.assert_allclose(_flat(remat)[name], g, rtol=0,
                                   atol=1e-7 * max(1.0, np.abs(g).max()))


@pytest.mark.parametrize("padded", [False, True])
def test_subsample_matches_jax(monkeypatch, padded):
    """The same tiles and mask as the JAX package's static-size Gumbel
    top-k, on a padded bag (k_static candidates, the tail masked) and an
    unpadded one."""
    tiles, mask, scores, _ = _bag(padded, seed=9)
    tiles = np.arange(T, dtype=np.float32)[:, None] * np.ones((T, 4),
                                                              np.float32)
    _patch_jax_noise(monkeypatch, scores, np.ones((1,), bool))
    jt, jm = jamil._subsample(jnp.asarray(tiles), jnp.asarray(mask), 0.2,
                              jax.random.PRNGKey(0))
    pt, pm = tamil._subsample(torch.from_numpy(tiles), torch.from_numpy(mask),
                              0.2, torch.from_numpy(scores))
    np.testing.assert_array_equal(pt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(pm.numpy(), np.asarray(jm))
    assert pm.sum() == max(1, int(mask.sum() * 0.2))


def test_train_noise_from_a_generator(tiny):
    """Without injected noise the forward draws it from the generator:
    the same seed gives the same loss, and no generator is an error."""
    _, _, cfg, model = tiny
    tiles = torch.from_numpy(_bag(False)[0])
    with pytest.raises(ValueError, match="generator"):
        tamil.apply_attention_mil(model, tiles, 0, cfg, train=True)
    losses = [float(tamil.apply_attention_mil(
        model, tiles, 0, cfg, train=True,
        generator=torch.Generator().manual_seed(s))["loss"].detach())
        for s in (4, 4, 5)]
    assert losses[0] == losses[1] != losses[2]


def test_eval_step_matches_jax(tiny):
    """The stacked per-bag eval outputs of a padded batch of two bags."""
    from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu.parallel import (
        steps as jsteps,
    )
    from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.parallel import (
        steps,
    )

    jcfg, jp, cfg, model = tiny
    bags = [_bag(False, seed=1), _bag(True, seed=2)]
    tiles = np.stack([b[0] for b in bags])
    masks = np.stack([b[1] for b in bags])
    labels = np.asarray([0, 2], np.int32)
    want = jsteps.make_eval_step(jcfg)(jp, jnp.asarray(tiles),
                                       jnp.asarray(masks), jnp.asarray(labels))
    got = steps.make_eval_step(cfg)(model, torch.from_numpy(tiles),
                                    torch.from_numpy(masks),
                                    torch.from_numpy(labels))
    assert sorted(got) == sorted(want)
    for key in ("y_pred", "Mterm", "Aterm", "loss", "KLD", "error"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   atol=1e-5)
