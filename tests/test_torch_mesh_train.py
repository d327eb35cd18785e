"""The port's window step on a mesh against the JAX package's.

One window of four bags (one of them a dummy, weight 0; one padded with
masked tiles) goes through ``make_train_step(mesh=)`` on spawned gloo
ranks, and through the JAX package's ``make_train_step`` on the same mesh
shape of its 8-device CPU mesh: 2 ranks (slides 1 x tiles 2) and 4 ranks
(2 x 2). Both get the same numpy inputs and weights, and the same noise
(JAX's ``jax.random.gumbel`` / ``bernoulli`` patched, as
tests/test_torch_train_model.py does, so every bag gets the same draws).
A bag's 20 % subsample is 5 of its 26 tiles, so the port pads it to 6 rows
for the tile axis.

Held: the window's summed gradient, read as Adam's first moment, to
2e-5 x max(1, max|g|) per parameter; the parameters after the step to
2e-5 x max(1, max|p|) wherever JAX's gradient is above 1e-6 (Adam's step
is lr * g / (|g| + eps): where the summed gradient is zero but for
rounding, such as the classifier's bias, whose gradient is the sum of the
softmax cotangents, the step's sign is the rounding's); the metrics to
1e-5, the dummy bag's ``y_pred_hat`` -1; every rank's parameters the same,
bit for bit."""

import numpy as np
import pytest
import torch

import conftest  # noqa: F401
import jax
import jax.numpy as jnp
import torch_mesh_workers as W

from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu.models import (
    attention_mil as jamil,
)
from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu.parallel import (
    mesh as JM,
    steps as jsteps,
)
from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.models import (
    attention_mil as tamil,
)
from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.parallel import (
    mesh as TM,
)
from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.utils import (
    interop,
)

TINY = dict(widths=(8, 12, 12, 16), blocks=(1, 1, 1, 1), L=16, D=8,
            class_weights=(0.5, 1.0, 2.0))
B, T, PX, LR = 4, 26, 16, 1e-3


@pytest.fixture(scope="module")
def window():
    jcfg = jamil.MILConfig(**TINY)
    jp = jax.jit(jamil.init_attention_mil, static_argnums=1)(
        jax.random.PRNGKey(5), jcfg)
    model = interop.load_jax_params(
        tamil.AttentionMIL(tamil.MILConfig(**TINY), device="cpu"), jp)
    state = {k: v.numpy() for k, v in model.state_dict().items()}
    rng = np.random.default_rng(0)
    tiles = rng.uniform(-1, 1, (B, T, PX, PX, 3)).astype(np.float32)
    masks = np.ones((B, T), np.float32)
    masks[1, -6:] = 0.0
    tiles[1, -6:] = 0.0
    labels = np.array([0, 2, 1, 0], np.int32)
    weights = np.array([1, 1, 1, 0], np.float32)
    scores = rng.gumbel(size=T).astype(np.float32)
    keep = rng.random((int(T * 0.2), TINY["L"])) < 0.75
    return jcfg, jp, state, tiles, masks, labels, weights, scores, keep


def _jax_steps(monkeypatch, window, slides, n, windows):
    jcfg, jp, _, tiles, masks, labels, weights, scores, keep = window
    monkeypatch.setattr(jax.random, "gumbel",
                        lambda key, shape, *a, **k: jnp.asarray(scores))
    monkeypatch.setattr(jax.random, "bernoulli",
                        lambda key, p, shape, *a, **k: jnp.asarray(keep))
    mesh = JM.make_mesh(n, slides=slides)
    st = jsteps.replicate_state(mesh, jsteps.init_train_state(jp))
    batch = jsteps.shard_batch(mesh, jnp.asarray(tiles), jnp.asarray(masks),
                               jnp.asarray(labels))
    step = jsteps.make_train_step(jcfg, donate=False)
    with mesh:
        for _ in range(windows):
            st, metrics = step(st, *batch, jnp.float32(LR),
                               jax.random.PRNGKey(1), jnp.asarray(weights))
    return st, metrics


def _port_steps(window, slides, n, windows):
    _, _, state, tiles, masks, labels, weights, scores, keep = window
    return TM.launch(W.train_window, n, slides=slides, devices=["cpu"] * n,
                     args=(TINY, state, list(tiles), list(masks), labels,
                           weights, scores, keep, LR, windows))


def _check(jst, jmetrics, out):
    got = out[0]
    want_mu = interop.state_dict_from_jax(jst.opt_state.mu)
    want_p = interop.state_dict_from_jax(jst.params)
    assert sorted(got["mu"]) == sorted(want_mu)
    for name, mu in want_mu.items():
        g, g_port = np.asarray(mu) / 0.1, got["mu"][name] / 0.1
        tol = 2e-5 * max(1.0, float(np.abs(g).max()))
        assert float(np.abs(g_port - g).max()) <= tol, name
        p, p_port = np.asarray(want_p[name]), got["params"][name]
        tol = 2e-5 * max(1.0, float(np.abs(p).max()))
        determined = np.abs(g) > 1e-6
        assert float(np.abs(p_port - p)[determined].max(initial=0.0)) <= tol, \
            name
    for key in ("loss", "error", "Aterm_mu", "Aterm_var", "KLD", "l2"):
        np.testing.assert_allclose(got["metrics"][key],
                                   float(jmetrics[key]), atol=1e-5,
                                   err_msg=key)
    np.testing.assert_allclose(got["metrics"]["y_pred"],
                               np.asarray(jmetrics["y_pred"]), atol=1e-5)
    yhat = got["metrics"]["y_pred_hat"]
    np.testing.assert_array_equal(yhat, np.asarray(jmetrics["y_pred_hat"]))
    assert yhat[-1] == -1
    for rank in out[1:]:
        for name, p in rank["params"].items():
            np.testing.assert_array_equal(p, got["params"][name], name)


@pytest.mark.parametrize("slides,n", [(1, 2), (2, 2 * 2)])
def test_window_step_matches_jax(monkeypatch, window, slides, n):
    jst, jmetrics = _jax_steps(monkeypatch, window, slides, n, 1)
    _check(jst, jmetrics, _port_steps(window, slides, n, 1))


@pytest.mark.slow
def test_three_windows_on_four_ranks_match_jax(monkeypatch, window):
    jst, jmetrics = _jax_steps(monkeypatch, window, 2, 4, 3)
    _check(jst, jmetrics, _port_steps(window, 2, 4, 3))


@pytest.mark.parametrize("masked", [0, 7])
def test_subsample_breaks_ties_as_lax_top_k(monkeypatch, masked):
    """The subsample's choice with equal Gumbel scores (a bag of thousands
    of float32 draws holds a few) equals JAX's ``_subsample``, whose
    ``lax.top_k`` takes the lower index first, on the port's CPU path: the
    order decides which tile meets which row of the dropout mask, and the
    mesh trainer and the single-card trainer must choose alike."""
    n = 60
    rng = np.random.default_rng(3)
    scores = rng.choice(np.float32([-0.5, 0.25, 1.0, 2.0]), n)
    mask = np.ones(n, np.float32)
    mask[:masked] = 0.0
    monkeypatch.setattr(jax.random, "gumbel",
                        lambda key, shape: jnp.asarray(scores))
    tiles = jnp.arange(n, dtype=jnp.float32)
    jt, jm = jamil._subsample(tiles, jnp.asarray(mask), 0.2,
                              jax.random.PRNGKey(0))
    idx, sub = tamil.subsample_index(torch.from_numpy(mask), 0.2,
                                     torch.from_numpy(scores))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jt).astype(np.int64))
    np.testing.assert_array_equal(sub.numpy(), np.asarray(jm))
