"""The port's optimizer, optimizer checkpoints and driver helpers against
the JAX package.

Adam is held by feeding optax and the port the SAME gradients (3 steps,
max abs <= 1e-3 x lr): comparing parameters after steps on independently
computed gradients would let Adam's near-sign first step magnify
summation-order noise. Checkpoints move both ways with their Adam moments,
leaves bitwise equal. The weight summaries, the model summary and the
classification report are held to the JAX package's and scikit-learn's."""

import argparse
import json
import os
import time

import numpy as np
import pytest
import torch

import conftest  # noqa: F401
import jax
import optax
from sklearn.metrics import classification_report as sk_report

from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu.models import (
    attention_mil as jamil,
)
from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu.parallel import (
    steps as jsteps,
)
from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu.train import (
    checkpoint as jckpt,
)
from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu.utils import (
    helpers as jhelpers,
    plots as jplots,
)
from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.models import (
    attention_mil as tamil,
)
from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.parallel import (
    steps,
)
from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.train import (
    checkpoint,
)
from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.utils import (
    helpers,
    interop,
    plots,
)

TINY = dict(widths=(8, 8, 8, 8), blocks=(1, 1, 1, 1))
_jax_init = jax.jit(jamil.init_attention_mil, static_argnums=1)


@pytest.fixture(scope="module")
def jax_params():
    return _jax_init(jax.random.PRNGKey(2), jamil.MILConfig(**TINY))


def _model(seed=0):
    return tamil.init_attention_mil(torch.Generator().manual_seed(seed),
                                    tamil.MILConfig(**TINY), device="cpu")


def _grads(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda p: rng.standard_normal(np.shape(p)).astype(np.float32)
        * (0.1 if seed % 2 else 1e-4), params)


def _set_grads(model, grads):
    sd = interop.state_dict_from_jax(grads)
    for name, p in model.named_parameters():
        p.grad = sd[name].clone()


def _flat(tree):
    return jckpt._flatten(tree)


_jax_apply = jsteps.make_apply_updates(jsteps.make_optimizer())


def _jax_steps(params, n, lr):
    state = jsteps.init_train_state(params, jsteps.make_optimizer())
    for i in range(n):
        state = _jax_apply(state, _grads(params, i), lr)
    return state


def test_adam_matches_optax_given_the_same_gradients(jax_params):
    lr = 1e-3
    model = interop.load_jax_params(_model(), jax_params)
    opt = steps.make_optimizer(model)
    state = jsteps.init_train_state(jax_params, jsteps.make_optimizer())
    for i in range(3):
        g = _grads(jax_params, i)
        state = _jax_apply(state, g, lr)
        _set_grads(model, g)
        steps.apply_updates(opt, lr)
        assert all(p.grad is None for p in model.parameters())
        want = _flat(state.params)
        got = _flat(interop.jax_params_from_module(model))
        for k, w in want.items():
            assert float(np.abs(got[k] - w).max()) <= 1e-3 * lr, (i, k)
    count, mu, nu = interop.adam_state_to_jax(model, opt)
    assert int(count) == int(state.opt_state.count) == 3
    for mine, theirs in ((mu, state.opt_state.mu), (nu, state.opt_state.nu)):
        for k, w in _flat(theirs).items():
            np.testing.assert_allclose(_flat(mine)[k], w, rtol=1e-6,
                                       atol=1e-12)


def test_a_parameter_without_gradient_steps_like_optax(jax_params):
    """optax updates every leaf; a parameter the loss did not reach steps
    with a zero gradient (its moments decay, the count advances)."""
    model = interop.load_jax_params(_model(), jax_params)
    opt = steps.make_optimizer(model)
    _set_grads(model, _grads(jax_params, 0))
    steps.apply_updates(opt, 1e-3)
    _set_grads(model, _grads(jax_params, 1))
    model.weight_mask.grad = None
    steps.apply_updates(opt, 1e-3)
    assert int(opt.state[model.weight_mask]["step"]) == 2


def test_jax_checkpoint_resumes_in_the_port(jax_params, tmp_path):
    lr = 1e-3
    state = _jax_steps(jax_params, 2, lr)
    path = str(tmp_path / "train_step-001.model")
    jckpt.save(path, state.params, state.opt_state)
    model = _model(seed=9)
    opt = steps.make_optimizer(model)
    _, loaded, skipped = checkpoint.restore_params(model, path)
    assert not skipped and len(loaded) == len(_flat(jax_params))
    _, ok = checkpoint.restore_opt_state(opt, model, path)
    assert ok
    for k, w in _flat(state.params).items():
        np.testing.assert_array_equal(
            _flat(interop.jax_params_from_module(model))[k], w)
    count, mu, nu = interop.adam_state_to_jax(model, opt)
    assert int(count) == 2
    for mine, theirs in ((mu, state.opt_state.mu), (nu, state.opt_state.nu)):
        for k, w in _flat(theirs).items():
            np.testing.assert_array_equal(_flat(mine)[k], w)
    # resume: one more step on the same gradients in both
    after = _jax_apply(state, _grads(jax_params, 2), lr)
    _set_grads(model, _grads(jax_params, 2))
    steps.apply_updates(opt, lr)
    for k, w in _flat(after.params).items():
        got = _flat(interop.jax_params_from_module(model))[k]
        assert float(np.abs(got - w).max()) <= 1e-3 * lr, k


def test_port_checkpoint_restores_in_jax(jax_params, tmp_path):
    model = interop.load_jax_params(_model(), jax_params)
    opt = steps.make_optimizer(model)
    for i in range(2):
        _set_grads(model, _grads(jax_params, i))
        steps.apply_updates(opt, 1e-3)
    path = checkpoint.save(str(tmp_path / "train_step-004.model"), model,
                           opt)
    fresh = _jax_init(jax.random.PRNGKey(8), jamil.MILConfig(**TINY))
    params, loaded, skipped = jckpt.restore_params(fresh, path, strict=True)
    assert not skipped
    opt_state = optax.scale_by_adam(b1=0.9, b2=0.999, eps=1e-8).init(fresh)
    opt_state, ok = jckpt.restore_opt_state(opt_state, path)
    assert ok
    count, mu, nu = interop.adam_state_to_jax(model, opt)
    assert int(opt_state.count) == int(count) == 2
    for k, v in _flat(interop.jax_params_from_module(model)).items():
        np.testing.assert_array_equal(_flat(params)[k], v)
    for theirs, mine in ((opt_state.mu, mu), (opt_state.nu, nu)):
        for k, v in _flat(mine).items():
            np.testing.assert_array_equal(_flat(theirs)[k], v)


def test_restore_opt_state_without_optimizer_keys(tmp_path):
    model = _model()
    opt = steps.make_optimizer(model)
    path = checkpoint.save(str(tmp_path / "p.model"), model)
    assert checkpoint.restore_opt_state(opt, model, path) == (opt, False)
    assert not opt.state


def test_async_checkpointer_snapshots_before_an_in_place_step(tmp_path,
                                                              monkeypatch):
    """optimizer.step() updates parameters in place, so save() must copy
    them before it returns: the file holds the values at save() time even
    when the write starts after the next step."""
    model = _model()
    opt = steps.make_optimizer(model)
    for p in model.parameters():
        p.grad = torch.ones_like(p)
    steps.apply_updates(opt, 1e-2)
    want = checkpoint.snapshot(model, opt)
    real = checkpoint.save_blob

    def slow_save_blob(path, blob):
        time.sleep(0.3)
        return real(path, blob)

    monkeypatch.setattr(checkpoint, "save_blob", slow_save_blob)
    writer = checkpoint.AsyncCheckpointer()
    path = str(tmp_path / "train_step-000.model")
    writer.save(path, model, opt)
    for p in model.parameters():  # the next window's step, in place
        p.grad = torch.ones_like(p)
    steps.apply_updates(opt, 1e-2)
    writer.wait()
    got = checkpoint.load_raw(path)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v)
    assert not np.array_equal(
        got["classifier/weight_mask"],
        checkpoint.snapshot(model)["classifier/weight_mask"])
    # a failed write re-raises at the next wait()
    writer.save(str(tmp_path / "missing" / "x.model"), model)
    with pytest.raises(OSError):
        writer.wait()


def test_weight_summaries_and_model_summary_match_jax(jax_params, tmp_path):
    model = interop.load_jax_params(_model(), jax_params)
    for port_fn, jax_fn in (
            (helpers.get_layer_weight_summary_mean,
             jhelpers.get_layer_weight_summary_mean),
            (helpers.get_layer_weight_summary_max,
             jhelpers.get_layer_weight_summary_max)):
        got, want = port_fn(model), jax_fn(jax_params)
        assert list(got) == list(want)
        np.testing.assert_allclose(list(got.values()), list(want.values()),
                                   rtol=1e-6)
    assert helpers.model_summary(model) == jhelpers.model_summary(jax_params)
    stats = {"train_loss": np.float32(0.5), "valid_eval_mode": False}
    args = argparse.Namespace(tag="T", accum=5, lst=[1])
    for mod, sub in ((helpers, "port"), (jhelpers, "jax")):
        os.makedirs(tmp_path / sub)
        mod.savestats(args, str(tmp_path / sub), 3, stats)
        plots_mod = plots if mod is helpers else jplots
        plots_mod.save_predictions(str(tmp_path / sub), 3, [0.25, 0.5],
                                   [1, 0])
    for name in ("0003summary.json", "0003predictions.json"):
        with open(tmp_path / "port" / name) as a, \
                open(tmp_path / "jax" / name) as b:
            assert json.load(a) == json.load(b)


@pytest.mark.parametrize("seed,n", [(0, 1), (1, 7), (2, 40), (3, 12)])
def test_classification_report_equals_sklearn(seed, n):
    rng = np.random.default_rng(seed)
    y_true = rng.integers(0, 3, n)
    y_pred = np.zeros(n, int) if seed == 3 else rng.integers(0, 3, n)
    kw = dict(labels=[0, 1, 2], target_names=["A", "B", "C"])
    got = helpers.classification_report(y_true, y_pred, **kw)
    want = sk_report(y_true, y_pred, output_dict=True, zero_division=0,
                     **kw)
    assert list(got) == list(want)
    for key, row in want.items():
        if isinstance(row, dict):
            assert list(got[key]) == list(row)
            for k, v in row.items():
                assert got[key][k] == pytest.approx(v, abs=1e-12)
        else:
            assert got[key] == pytest.approx(row, abs=1e-12)
