"""The port's gated-attention pool against the JAX Pallas pool.

On the CPU the port's wrapper takes its plain versions; the JAX pool runs
its Pallas kernel in interpret mode, as tests/test_pallas_and_inference.py
runs it. Tolerances are that test's: A1^T and wROIs to 1e-6, M to 1e-5;
gradients to 2e-5, the bound of
test_pallas_pool_gradients_match_unfused. The CUDA kernels themselves are
held to the plain versions on the card by chip_smoke.py."""

import numpy as np
import pytest
import torch

import conftest  # noqa: F401
import jax
import jax.numpy as jnp

from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu.ops import (
    nn as JN,
    pallas_pool,
)
from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch import (
    _device,
)
from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.ops import (
    _build,
    gated_pool,
)


def _inputs(t, k, o, seed=0, all_masked=False):
    rng = np.random.default_rng(seed)
    a_raw = rng.standard_normal((t, k)).astype(np.float32)
    b = rng.standard_normal((t, o)).astype(np.float32)
    mask = (rng.random(t) > 0.3).astype(np.float32)
    if all_masked:
        mask[:] = 0.0
    wm = rng.standard_normal((k,)).astype(np.float32)
    return a_raw, b, mask, wm


def _port(a_raw, b, mask, wm):
    outs = gated_pool.gated_attention_pool(
        *(torch.from_numpy(np.array(x)) for x in (a_raw, b, mask, wm)))
    return [x.numpy() for x in outs]


def _check(got, want):
    (m_g, a_g, w_g), (m_w, a_w, w_w) = got, [np.asarray(x) for x in want]
    assert m_g.shape == m_w.shape and a_g.shape == a_w.shape
    np.testing.assert_allclose(m_g, m_w, atol=1e-5)
    np.testing.assert_allclose(a_g, a_w, atol=1e-6)
    np.testing.assert_allclose(w_g, w_w, atol=1e-6)


@pytest.mark.parametrize("t,k,o,all_masked", [
    (64, 3, 1, False), (100, 3, 1, False), (7, 5, 2, False),
    (64, 3, 1, True)])
def test_plain_pool_matches_pallas(t, k, o, all_masked):
    inputs = _inputs(t, k, o, all_masked=all_masked)
    want = pallas_pool.gated_attention_pool(*map(jnp.asarray, inputs))
    got = _port(*inputs)
    _check(got, want)
    if all_masked:
        assert not np.any(got[1]) and not np.any(got[0])


def test_plain_pool_above_jax_cap_matches_unfused_chain():
    """T=3000 is above the JAX kernel's VMEM cap (2560); the port has no
    cap, and agrees with the JAX unfused chain there."""
    a_raw, b, mask, wm = map(jnp.asarray, _inputs(3000, 3, 1, seed=1))
    assert 3000 > pallas_pool.PALLAS_POOL_MAX_TILES
    gated = (jax.nn.sigmoid(-10.0 * wm) * JN.softplus(a_raw)
             + jax.nn.sigmoid(10.0 * wm)) * mask[:, None]
    a1t = JN.l1_normalize(gated, axis=0).T
    want = (a1t @ b, a1t, a1t * b[:, 0][None, :])
    _check(_port(*map(np.asarray, (a_raw, b, mask, wm))), want)


def test_pool_refuses_inputs_that_require_grad():
    """The pool used to be forward-only and refused such inputs; it now
    takes them and builds a graph (with the mask given no gradient), and
    without autograd it builds none."""
    a_raw, b, mask, wm = (torch.from_numpy(x) for x in _inputs(8, 3, 1))
    a_raw.requires_grad_()
    wm.requires_grad_()
    m, a1t, wrois = gated_pool.gated_attention_pool(a_raw, b, mask, wm)
    assert m.requires_grad and a1t.requires_grad and wrois.requires_grad
    m.sum().backward()
    assert a_raw.grad is not None and wm.grad is not None
    assert b.grad is None and mask.grad is None
    with torch.no_grad():  # no graph is built
        m, _, _ = gated_pool.gated_attention_pool(a_raw, b, mask, wm)
    assert not m.requires_grad


def _cotangents(t, k, o, seed, only_dm):
    rng = np.random.default_rng(seed + 1000)
    dm = rng.standard_normal((k, o)).astype(np.float32)
    if only_dm:
        return dm, None, None
    return (dm, rng.standard_normal((k, t)).astype(np.float32),
            rng.standard_normal((k, t)).astype(np.float32))


def _torch(x):
    return None if x is None else torch.from_numpy(np.array(x))


GRAD_CASES = [(64, 3, 1, False, False), (100, 3, 1, True, False),
              (7, 5, 2, False, False), (64, 3, 1, False, True),
              (3000, 3, 1, False, False)]


@pytest.mark.parametrize("t,k,o,only_dm,all_masked", GRAD_CASES)
def test_plain_backward_matches_jax_grad(t, k, o, only_dm, all_masked):
    """The closed-form backward against jax.grad through the Pallas pool's
    custom VJP (interpret mode), with all three cotangents random and with
    only dM (the training path's pattern), and with the mask all zero."""
    a_raw, b, mask, wm = _inputs(t, k, o, seed=t, all_masked=all_masked)
    cots = _cotangents(t, k, o, t, only_dm)
    jc = [jnp.zeros((k, o)) if c is None else jnp.asarray(c) for c in cots]
    jc = [jc[0]] + [jnp.zeros((k, t)) if c is None else jnp.asarray(c)
                    for c in cots[1:]]

    def scalar(a, bb, w):
        m_, a1t_, w_ = pallas_pool.gated_attention_pool(
            a, bb, jnp.asarray(mask), w)
        return (jnp.sum(m_ * jc[0]) + jnp.sum(a1t_ * jc[1])
                + jnp.sum(w_ * jc[2]))

    want = jax.grad(scalar, argnums=(0, 1, 2))(
        jnp.asarray(a_raw), jnp.asarray(b), jnp.asarray(wm))
    args = [_torch(x) for x in (a_raw, b, mask, wm)]
    a1t = gated_pool.gated_attention_pool(*args)[1]
    got = gated_pool.gated_attention_pool_backward_reference(
        *args, a1t, *map(_torch, cots))
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-5)
    if all_masked:
        assert not any(np.any(g.numpy()) for g in (got[0], got[2]))


@pytest.mark.parametrize("t,k,o,only_dm,all_masked", GRAD_CASES)
def test_plain_backward_matches_autograd_of_plain_forward(t, k, o, only_dm,
                                                          all_masked):
    """The closed form against torch autograd through the unfused plain
    forward, and the autograd Function's gradients against both."""
    a_raw, b, mask, wm = _inputs(t, k, o, seed=t, all_masked=all_masked)
    cots = [_torch(c) for c in _cotangents(t, k, o, t, only_dm)]

    def grads(fn):
        a, bb, w = (_torch(x).requires_grad_() for x in (a_raw, b, wm))
        outs = fn(a, bb, _torch(mask), w)
        loss = sum((x * c).sum() for x, c in zip(outs, cots) if c is not None)
        loss.backward()
        return a.grad, bb.grad, w.grad

    want = grads(gated_pool.gated_attention_pool_reference)
    via_function = grads(gated_pool.gated_attention_pool)
    args = [_torch(x) for x in (a_raw, b, mask, wm)]
    a1t = gated_pool.gated_attention_pool(*args)[1]
    closed = gated_pool.gated_attention_pool_backward_reference(
        *args, a1t, *cots)
    for c, f, w in zip(closed, via_function, want):
        np.testing.assert_allclose(c.numpy(), w.numpy(), atol=2e-5)
        np.testing.assert_allclose(f.numpy(), w.numpy(), atol=2e-5)


@pytest.mark.parametrize("uses", ["M only", "all three"])
def test_backward_takes_absent_cotangents(uses, monkeypatch):
    """Grads are not materialised: when only M feeds the loss (A1^T and
    wROIs detached, as on the training path), the backward receives None
    for the other two and the kernel skips them; with all three used it
    receives all three. Both patterns give autograd's gradients."""
    a_raw, b, mask, wm = _inputs(50, 3, 1, seed=5)
    seen = []
    real = gated_pool.gated_attention_pool_backward

    def spy(*args):
        seen.append([c is None for c in args[5:]])
        return real(*args)

    monkeypatch.setattr(gated_pool, "gated_attention_pool_backward", spy)

    def run(fn):
        a, bb, w = (_torch(x).requires_grad_() for x in (a_raw, b, wm))
        m, a1t, wrois = fn(a, bb, _torch(mask), w)
        loss = (m ** 2).sum()
        if uses == "all three":
            loss = loss + (a1t ** 3).sum() + wrois.sum()
        loss.backward()
        return a.grad, bb.grad, w.grad

    got = run(gated_pool.gated_attention_pool)
    want = run(gated_pool.gated_attention_pool_reference)
    assert seen == [[False, True, True] if uses == "M only"
                    else [False, False, False]]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=2e-5)


@pytest.mark.parametrize("bad", ["shape", "empty", "device"])
def test_pool_refuses_bad_inputs(bad):
    a_raw, b, mask, wm = (torch.from_numpy(x) for x in _inputs(8, 3, 1))
    if bad == "shape":
        args, err = (a_raw, b[:5], mask, wm), ValueError
    elif bad == "empty":
        args, err = (a_raw[:0], b[:0], mask[:0], wm), ValueError
    else:
        args, err = (a_raw.to("meta"), b.to("meta"), mask.to("meta"),
                     wm.to("meta")), ValueError
    launches = gated_pool.LAUNCHES
    with pytest.raises(err):
        gated_pool.gated_attention_pool(*args)
    assert gated_pool.LAUNCHES == launches


def test_cuda_request_without_card_raises(monkeypatch):
    """No card: the entry points' default device raises, and the kernel
    build raises without nvcc instead of falling back."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _device.resolve_device(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _device.resolve_device("cuda")
    assert _device.resolve_device("cpu").type == "cpu"
    monkeypatch.setenv("PATH", "")
    monkeypatch.setenv("CUDA_HOME", "/nonexistent")
    monkeypatch.setattr(_build.os.path, "isfile", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build("gated_pool")


@pytest.mark.parametrize("t", [1, gated_pool.POOL_RANGE - 1,
                               gated_pool.POOL_RANGE,
                               gated_pool.POOL_RANGE + 1,
                               2 * gated_pool.POOL_RANGE + 1, 50000])
def test_pool_partition_covers_every_tile_once(t):
    """The kernel's ranges cover [0, T) exactly once, in order, none empty;
    one range (one launch, no scratch) exactly when T fits one."""
    nblk, tiles = gated_pool.pool_partition(t)
    assert tiles == gated_pool.POOL_RANGE
    covered = np.zeros(t, np.int64)
    for j in range(nblk):
        lo, hi = j * tiles, min(t, (j + 1) * tiles)
        assert lo < hi
        covered[lo:hi] += 1
    assert np.all(covered == 1)
    assert (nblk == 1) == (t <= gated_pool.POOL_RANGE)


def test_pool_partition_refuses_an_empty_bag():
    with pytest.raises(ValueError):
        gated_pool.pool_partition(0)
