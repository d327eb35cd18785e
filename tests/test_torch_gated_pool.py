"""The port's gated-attention pool against the JAX Pallas pool.

On the CPU the port's wrapper takes its plain version; the JAX pool runs
its Pallas kernel in interpret mode, as tests/test_pallas_and_inference.py
runs it. Tolerances are that test's: A1^T and wROIs to 1e-6, M to 1e-5.
The CUDA kernel itself is held to the plain version on the card by
chip_smoke.py."""

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
    a_raw, b, mask, wm = (torch.from_numpy(x) for x in _inputs(8, 3, 1))
    with pytest.raises(RuntimeError, match="forward-only"):
        gated_pool.gated_attention_pool(a_raw.requires_grad_(), b, mask, wm)
    with torch.no_grad():  # no graph is built, so nothing is lost
        gated_pool.gated_attention_pool(a_raw, b, mask, wm)


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
