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


_FWD_EDGES = sorted({e + d for e in gated_pool.FWD_EDGES for d in (-1, 0, 1)})


@pytest.mark.parametrize("t", sorted({1, 2047, 2048, 2049, 4097, 50000}
                                     | set(_FWD_EDGES)))
def test_pool_partition_covers_every_tile_once(t):
    """The forward's blocks cover [0, T) exactly once, in order, none
    empty; each is one launch the kernel takes: on path (i) a cluster size
    it launches (portable up to 8, or the non-portable 16), on path (ii) a
    cooperative grid of at most FWD_MAX_GRID blocks, one round of
    FWD_GRID_TILES tiles a thread up to FWD_MAX_GRID * FWD_GRID_TILES
    tiles; the path changes only at the last row of FWD_CLUSTERS."""
    path, blocks, tiles = gated_pool.pool_fwd_partition(t)
    covered = np.zeros(t, np.int64)
    ends = []
    for r in range(blocks):
        lo, hi = r * tiles, min(t, (r + 1) * tiles)
        assert lo < hi
        covered[lo:hi] += 1
        ends.append((lo, hi))
    assert np.all(covered == 1)
    assert ends == sorted(ends) and ends[-1][1] == t
    top = gated_pool.FWD_CLUSTERS[-1][0]
    assert path == ("cluster" if t <= top else "grid")
    if path == "cluster":
        assert blocks in (1, 2, 4, 8, 16)
        assert blocks == next(c for e, c in gated_pool.FWD_CLUSTERS
                              if t <= e)
    else:
        assert 1 < blocks <= gated_pool.FWD_MAX_GRID
        cap = gated_pool.FWD_MAX_GRID * gated_pool.FWD_GRID_TILES
        assert (tiles <= gated_pool.FWD_GRID_TILES) == (t <= cap)


def test_pool_partition_refuses_an_empty_bag():
    for t in (0, -3):
        with pytest.raises(ValueError):
            gated_pool.pool_fwd_partition(t)


def test_pool_fwd_partition_is_monotone():
    """As T grows the forward's blocks never shrink, path (ii) never gives
    way to path (i), and the cut changes its path, cluster size or rounds a
    thread exactly at FWD_EDGES (the crossovers chip_smoke.py checks)."""
    cap = gated_pool.FWD_MAX_GRID * gated_pool.FWD_GRID_TILES
    ts = sorted(set(range(1, 9000)) | set(range(cap - 600, cap + 600))
                | {50000})
    cuts = [gated_pool.pool_fwd_partition(t) for t in ts]
    assert all(a[1] <= b[1] for a, b in zip(cuts, cuts[1:]))
    paths = [c[0] for c in cuts]
    assert paths == sorted(paths)  # "cluster" < "grid"

    def kind(t):
        path, blocks, tiles = gated_pool.pool_fwd_partition(t)
        return (path, blocks if path == "cluster"
                else -(-tiles // gated_pool.FWD_GRID_TILES))

    edges = [t for t in ts if t + 1 in ts and kind(t) != kind(t + 1)]
    assert edges == list(gated_pool.FWD_EDGES)


@pytest.mark.parametrize("t,k,o", [(1, 3, 1), (64, 3, 1), (7, 5, 2)])
def test_custom_op_passes_opcheck(t, k, o):
    """The forward's ``torch.library`` op: its schema, its fake (shape)
    implementation against the CPU one, and its use under AOT dispatch
    with dynamic shapes; the CPU outputs are the plain version's, made
    contiguous."""
    args = [torch.from_numpy(x) for x in _inputs(t, k, o, seed=t)]
    torch.library.opcheck(gated_pool.gated_pool_forward, tuple(args))
    got = gated_pool.gated_pool_forward(*args)
    want = gated_pool.gated_attention_pool_reference(*args)
    for g, w in zip(got, want):
        assert g.is_contiguous()
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    namespace, name = gated_pool.OP.split("::")
    assert getattr(getattr(torch.ops, namespace), name).default is not None


@pytest.mark.parametrize("t", [1, 2, 33])
def test_exported_attention_pool_holds_the_op(t):
    """``torch.export`` of the head over a dynamic tile axis keeps the
    pool as one node of the op, and the program gives the eager outputs at
    other tile counts too (T = 1 included)."""
    from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.models import (
        attention_mil as tamil,
    )

    cfg = tamil.MILConfig(widths=(8, 8, 8, 8), blocks=(1, 1, 1, 1))
    model = tamil.init_attention_mil(torch.Generator().manual_seed(0), cfg,
                                     device="cpu")

    class Head(torch.nn.Module):
        def forward(self, h):
            return tamil.attention_pool(model, h, cfg)

    h = torch.randn(5, cfg.L, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        prog = torch.export.export(
            Head(), (h,), dynamic_shapes=({0: torch.export.Dim(
                "T", min=1, max=64)},))
    namespace, name = gated_pool.OP.split("::")
    targets = [str(n.target) for n in prog.graph.nodes
               if n.op == "call_function"]
    assert targets.count(f"{namespace}.{name}.default") == 1
    ht = torch.randn(t, cfg.L, generator=torch.Generator().manual_seed(t))
    with torch.no_grad():
        got = prog.module()(ht)
        want = tamil.attention_pool(model, ht, cfg)
    for key in want:
        torch.testing.assert_close(got[key], want[key], rtol=0, atol=0)


def test_training_backward_gets_absent_cotangents(monkeypatch):
    """Through the training forward (the op inside the autograd Function),
    the pool's backward still receives None for A1^T and wROIs, which only
    feed detached outputs, so the kernel skips them."""
    from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.models import (
        attention_mil as tamil,
    )

    seen = []
    real = gated_pool.gated_attention_pool_backward

    def spy(*args):
        seen.append([c is None for c in args[5:]])
        return real(*args)

    monkeypatch.setattr(gated_pool, "gated_attention_pool_backward", spy)
    cfg = tamil.MILConfig(widths=(8, 8, 8, 8), blocks=(1, 1, 1, 1))
    model = tamil.init_attention_mil(torch.Generator().manual_seed(0), cfg,
                                     device="cpu")
    tiles = torch.rand((20, 16, 16, 3),
                       generator=torch.Generator().manual_seed(2)) * 2 - 1
    outs = tamil.apply_attention_mil(
        model, tiles, 1, cfg, train=True,
        generator=torch.Generator().manual_seed(3))
    outs["loss"].backward()
    assert seen == [[False, True, True]]
    assert model.weight_mask.grad is not None


# ------------------------------------------- the backward's one-launch cut

_BWD_EDGES = sorted({top + d for top, _ in gated_pool.BWD_CLUSTERS
                     for d in (-1, 0, 1)})


@pytest.mark.parametrize("t", sorted({1, 40, 250, 500, 512, 50000}
                                     | set(_BWD_EDGES)))
def test_pool_bwd_partition_covers_every_tile_once(t):
    """The backward's cluster of C blocks covers [0, T) exactly once, in
    order, with no block empty; C is a cluster size the kernel launches
    (portable up to 8, or the non-portable 16); a bag the training path
    pools (up to 512 tiles) is one block."""
    c, tiles = gated_pool.pool_bwd_partition(t)
    assert c in (1, 2, 4, 8, 16)
    assert c <= gated_pool.BWD_MAX_CLUSTER
    covered = np.zeros(t, np.int64)
    ends = []
    for r in range(c):
        lo, hi = r * tiles, min(t, (r + 1) * tiles)
        assert lo < hi
        covered[lo:hi] += 1
        ends.append((lo, hi))
    assert np.all(covered == 1)
    assert ends == sorted(ends) and ends[-1][1] == t
    if t <= 512:
        assert c == 1


def test_pool_bwd_partition_keeps_every_training_bag_on_one_block():
    """Every T up to 512 tiles (the 20 % subsample of a 2500-tile bag is
    500) takes one block, and C never shrinks as T grows."""
    cs = [gated_pool.pool_bwd_partition(t)[0] for t in range(1, 8193)]
    assert set(cs[:512]) == {1}
    assert all(a <= b for a, b in zip(cs, cs[1:]))


@pytest.mark.parametrize("t", [0, -3])
def test_pool_bwd_partition_refuses_an_empty_bag(t):
    with pytest.raises(ValueError):
        gated_pool.pool_bwd_partition(t)


def _c_entries():
    """``{name: (pointers, ints)}`` of the ``extern "C"`` entries of
    csrc/gated_pool.cu; the trailing ``void* stream`` is not a pointer
    argument of ENTRIES."""
    import os
    import re

    src = open(os.path.join(_build.CSRC, "gated_pool.cu")).read()
    out = {}
    for name, args in re.findall(r'extern "C" int (\w+)\(([^)]*)\)', src):
        params = [p.strip() for p in args.split(",")]
        assert params[-1] == "void* stream"
        params = params[:-1]
        n_int = sum(p.startswith("int ") for p in params)
        n_ptr = sum("void*" in p for p in params)
        assert n_int + n_ptr == len(params)
        assert all("void*" in p for p in params[:n_ptr])
        out[name] = (n_ptr, n_int)
    return out


def test_entries_match_the_c_signatures():
    """ENTRIES' pointer and int counts (what ctypes passes before the
    stream) equal the C source's signatures, entry by entry: five ints
    (T, K, O, tiles, blocks), and the forward's one-call and partials
    entries the path as a sixth."""
    c = _c_entries()
    assert set(c) == set(gated_pool.ENTRIES)
    for name, counts in gated_pool.ENTRIES.items():
        assert c[name] == counts, name
        assert counts[1] == (6 if name in ("gated_pool_forward",
                                           "gated_pool_forward_partials")
                             else 5), name


_CALLS = {
    "gated_pool_backward": "_launch_backward",
    "gated_pool_backward_partials": "_launch_backward_partials",
    "gated_pool_backward_finish": "_launch_backward_finish",
}


@pytest.mark.parametrize("t", [40, 500, 1025, 50000])
@pytest.mark.parametrize("only_dm", [True, False])
@pytest.mark.parametrize("entry", sorted(_CALLS))
def test_backward_launch_is_one_call_with_no_scratch(entry, only_dm, t,
                                                     monkeypatch):
    """The host side of each backward entry, with ``_call`` recorded in
    place of the library (CPU tensors, no card): one call of its entry,
    its ENTRIES pointers and the five ints with no scratch pointer among
    them, the partition ints from pool_bwd_partition, a null pointer
    exactly for each absent cotangent, the entry's counter up by one."""
    k, o = 3, 1
    a_raw, b, mask, wm = (torch.from_numpy(x) for x in _inputs(t, k, o))
    a1t = torch.rand((k, t))
    totals = torch.rand((k, 2))
    cots = [_torch(c) for c in _cotangents(t, k, o, 7, only_dm)]
    calls = []
    monkeypatch.setattr(gated_pool, "_call",
                        lambda name, *args, device: calls.append(
                            (name, args, device)))
    counter = {"gated_pool_backward": "BWD_LAUNCHES",
               "gated_pool_backward_partials": "BWD_PARTIAL_LAUNCHES",
               "gated_pool_backward_finish": "BWD_FINISH_LAUNCHES"}[entry]
    before = getattr(gated_pool, counter)
    launch = getattr(gated_pool, _CALLS[entry])
    if entry == "gated_pool_backward_finish":
        outs = launch(a_raw, b, mask, wm, totals, *cots)
        inputs = [a_raw, b, mask, wm, cots[0], cots[1], cots[2], totals]
        shapes = [a_raw.shape, wm.shape]
    else:
        outs = launch(a_raw, b, mask, wm, a1t, *cots)
        inputs = [a_raw, b, mask, wm, a1t, *cots]
        shapes = ([a_raw.shape, b.shape, wm.shape]
                  if entry == "gated_pool_backward"
                  else [b.shape, (k, 2)])
    assert getattr(gated_pool, counter) == before + 1
    assert len(calls) == 1
    name, args, device = calls[0]
    assert name == entry and device == a_raw.device
    n_ptr, n_int = gated_pool.ENTRIES[entry]
    assert n_int == 5 and len(args) == n_ptr + n_int
    ptrs, ints = args[:n_ptr], args[n_ptr:]
    assert ints == (t, k, o, *reversed(gated_pool.pool_bwd_partition(t)))
    n_in = len(inputs)
    assert list(ptrs[:n_in]) == [None if x is None else x.data_ptr()
                                 for x in inputs]
    # the rest are the outputs, in the C signature's order (the partials'
    # dB before its table), none of them scratch
    in_c_order = outs[::-1] if entry == "gated_pool_backward_partials" else outs
    assert list(ptrs[n_in:]) == [x.data_ptr() for x in in_c_order]
    assert [tuple(x.shape) for x in in_c_order] == [tuple(s) for s in shapes]


def test_split_backward_on_the_cpu_takes_the_plain_version(monkeypatch):
    """A CPU tensor never reaches a launch: the split backward's wrappers
    take their plain versions and call no entry."""
    monkeypatch.setattr(gated_pool, "_call", None)  # a call would raise
    args = [torch.from_numpy(x) for x in _inputs(20, 3, 1)]
    a1t = gated_pool.gated_attention_pool(*args)[1]
    dm = torch.ones((3, 1))
    stats, db = gated_pool.pool_backward_partials(*args, a1t, dm)
    want = gated_pool.pool_backward_partials_reference(*args, a1t, dm)
    torch.testing.assert_close(stats, want[0], rtol=0, atol=0)
    torch.testing.assert_close(db, want[1], rtol=0, atol=0)
    got = gated_pool.pool_backward_finish(*args, stats, dm)
    want = gated_pool.pool_backward_finish_reference(*args, stats, dm)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


# --------------------------------------- the forward's one launch an entry

_FWD_CALLS = {
    "gated_pool_forward": ("_launch", "LAUNCHES"),
    "gated_pool_forward_partials": ("_launch_partials", "PARTIAL_LAUNCHES"),
    "gated_pool_forward_finish": ("_launch_finish", "FINISH_LAUNCHES"),
}


@pytest.mark.parametrize("t,k,o", [(40, 3, 1), (2000, 3, 1), (2049, 3, 1),
                                   (50000, 3, 1), (7, 5, 2), (9000, 3, 9)])
@pytest.mark.parametrize("entry", sorted(_FWD_CALLS))
def test_forward_launch_is_one_call(entry, t, k, o, monkeypatch):
    """The host side of each forward entry, with ``_call`` recorded in
    place of the library (CPU tensors, no card): one call of its entry,
    its ENTRIES pointers then its ints (the one-call and partials entries:
    T, K, O and pool_fwd_partition's tiles, blocks and path; the finish: T,
    K, O, one tile a thread of FWD_FINISH_TILES-thread blocks), the rows
    scratch [blocks, K, 1+O] exactly on path (ii) and a null pointer on
    path (i), no scratch for the finish, the entry's counter up by one."""
    a_raw, b, mask, wm = (torch.from_numpy(x) for x in _inputs(t, k, o))
    totals = torch.rand((k, 1 + o))
    calls, made = [], []
    monkeypatch.setattr(gated_pool, "_call",
                        lambda name, *args, device: calls.append(
                            (name, args, device)))
    real_empty = gated_pool._empty

    def empty(device, *shape):
        made.append(real_empty(device, *shape))
        return made[-1]

    monkeypatch.setattr(gated_pool, "_empty", empty)
    launch, counter = _FWD_CALLS[entry]
    before = getattr(gated_pool, counter)
    if entry == "gated_pool_forward_finish":
        outs = getattr(gated_pool, launch)(a_raw, b, mask, wm, totals)
        inputs = [a_raw, b, mask, wm, totals]
    else:
        outs = getattr(gated_pool, launch)(a_raw, b, mask, wm)
        inputs = [a_raw, b, mask, wm]
    outs = outs if isinstance(outs, tuple) else (outs,)
    assert getattr(gated_pool, counter) == before + 1
    assert len(calls) == 1
    name, args, device = calls[0]
    assert name == entry and device == a_raw.device
    n_ptr, n_int = gated_pool.ENTRIES[entry]
    assert len(args) == n_ptr + n_int
    ptrs, ints = args[:n_ptr], args[n_ptr:]
    assert list(ptrs[:len(inputs)]) == [x.data_ptr() for x in inputs]
    out_ptrs = list(ptrs[len(inputs):])
    assert out_ptrs[:len(outs)] == [x.data_ptr() for x in outs]
    want = ([(k, o), (k, t), (k, t)] if entry != "gated_pool_forward_partials"
            else [(k, 1 + o)])
    assert [tuple(x.shape) for x in outs] == want
    if entry == "gated_pool_forward_finish":
        tiles = gated_pool.FWD_FINISH_TILES
        assert ints == (t, k, o, tiles, -(-t // tiles))
        assert len(out_ptrs) == len(outs)  # no scratch
        return
    path, blocks, tiles = gated_pool.pool_fwd_partition(t)
    assert ints == (t, k, o, tiles, blocks, int(path == "grid"))
    (rows,) = out_ptrs[len(outs):]
    scratch = [x for x in made if all(x is not y for y in outs)]
    if path == "cluster":
        assert rows is None and not scratch
    else:
        assert [tuple(x.shape) for x in scratch] == [(blocks, k, 1 + o)]
        assert rows == scratch[0].data_ptr()


def test_split_forward_on_the_cpu_takes_the_plain_version(monkeypatch):
    """A CPU tensor never reaches a launch: the split forward's wrappers
    take their plain versions and call no entry, and one shard gives the
    one-call plain outputs."""
    monkeypatch.setattr(gated_pool, "_call", None)  # a call would raise
    args = [torch.from_numpy(x) for x in _inputs(20, 3, 1)]
    before = (gated_pool.PARTIAL_LAUNCHES, gated_pool.FINISH_LAUNCHES)
    totals = gated_pool.pool_forward_partials(*args)
    torch.testing.assert_close(
        totals, gated_pool.pool_forward_partials_reference(*args),
        rtol=0, atol=0)
    got = gated_pool.pool_forward_finish(*args, totals)
    want = gated_pool.pool_forward_finish_reference(*args, totals)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    _check([x.numpy() for x in got],
           gated_pool.gated_attention_pool_reference(*args))
    assert (gated_pool.PARTIAL_LAUNCHES, gated_pool.FINISH_LAUNCHES) == before
