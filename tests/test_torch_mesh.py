"""The port's mesh pieces that need no spawned rank, against the JAX
package: the axis rule of ``make_mesh``, a rank's bags and rows,
``bucket_for`` / ``pad_bag`` with ``multiple_of``, the pool's split entries
(their plain versions, split 2 and 3 ways, forward and backward) against
the one-call pool, and the sharded pool with no group. Then the port's
``graft_entry``: ``entry`` on the CPU and the dry run on 2 gloo ranks.

Tolerances: the pool 1e-6 (``M`` 1e-5), the ROADMAP's for the pool; the
gradients 1e-6 x max(1, max|g|). A split sums in another order than the
one-call pool, so nothing here is bit-exact except the bucket sizes."""

import numpy as np
import pytest
import torch

import conftest  # noqa: F401
import jax.numpy as jnp

from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu.data import (
    loader as jloader,
)
from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu.parallel import (
    mesh as JM,
)
from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch import (
    graft_entry,
)
from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.data import (
    loader as tloader,
)
from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.ops import (
    gated_pool as gp,
)
from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.parallel import (
    mesh as TM,
)


@pytest.mark.parametrize("n", [1, 2, 4, 6, 8])
def test_axis_rule_matches_jax(n):
    want = JM.make_mesh(n).shape
    s = TM.slide_axis(n)
    assert (s, n // s) == (want[JM.SLIDES_AXIS], want[JM.TILES_AXIS])
    assert TM.slide_axis(n, slides=1) == 1
    with pytest.raises(ValueError, match="does not divide"):
        TM.slide_axis(6, slides=4)


def _mesh(slides, tiles, rank):
    return TM.Mesh(shape={TM.SLIDES_AXIS: slides, TM.TILES_AXIS: tiles},
                   rank=rank, slide=rank // tiles, tile=rank % tiles,
                   device=torch.device("cpu"), backend="gloo",
                   tiles_group=None, slides_group=None)


def test_bags_and_rows_cover_the_window_once():
    for slides, tiles, n_bags in ((2, 2, 5), (1, 3, 4), (3, 1, 2)):
        meshes = [_mesh(slides, tiles, r) for r in range(slides * tiles)]
        owned = sorted(b for m in meshes if m.tile == 0 for b in m.bags(n_bags))
        assert owned == list(range(n_bags))
        rows = [m.rows(6 * tiles) for m in meshes if m.slide == 0]
        assert [r.start for r in rows] == [6 * t for t in range(tiles)]
        assert all(r.stop - r.start == 6 for r in rows)
    with pytest.raises(ValueError, match="zero-mask"):
        _mesh(1, 4, 0).rows(10)


def test_mesh_devices_and_backend(monkeypatch):
    assert TM.mesh_devices(3, "cpu") == [torch.device("cpu")] * 3
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert TM.mesh_devices(2) == [torch.device("cuda", 0),
                                  torch.device("cuda", 1)]
    with pytest.raises(ValueError, match="--mesh 3 but only 2 CUDA"):
        TM.mesh_devices(3)
    assert TM.backend_for(["cuda:0", "cuda:1"]) == "nccl"
    assert TM.backend_for(["cuda:0", "cuda:0"]) == "gloo"
    assert TM.backend_for(["cpu", "cpu"]) == "gloo"


@pytest.mark.parametrize("multiple", [1, 2, 3, 4, 6, 8])
def test_bucket_for_multiple_of_matches_jax(multiple):
    for n in (1, 17, 31, 32, 33, 100, 2047, 2560, 2561, 3000, 5000, 50001):
        assert tloader.bucket_for(n, multiple_of=multiple) == \
            jloader.bucket_for(n, multiple_of=multiple), (n, multiple)
    # the 6-way lcm case of tests/test_sharding.py: a ladder bucket rounds
    # up to the multiple, the granule above the top is lcm(1024, 6)
    assert tloader.bucket_for(17, multiple_of=6) == 36
    assert tloader.bucket_for(3000, multiple_of=6) == 3072
    assert tloader.bucket_for(100) == jloader.bucket_for(100) == 128


@pytest.mark.parametrize("t,multiple", [(17, 6), (5, 4), (40, 1)])
def test_pad_bag_multiple_of_matches_jax(t, multiple):
    x = np.random.default_rng(t).normal(size=(t, 3)).astype(np.float32)
    jt, jm = jloader.pad_bag(jnp.asarray(x), multiple_of=multiple)
    tt, tm = tloader.pad_bag(torch.from_numpy(x), multiple_of=multiple)
    assert tt.shape[0] % multiple == 0
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))


def _pool_inputs(t, k=3, o=2, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(t, k)).astype(np.float32)
    b = rng.normal(size=(t, o)).astype(np.float32)
    m = (rng.random(t) > 0.3).astype(np.float32)
    w = rng.normal(size=(k,)).astype(np.float32)
    return [torch.from_numpy(x) for x in (a, b, m, w)]


def _cuts(t, ways):
    edges = np.linspace(0, t, ways + 1).astype(int)
    return [slice(int(lo), int(hi)) for lo, hi in zip(edges, edges[1:])]


@pytest.mark.parametrize("ways", [2, 3])
@pytest.mark.parametrize("t", [7, 40])
def test_split_pool_forward_matches_one_call(t, ways):
    a, b, m, w = _pool_inputs(t, seed=t + ways)
    want = gp.gated_attention_pool_reference(a, b, m, w)
    cuts = _cuts(t, ways)
    totals = sum(gp.pool_forward_partials(a[c], b[c], m[c], w) for c in cuts)
    parts = [gp.pool_forward_finish(a[c], b[c], m[c], w, totals)
             for c in cuts]
    for p in parts:
        np.testing.assert_allclose(p[0].numpy(), want[0].numpy(), atol=1e-5)
    np.testing.assert_allclose(torch.cat([p[1] for p in parts], 1).numpy(),
                               want[1].numpy(), atol=1e-6)
    np.testing.assert_allclose(torch.cat([p[2] for p in parts], 1).numpy(),
                               want[2].numpy(), atol=1e-6)


@pytest.mark.parametrize("ways", [2, 3])
@pytest.mark.parametrize("only_dm", [False, True])
def test_split_pool_backward_matches_one_call(ways, only_dm):
    t = 31
    a, b, m, w = _pool_inputs(t, seed=ways)
    a1t = gp.gated_attention_pool_reference(a, b, m, w)[1]
    g = np.random.default_rng(9)
    dm = torch.from_numpy(g.normal(size=(3, 2)).astype(np.float32))
    da1t, dwr = (None, None) if only_dm else [
        torch.from_numpy(g.normal(size=(3, t)).astype(np.float32))
        for _ in range(2)]
    want = gp.gated_attention_pool_backward_reference(a, b, m, w, a1t, dm,
                                                      da1t, dwr)
    cuts = _cuts(t, ways)

    def cols(x, c):
        return None if x is None else x[:, c]

    parts = [gp.pool_backward_partials(a[c], b[c], m[c], w, a1t[:, c], dm,
                                       cols(da1t, c), cols(dwr, c))
             for c in cuts]
    totals = sum(p[0] for p in parts)
    fin = [gp.pool_backward_finish(a[c], b[c], m[c], w, totals, dm,
                                   cols(da1t, c), cols(dwr, c)) for c in cuts]
    got = (torch.cat([f[0] for f in fin]), torch.cat([p[1] for p in parts]),
           sum(f[1] for f in fin))
    for g_, w_ in zip(got, want):
        tol = 1e-6 * max(1.0, float(w_.abs().max()))
        np.testing.assert_allclose(g_.numpy(), w_.numpy(), atol=tol)


def test_sharded_pool_without_a_group_is_the_pool():
    """``group=None``: the same outputs and the same gradients as
    :func:`gated_attention_pool` (through autograd, with an unused
    output's cotangent absent)."""
    a, b, m, w = _pool_inputs(50, seed=4)
    outs = []
    for fn in (gp.gated_attention_pool, gp.sharded_gated_attention_pool):
        x = [t.clone().requires_grad_(t is not m) for t in (a, b, m, w)]
        mm, a1t, wr = fn(*x)
        loss = (mm ** 2).sum() + (wr * 0.5).sum()  # A1T feeds no loss
        grads = torch.autograd.grad(loss, [x[0], x[1], x[3]])
        outs.append([mm, a1t, wr, *grads])
    for got, want in zip(outs[1], outs[0]):
        tol = 1e-6 * max(1.0, float(want.detach().abs().max()))
        np.testing.assert_allclose(got.detach().numpy(),
                                   want.detach().numpy(), atol=tol)


def test_split_entries_count_only_card_launches():
    a, b, m, w = _pool_inputs(9)
    before = (gp.PARTIAL_LAUNCHES, gp.FINISH_LAUNCHES)
    gp.pool_forward_finish(a, b, m, w, gp.pool_forward_partials(a, b, m, w))
    assert (gp.PARTIAL_LAUNCHES, gp.FINISH_LAUNCHES) == before
    assert set(gp.ENTRIES) >= {"gated_pool_forward_partials",
                               "gated_pool_forward_finish",
                               "gated_pool_backward_partials",
                               "gated_pool_backward_finish"}


def test_graft_entry_forward_on_the_cpu():
    fn, args = graft_entry.entry(device="cpu")
    y_pred, loss, aterm = fn(*args)
    assert tuple(y_pred.shape) == (1, 3) and tuple(aterm.shape) == (3, 64)
    assert bool(torch.isfinite(loss))
    # the StyleGAN half of the dry run runs on gloo ranks
    # (tests/test_torch_gan_mesh.py)
    assert callable(graft_entry.dryrun_multichip_gan)


def test_graft_entry_dryrun_on_two_gloo_ranks():
    graft_entry.dryrun_multichip(2)


def test_a_failed_rank_raises_in_the_launcher():
    """A rank that raises stops the others at once (rank 0 would run for
    a minute), and its error re-raises in the launching process."""
    import time

    import torch_mesh_workers as W

    t0 = time.monotonic()
    with pytest.raises(Exception, match="rank 1 fails on purpose"):
        TM.launch(W.fail_on_rank, 2, devices=["cpu"] * 2, args=(1,))
    assert time.monotonic() - t0 < 45


@pytest.mark.parametrize("cap", [None, 20])
def test_deferred_train_bag_takes_the_rows_of_the_full_bag(tmp_path,
                                                           monkeypatch, cap):
    """A mesh rank's training bag (``get_train_data(deferred=True)``):
    the rows it transforms are the full bag's rows, with the same noise,
    with and without the tile cap's random choice."""
    from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.data import (
        roibuilder,
    )

    monkeypatch.setenv("CACHE_DIR", str(tmp_path))
    if cap is not None:
        monkeypatch.setattr(roibuilder, "TRAIN_TILE_CAP", cap)
    rng = np.random.default_rng(2)
    tiles = rng.integers(0, 256, (30, 32, 32, 3)).astype(np.uint8)
    np.save(tmp_path / "data_s_H&E_rois_size32_hsvcut_v3.npy", tiles)
    np.save(tmp_path / "coor_s_H&E_rois_size32_hsvcut_v3.npy",
            np.zeros((30, 2), np.int64))
    (tmp_path / "s_H&E.scn").write_bytes(b"fake")
    bags = []
    for deferred in (False, True):
        b = roibuilder.RoiBuilder(str(tmp_path / "s_H&E.scn"),
                                  {"roi_size": 32}, device="cpu")
        b.update_resolution_and_buffer(16)
        b.reseed_augment(3, 1)
        bags.append(b.get_train_data(deferred=deferred))
    full, lazy = bags
    assert isinstance(lazy, roibuilder.DeferredTrainBag)
    assert tuple(lazy.shape) == tuple(full.shape) == (cap or 30, 16, 16, 3)
    idx = torch.tensor([5, 0, 17, 3, 5])
    np.testing.assert_array_equal(lazy[idx].numpy(), full[idx].numpy())
