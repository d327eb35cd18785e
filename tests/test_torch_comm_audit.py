"""The collectives of the port's mesh programs, counted and pinned.

The twin of ``tests/test_comm_audit.py``. There XLA places the
collectives and the test reads them off the compiled HLO; the port issues
each one by hand, so ``tools/torch_comm_audit.py`` records them as they
run (``record_collectives`` wraps ``torch.distributed``'s entry points)
and this file pins what it records on four gloo CPU ranks, at the JAX
test's widths (``MILConfig(widths=(8, 8, 8, 8), blocks=(1, 1, 1, 1))``;
a 1/32-width StyleGAN at 8 px), in one launch for the module. A refactor
that adds a collective to a bag's path, or moves more bytes, fails here.

What is JAX's is held to JAX: each gradient all-reduce moves the JAX
package's parameter tree, counted by the JAX tool's ``_tree_bytes`` from
the JAX inits at the same widths, and at full width each tree is the
prediction of the committed JAX row; the pool's statistics are the JAX
row's four all-reduces. The rest is pinned to the code as it stands, in
one place, ``tools/torch_comm_audit.expected_rows``, which the card's run
is held to as well.

Against the JAX tool's rows
(``SCALING_MEASURED.json``) the port moves these extras, each named by the
port function that issues it (``file:function`` under the package):

* every training bag sums over a tile group of more than one rank 8
  times: in the forward the bag's count (``ops/nn.py:tile_count``), the
  batch-norm's mean and variance (``ops/nn.py:_group_mean``), the pool's
  ``[K, 1+O]`` (``ops/gated_pool.py:forward``) and one detached sum of
  the metrics' partials, ``4 (1 + 2K + K^2)`` bytes
  (``models/attention_mil.py:_group_diagnostics``: KLD, Aterm_mu, the
  column norms and the Gram matrix of ``Aterm_var``); in the backward the
  two batch-norm cotangents (``ops/collectives.py:backward``) and the
  pool's ``[K, 2]`` (``ops/gated_pool.py:backward``). Seven of them feed
  the loss; XLA combines its own into the gradient's all-reduce. A tile
  group of one rank (a slides-only mesh, a world of one) issues none;
* the sharded pool issues JAX's four statistics (668 bytes at L = 80,
  K = 3, O = 1) and the all-gather of ``Aterm`` [K, T]
  (``parallel/shard_pool.py:pool``), which stands for the JAX function's
  sharded ``out_specs``;
* a streamed slide: nothing inside the chunk loop (JAX's extract program
  is collective-free too), then once a slide ``run_together``'s failure
  flags (``parallel/mesh.py:run_together``) and the features' all-gather
  (``parallel/inference.py:classify_slide_streaming``);
* the StyleGAN steps: one flat all-reduce of the gradients of the layers
  the step runs (``train/gan.py:_sync_grads``; the live set follows from
  the step and alpha, as XLA syncs only the live layers), one of the
  losses, and the minibatch stddev's mean and variance in every critic
  pass, with their cotangents (``models/stylegan.py:minibatch_stddev``,
  ``ops/collectives.py:backward``).
"""

import json

import numpy as np
import pytest
import torch
import torch.distributed as dist

from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.models import (
    attention_mil as amil,
)
from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.models import (
    stylegan as sg,
)
from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.ops import (
    collectives,
)
from tools import torch_comm_audit as A

N = 4


@pytest.fixture(scope="module")
def rows():
    return {r["workload"]: r for r in A.run_audit(N, full_width=False)}


@pytest.fixture(scope="module")
def jax_trees():
    """The JAX package's f32 parameter trees at the test widths, in bytes,
    as the JAX tool counts them (``tools.comm_audit._tree_bytes``), from
    the shapes of its own inits."""
    import jax

    from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu.models import (  # noqa: E501
        attention_mil as jamil,
    )
    from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu.models import (  # noqa: E501
        stylegan as jsg,
    )
    from tools.comm_audit import _tree_bytes

    key = jax.random.PRNGKey(0)
    width = A.gan_width(False)
    return {name: _tree_bytes(jax.eval_shape(init)) for name, init in (
        ("mil", lambda: jamil.init_attention_mil(
            key, jamil.MILConfig(**A.TEST_CFG))),
        ("gan_d_step_dp", lambda: jsg.init_discriminator(
            key, width_mult=width)),
        ("gan_g_step_dp", lambda: jsg.init_styled_generator(
            key, style_dim=A.GAN_CODE, width_mult=width)))}


def _ar(count, nbytes):
    return {"all_reduce": {"count": count, "payload_bytes": nbytes}}


def _pinned(rows, workload):
    """The family's collectives, call sites and parts: exactly the counts
    and bytes of the code as it stands (``expected_rows``)."""
    row = rows[workload]
    assert A.pins_mismatch([row], A.expected_rows(N, full_width=False)) == []
    return row


def test_streaming_extract_is_collective_free(rows):
    row = _pinned(rows, "streaming_extract")
    assert row["parts"]["chunk_loop"] == {}, (
        "the per-tile extract path must stay free of collectives")
    # once a slide: run_together's flags and the features' all-gather
    assert set(row["call_sites"]) == {
        "parallel/mesh.py:run_together",
        "parallel/inference.py:classify_slide_streaming"}
    assert row["jax"]["payload_bytes_total"] == 0


def test_dp_window_syncs_one_param_tree(rows, jax_trees):
    row = _pinned(rows, "classifier_train_dp")
    tree = jax_trees["mil"]
    model = amil.AttentionMIL(amil.MILConfig(**A.TEST_CFG), device="meta")
    assert A.tree_bytes(model) == tree
    # one all-reduce of JAX's tree, over the whole world
    assert row["parts"]["gradient"] == _ar(1, tree)
    assert row["call_sites"]["parallel/steps.py:_all_reduce_flat"] == {
        "all_reduce": {"count": 1, "payload_bytes": tree,
                       "group_sizes": [N]}}
    assert row["parts"]["rows"] == _ar(1, 5 * (6 + 3 + 1) * 4)
    # the JAX test's bound, each extra named: the tree, then at most 10 %
    assert tree <= row["payload_bytes_total"] <= 1.1 * tree
    # rank 0's tile group is itself: it issues no tile-group sum
    assert row["parts"]["tile_tables"] == {}


def test_2d_window_syncs_one_tree_and_its_tile_tables(rows, jax_trees):
    row = _pinned(rows, "classifier_train_2d")
    assert row["mesh"] == "slides=2,tiles=2"
    assert row["parts"]["gradient"] == _ar(1, jax_trees["mil"])
    assert row["parts"]["rows"] == _ar(1, 200)
    # rank 0 runs 3 bags, 8 sums over its two tile ranks each: 7 that
    # feed the loss and 1 of the metrics' partials, 4 (1 + 2K + K^2) B
    assert row["parts"]["tile_tables"]["all_reduce"]["count"] == 24
    cfg = amil.MILConfig(**A.TEST_CFG)
    assert A.metric_sums_bytes(cfg) == 64
    assert row["call_sites"]["models/attention_mil.py:_group_diagnostics"] \
        == {"all_reduce": {"count": 3, "payload_bytes": 3 * 64,
                           "group_sizes": [2]}}
    assert row["payload_bytes_total"] <= 1.1 * jax_trees["mil"]


def test_slides_only_mesh_makes_no_tile_group_collective(rows):
    """On a slides-only mesh every collective of the window step spans the
    world (the gradient and the metric rows); the pins of such a mesh
    hold no tile-group site at any size, and a world of one holds none at
    all."""
    row = rows["classifier_train_dp"]
    assert row["mesh"] == f"slides={N},tiles=1"
    assert all(v["group_sizes"] == [N] for ops in row["call_sites"].values()
               for v in ops.values())
    cfg = amil.MILConfig(**A.TEST_CFG)
    for n in (2, 4, 8):
        want = A.expected_window(n, n, cfg)
        assert want["parts"]["tile_tables"] == {}
        assert set(want["call_sites"]) == {
            "parallel/steps.py:_all_reduce_flat", "parallel/steps.py:step"}
    assert A.expected_window(1, 1, cfg)["collectives"] == {}


def test_sharded_pool_moves_jax_statistics_plus_named_extras(rows):
    """JAX's four statistics exactly (count, mean, var, the pool's table)
    and no metric, then the port's one extra: the Aterm [3, 128]
    all-gather (1536 B) for the sharded output."""
    row = _pinned(rows, "explicit_psum_pool")
    cfg = amil.MILConfig(**A.TEST_CFG)
    assert A.pool_statistics_bytes(cfg) == 668
    assert row["jax"]["collectives"] == {
        "all-reduce": {"count": 4, "payload_bytes": 668}}
    assert row["parts"]["statistics"] == _ar(4, 668)
    gather = {"all_gather": {"count": 1, "payload_bytes": 4 * 3 * 128}}
    assert row["parts"]["aterm_gather"] == gather
    assert row["collectives"] == {**_ar(4, 668), **gather}


@pytest.mark.parametrize("workload,tree,live,stddev,loss", [
    # the critic: 3 passes x (mean, var) forward, 10 cotangents (the
    # gradient penalty's double backward among them); 2 loss terms
    ("gan_d_step_dp", 116772, 45188, (16, 16 * 1024), 8),
    # the generator: one critic pass forward and backward; 1 loss
    ("gan_g_step_dp", 9216652, 8696972, (4, 4 * 1024), 4)])
def test_gan_step_syncs_its_gradient_in_one_all_reduce(
        rows, jax_trees, workload, tree, live, stddev, loss):
    """One all-reduce of the live layers' gradients (the step at 8 px,
    alpha 1), the prediction being the JAX package's whole tree."""
    row = _pinned(rows, workload)
    assert tree == jax_trees[workload]  # the JAX package's tree
    assert A.gan_live_bytes(A.gan_width(False))[workload] == live
    assert row["parts"]["gradient"] == _ar(1, live)
    assert row["predicted_payload_bytes"] == tree  # the whole tree
    assert row["parts"]["minibatch_stddev"] == _ar(*stddev)
    assert row["parts"]["loss"] == _ar(1, loss)
    assert row["collectives"] == _ar(1 + stddev[0] + 1,
                                     live + stddev[1] + loss)


def test_pins_are_the_tools_expected_rows(rows):
    """The table the card's run is held to (``expected_rows``, any world
    size) gives this run's table exactly."""
    assert A.pins_mismatch(list(rows.values()),
                           A.expected_rows(N, full_width=False)) == []


def test_rows_carry_the_jax_rows(rows):
    with open(A.SCALING_MEASURED) as f:
        committed = json.load(f)["workloads"]
    assert list(rows) == [r["workload"] for r in committed]
    for row, jax_row in zip(rows.values(), committed):
        assert row["jax"] == jax_row
        assert set(row) >= {"workload", "mesh", "collectives",
                            "payload_bytes_total", "predicted_payload_bytes",
                            "measured_over_predicted", "note", "call_sites",
                            "jax"}


def test_predictions_are_jax_predictions_at_the_same_widths(rows,
                                                            jax_trees):
    """Each row's prediction is the JAX tool's at the test widths: the
    JAX package's parameter tree for a training step, the pool's
    statistics, zero for the extract."""
    want = {"classifier_train_dp": jax_trees["mil"],
            "classifier_train_2d": jax_trees["mil"],
            "streaming_extract": 0, "explicit_psum_pool": 668,
            "gan_d_step_dp": jax_trees["gan_d_step_dp"],
            "gan_g_step_dp": jax_trees["gan_g_step_dp"]}
    assert {w: r["predicted_payload_bytes"] for w, r in rows.items()} == want


def _full_mil():
    return A.tree_bytes(amil.AttentionMIL(amil.MILConfig(), device="meta"))


@pytest.mark.parametrize("workload,port_bytes", [
    ("classifier_train_dp", _full_mil),
    ("classifier_train_2d", _full_mil),
    ("explicit_psum_pool", lambda: A.pool_statistics_bytes(amil.MILConfig())),
    ("gan_d_step_dp", lambda: A.tree_bytes(sg.Discriminator(
        0.25, device="meta"))),
    ("gan_g_step_dp", lambda: A.tree_bytes(sg.StyledGenerator(
        A.GAN_CODE, 8, 0.25, device="meta")))],
    ids=["classifier_train_dp", "classifier_train_2d", "explicit_psum_pool",
         "gan_d_step_dp", "gan_g_step_dp"])
def test_full_width_prediction_is_the_jax_rows(workload, port_bytes):
    """At full width the port's tree, which its gradient all-reduce
    moves whole, and the pool's statistics are the JAX tool's committed
    prediction for the row."""
    assert port_bytes() == A.jax_rows()[workload]["predicted_payload_bytes"]


@pytest.mark.parametrize("workload,live,tree", [
    ("gan_d_step_dp", 2827268, 6899460),
    ("gan_g_step_dp", 12289036, 18630012)])
def test_full_width_gan_gradient_is_the_live_tree(workload, live, tree):
    """At full width (0.25, 8 px) the gradient all-reduce moves the live
    layers' bytes of the tree the JAX row predicts: the generator's
    0.66 of it, as XLA's step syncs (the JAX row's 12,315,168 B hold its
    stddev and loss sums too)."""
    assert A.gan_live_bytes(0.25)[workload] == live
    jax_row = A.jax_rows()[workload]
    assert jax_row["predicted_payload_bytes"] == tree
    if workload == "gan_g_step_dp":
        assert live <= jax_row["payload_bytes_total"]
        assert round(live / tree, 2) == round(
            jax_row["measured_over_predicted"], 2)


def test_recorder_payload_rules():
    """The recorder on two gloo ranks: each entry point's payload rule,
    the group size, the call site of the port's wrappers (a
    differentiable sum's backward is a site of its own), the entry points
    restored, and nothing recorded outside."""
    import pickle

    from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.parallel import (
        mesh as TM,
    )

    import torch_mesh_workers as W

    out = TM.launch(W.recorder_rules, 2, devices=["cpu"] * 2)
    objects = len(pickle.dumps({"a": 1})) + len(pickle.dumps((2, 3)))
    # a call from outside the port is sited at the first port frame below
    # it: the launcher's rank function
    rank_main = "parallel/mesh.py:_rank_main"
    for rank in out:
        assert rank["restored"]
        assert rank["records"] == [
            ("all_reduce", 400, "float32", 2, rank_main),
            ("all_reduce", 32, "bfloat16", 2, rank_main),
            ("all_gather", 16, "uint8", 2, rank_main),  # the gathered output
            ("broadcast", 24, "float64", 2, rank_main),
            ("broadcast_object_list", objects, None, 2, rank_main),
            ("all_gather_object", 2 * len(pickle.dumps(["x"])), None, 2,
             rank_main),
            ("barrier", 0, None, 2, rank_main),
            # the wrappers of ops/collectives.py pass the site through,
            # but for the differentiable sum's backward
            ("all_reduce", 8, "float32", 2, rank_main),
            ("all_reduce", 20, "float32", 2, rank_main),
            ("all_reduce", 20, "float32", 2, "ops/collectives.py:backward"),
            ("all_gather", 48, "float32", 2, rank_main)]
        assert rank["all_reduce"] == {"count": 5, "payload_bytes": 480}
        assert rank["objs"] == [{"a": 1}, (2, 3)]
        np.testing.assert_array_equal(rank["grad"], np.full(5, 2.0))
        np.testing.assert_array_equal(
            rank["rows"], np.repeat([[0.0], [1.0]], 3 * 2).reshape(4, 3))


@pytest.fixture()
def world_of_one(tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_a_world_of_one_issues_nothing(world_of_one):
    """On a world of one the port's sums and gathers are their inputs and
    issue nothing, a whole window step included (the pins of a world of
    one: ``expected_window(1, 1)``, no collective)."""
    from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.parallel import (
        mesh as TM,
        steps,
    )

    mesh = TM.make_mesh(1, devices=["cpu"])
    cfg = amil.MILConfig(**A.TEST_CFG)
    model = amil.init_attention_mil(torch.Generator().manual_seed(0), cfg,
                                    device="cpu")
    opt = steps.make_optimizer(model)
    tiles, masks, labels, gens = A._window(cfg, "cpu", 10)
    x = torch.arange(6.0).reshape(2, 3)
    with A.record_collectives() as recs:
        assert collectives.all_reduce_(x.clone(), dist.group.WORLD).equal(x)
        assert collectives.all_reduce_sum(x, dist.group.WORLD) is x
        assert collectives.all_gather_cat(x, mesh.tiles_group, dim=1) is x
        assert TM.run_together(lambda: 3, mesh, what="nothing") == 3
        metrics = steps.make_train_step(cfg, mesh=mesh)(
            model, opt, tiles[:2], masks[:2], labels[:2], 1e-3,
            generators=gens[:2])
    assert recs == []
    assert A.expected_window(1, 1, cfg, bags=2)["call_sites"] == {}
    assert np.isfinite(float(metrics["loss"]))
