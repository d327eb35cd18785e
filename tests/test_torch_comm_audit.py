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

* every training bag sums over its tile group 13 times: the forward's
  count and sum for KLD, the batch-norm and Aterm_mu
  (``ops/nn.py:_tile_weights``, ``ops/nn.py:_group_mean``), the pool's
  ``[K, 1+O]`` (``ops/gated_pool.py:forward``), the column norms
  (``ops/nn.py:l2_normalize``) and the Gram matrix
  (``models/attention_mil.py:attention_pool``) of the decorrelation
  diagnostic ``Aterm_var``; the backward's two batch-norm cotangents
  (``ops/collectives.py:backward``) and the pool's ``[K, 2]``
  (``ops/gated_pool.py:backward``). XLA combines its own into the
  gradient's all-reduce. On a slides-only mesh the tile group is one rank
  and the 13 calls move nothing between ranks;
* the sharded pool, beyond JAX's four statistics (668 bytes at L = 80,
  K = 3, O = 1): Aterm_mu's count and sum, the column norms and the Gram
  matrix (the diagnostics ``Aterm_mu`` / ``Aterm_var``, which
  ``attention_pool`` computes on every path), and the all-gather of
  ``Aterm`` [K, T] (``parallel/shard_pool.py:pool``), which stands for
  the JAX function's sharded ``out_specs``;
* a streamed slide: nothing inside the chunk loop (JAX's extract program
  is collective-free too), then once a slide ``run_together``'s failure
  flags (``parallel/mesh.py:run_together``) and the features' all-gather
  (``parallel/inference.py:classify_slide_streaming``);
* the StyleGAN steps: one flat all-reduce of every gradient
  (``train/gan.py:_sync_grads``; the layers a step does not run add
  zeros, where XLA syncs only the live ones), one of the losses, and the
  minibatch stddev's mean and variance in every critic pass, with their
  cotangents (``models/stylegan.py:minibatch_stddev``,
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
    # rank 0's tile group is itself: its tables move nothing between ranks
    for site, ops in row["call_sites"].items():
        if site not in ("parallel/steps.py:_all_reduce_flat",
                        "parallel/steps.py:step"):
            assert ops["all_reduce"]["group_sizes"] == [1], site


def test_2d_window_syncs_one_tree_and_its_tile_tables(rows, jax_trees):
    row = _pinned(rows, "classifier_train_2d")
    assert row["mesh"] == "slides=2,tiles=2"
    assert row["parts"]["gradient"] == _ar(1, jax_trees["mil"])
    assert row["parts"]["rows"] == _ar(1, 200)
    # rank 0 runs 3 bags, 13 sums over its two tile ranks each
    assert row["parts"]["tile_tables"]["all_reduce"]["count"] == 39
    assert row["payload_bytes_total"] <= 1.1 * jax_trees["mil"]


def test_sharded_pool_moves_jax_statistics_plus_named_extras(rows):
    """JAX's four statistics exactly (count, mean, var, the pool's table),
    then the port's extras: Aterm_mu's count (4 B) and sum (12 B), the
    column norms (12 B) and the Gram matrix (36 B) of the diagnostics,
    and the Aterm [3, 128] all-gather (1536 B) for the sharded output."""
    row = _pinned(rows, "explicit_psum_pool")
    cfg = amil.MILConfig(**A.TEST_CFG)
    assert A.pool_statistics_bytes(cfg) == 668
    assert row["jax"]["collectives"] == {
        "all-reduce": {"count": 4, "payload_bytes": 668}}
    assert row["parts"]["statistics"] == _ar(4, 668)
    assert row["parts"]["diagnostics"] == {
        **_ar(4, 4 + 12 + 12 + 36),
        "all_gather": {"count": 1, "payload_bytes": 4 * 3 * 128}}


@pytest.mark.parametrize("workload,tree,stddev,loss", [
    # the critic: 3 passes x (mean, var) forward, 10 cotangents (the
    # gradient penalty's double backward among them); 2 loss terms
    ("gan_d_step_dp", 116772, (16, 16 * 1024), 8),
    # the generator: one critic pass forward and backward; 1 loss
    ("gan_g_step_dp", 9216652, (4, 4 * 1024), 4)])
def test_gan_step_syncs_its_gradient_in_one_all_reduce(
        rows, jax_trees, workload, tree, stddev, loss):
    row = _pinned(rows, workload)
    assert tree == jax_trees[workload]  # the JAX package's tree
    assert row["parts"]["gradient"] == _ar(1, tree)
    assert row["predicted_payload_bytes"] == tree  # the whole tree
    assert row["parts"]["minibatch_stddev"] == _ar(*stddev)
    assert row["parts"]["loss"] == _ar(1, loss)
    assert row["collectives"] == _ar(1 + stddev[0] + 1,
                                     tree + stddev[1] + loss)


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


@pytest.fixture()
def world_of_one(tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_recorder_payload_rules(world_of_one):
    real = {op: getattr(dist, op) for op in A.COLLECTIVES}
    x = torch.ones(100)
    with A.record_collectives() as recs:
        dist.all_reduce(x)
        dist.all_reduce(torch.ones((4, 4), dtype=torch.bfloat16))
        out = [torch.empty(8, dtype=torch.uint8)]
        dist.all_gather(out, torch.ones(8, dtype=torch.uint8))
        dist.broadcast(torch.ones(3, dtype=torch.float64), src=0)
        objs = [{"a": 1}, (2, 3)]
        dist.broadcast_object_list(objs, src=0)
        gathered = [None]
        dist.all_gather_object(gathered, ["x"])
        dist.barrier()
        collectives.all_reduce_(torch.ones(2), dist.group.WORLD)
        y = torch.ones(5, requires_grad=True)
        collectives.all_reduce_sum(y, dist.group.WORLD).sum().backward()
    # every entry point is restored, and nothing records outside
    assert all(getattr(dist, op) is f for op, f in real.items())
    dist.all_reduce(x)
    got = [(r["op"], r["payload_bytes"], r["dtype"], r["group_size"],
            r["call_site"]) for r in recs]
    import pickle
    assert got == [
        ("all_reduce", 400, "float32", 1, None),
        ("all_reduce", 32, "bfloat16", 1, None),
        ("all_gather", 8, "uint8", 1, None),  # the gathered output
        ("broadcast", 24, "float64", 1, None),
        ("broadcast_object_list", len(pickle.dumps({"a": 1}))
         + len(pickle.dumps((2, 3))), None, 1, None),
        ("all_gather_object", len(pickle.dumps(["x"])), None, 1, None),
        ("barrier", 0, None, 1, None),
        ("all_reduce", 8, "float32", 1, "ops/collectives.py:all_reduce_"),
        ("all_reduce", 20, "float32", 1, "ops/collectives.py:all_reduce_"),
        ("all_reduce", 20, "float32", 1, "ops/collectives.py:backward")]
    assert A.tally(recs)["all_reduce"] == {"count": 5,
                                           "payload_bytes": 480}
    np.testing.assert_array_equal(y.grad.numpy(), np.ones(5))
