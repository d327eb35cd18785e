"""The StyleGAN steps on a data mesh (``parallel/mesh.data_mesh``) of two
gloo ranks on the CPU, against one process and against the JAX package's
data-parallel step on two devices of its CPU mesh, with the same weights,
batch and JAX draws (the ranks take their rows of the whole batch's
draws). Held: the losses to 1e-5, the parameters after one critic and one
generator step to 1e-5 x max(1, max|p|) wherever JAX's gradient is above
1e-6 (Adam's first step is the sign of the gradient there; below it the
sign of its rounding); the global minibatch stddev to 1e-6; the repaired
``all_reduce_sum`` differentiable twice (the gradient penalty needs it);
and the dry run of ``graft_entry`` and ``train.gan --mesh 2``.

``parallel.mesh.launch`` spawns each rank as a fresh interpreter that
imports its function from this module, so the module imports neither JAX
nor the JAX package at its top: the tests import them inside, and hand
the ranks numpy arrays."""

import copy

import numpy as np
import pytest
import torch

from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch import (
    graft_entry,
)
from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.models import (
    stylegan as sg,
)
from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.ops import (
    collectives,
)
from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.parallel import (
    mesh as TM,
)
from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.train import (
    gan,
)
from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.utils import (
    interop,
)

STEP, B = 1, 8


# ------------------------------------------------------ on the spawned ranks
def _tensors(tree):
    if isinstance(tree, np.ndarray):
        return torch.from_numpy(tree)
    if isinstance(tree, dict):
        return {k: _tensors(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tensors(v) for v in tree]
    return tree


def gan_steps(mesh, spec, gen_flat, disc_flat, real, zs, sel, d_draws,
              g_draws, grad_accum=1):
    """One d_step and one g_step on this rank of a data mesh (``mesh``
    None: one process), from JAX-layout weights; returns the critic, the
    generator and the EMA in the JAX layout, and the losses."""
    torch.set_num_threads(1)
    width, code, step = spec
    dm = None if mesh is None else TM.data_mesh(device="cpu")
    g = sg.StyledGenerator(code, width_mult=width)
    d = sg.Discriminator(width_mult=width)
    interop.load_gan_flat(g, gen_flat)
    interop.load_gan_flat(d, disc_flat)
    ema = copy.deepcopy(g).requires_grad_(False)
    g_opt, d_opt = gan.make_optimizers(g, d)
    aux = gan.make_d_step(step, grad_accum=grad_accum, mesh=dm)(
        g, d, d_opt, torch.from_numpy(real), torch.from_numpy(zs), sel, 0.7,
        1e-3, _tensors(d_draws))
    gl = gan.make_g_step(step, grad_accum=grad_accum, mesh=dm)(
        g, d, g_opt, ema, torch.from_numpy(zs), sel, 0.7, 1e-3,
        _tensors(g_draws))
    return {"disc": interop.gan_flat_from_module(d),
            "gen": interop.gan_flat_from_module(g),
            "ema": interop.gan_flat_from_module(ema),
            "disc_loss": float(aux["disc_loss"]),
            "grad_penalty": float(aux["grad_penalty"]), "g_loss": float(gl)}


def stddev(mesh, x):
    """This rank's rows of ``minibatch_stddev`` over the whole batch."""
    dm = TM.data_mesh(device="cpu")
    rows = torch.from_numpy(x)[dm.rows(x.shape[0])]
    return sg.minibatch_stddev(rows, group=dm.group).numpy()


def second_order(mesh, x):
    """f = sum(S**3) with S = all_reduce_sum(x) on every rank; returns this
    rank's first and second derivatives of the whole world's f (each
    rank differentiating its own copy)."""
    dm = TM.data_mesh(device="cpu")
    x = torch.from_numpy(x[dm.rank]).requires_grad_(True)
    s = collectives.all_reduce_sum(x, dm.group)
    g, = torch.autograd.grad((s ** 3).sum(), x, create_graph=True)
    h, = torch.autograd.grad(g.sum(), x)
    return g.detach().numpy(), h.numpy()


# ------------------------------------------------------------- the tests
def _tree_np(tree):
    if hasattr(tree, "numpy"):
        return tree.numpy()
    if isinstance(tree, dict):
        return {k: _tree_np(v) for k, v in tree.items()}
    return [_tree_np(v) for v in tree]


def _jax_dp_step(pg, pd, real, zs, sel, key_d, key_g, mesh):
    import jax
    import jax.numpy as jnp
    import test_torch_gan_train as H

    from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu.parallel import (
        mesh as JM,
    )
    from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu.train import (
        gan as jgan,
    )

    tx = jgan.make_optimizers()
    kw = dict(width_mult=H.W, from_rgb_activate=True, tx=tx)
    d_step = jgan.make_d_step(STEP, **kw)
    g_step = jgan.make_g_step(STEP, **kw)
    od, og, ema = tx.init(pd), tx.init(pg), pg
    r, z = jnp.asarray(real), jnp.asarray(zs)
    if mesh is not None:
        rep = JM.replicated(mesh)
        put = lambda t: jax.tree_util.tree_map(  # noqa: E731
            lambda x: jax.device_put(x, rep), t)
        pd, od, pg, og, ema = map(put, (pd, od, pg, og, ema))
        r = jax.device_put(r, JM.data_batch_sharding(mesh))
        z = jax.device_put(z, JM.style_batch_sharding(mesh))
    pd, od, aux = d_step(pd, od, pg, r, z, jnp.asarray(sel),
                         jnp.float32(0.7), jnp.float32(1e-3), key_d)
    pg, og, ema, gl = g_step(pg, og, ema, pd, z, jnp.asarray(sel),
                             jnp.float32(0.7), jnp.float32(1e-3), key_g)
    return ({"disc": pd, "gen": pg, "ema": ema},
            {"disc": H.determined(od.mu), "gen": H.determined(og.mu),
             "ema": H.determined(og.mu)},
            (float(aux["disc_loss"]), float(aux["grad_penalty"]), float(gl)))


def _gap(got: dict, want, where):
    from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu.train import (
        checkpoint as jck,
    )

    want = {k: np.asarray(v) for k, v in jck._flatten(want).items()}
    scale = max(1.0, max(float(np.abs(v).max()) for v in want.values()))
    return max(float(np.abs(got[k] - want[k])[where[k]].max(initial=0.0))
               for k in want) / scale


def test_two_rank_steps_match_one_rank_and_jax_data_parallel():
    import jax
    import test_torch_gan_train as H

    from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu.parallel import (
        mesh as JM,
    )
    from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu.train import (
        checkpoint as jck,
    )

    pg, pd, g, d = H.nets()
    rng = np.random.default_rng(0)
    real = rng.uniform(-1, 1, (B, 8, 8, 3)).astype(np.float32)
    zs = rng.standard_normal((2, B, H.D)).astype(np.float32)
    sel = [0] + [1] * 8
    key_d, key_g = jax.random.split(jax.random.PRNGKey(3))
    want, where, losses = _jax_dp_step(pg, pd, real, zs, sel, key_d, key_g,
                                       JM.data_mesh(2))
    single, _, single_losses = _jax_dp_step(pg, pd, real, zs, sel, key_d,
                                            key_g, None)
    args = ((H.W, H.D, STEP),
            {k: np.asarray(v) for k, v in jck._flatten(pg).items()},
            {k: np.asarray(v) for k, v in jck._flatten(pd).items()},
            real.transpose(0, 3, 1, 2).copy(), zs, sel,
            _tree_np(H.d_draws(key_d, d, B, STEP)),
            _tree_np(H.g_draws(key_g, d, B, STEP)))
    ranks = TM.launch(gan_steps, 2, args=args, devices=["cpu"] * 2)
    one = gan_steps(None, *args)
    for got in ranks + [one]:
        for i, name in enumerate(("disc_loss", "grad_penalty", "g_loss")):
            assert abs(got[name] - losses[i]) <= 1e-5 * max(1, abs(losses[i]))
            assert abs(got[name] - single_losses[i]) <= \
                1e-5 * max(1, abs(single_losses[i]))
        for part in ("disc", "gen", "ema"):
            assert _gap(got[part], want[part], where[part]) <= 1e-5, part
            assert _gap(got[part], single[part], where[part]) <= 1e-5, part
    for part in ("disc", "gen", "ema"):  # every rank steps alike
        for k, v in ranks[0][part].items():
            np.testing.assert_array_equal(v, ranks[1][part][k])


def test_minibatch_stddev_and_the_second_order_of_the_all_reduce():
    import jax.numpy as jnp

    from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu.models import (
        stylegan as jsg,
    )

    x = np.random.default_rng(1).standard_normal((6, 5, 4, 4)).astype(
        np.float32)
    parts = TM.launch(stddev, 2, args=(x,), devices=["cpu"] * 2)
    want = np.asarray(jsg.minibatch_stddev(jnp.asarray(
        x.transpose(0, 2, 3, 1)))).transpose(0, 3, 1, 2)
    np.testing.assert_allclose(np.concatenate(parts), want, rtol=0,
                               atol=1e-6)
    xs = np.random.default_rng(2).standard_normal((2, 7)).astype(np.float32)
    out = TM.launch(second_order, 2, args=(xs,), devices=["cpu"] * 2)
    s = xs.sum(axis=0)
    for g, h in out:  # the world's f is 2 sum(S^3): 6 S^2 and 24 S
        np.testing.assert_allclose(g, 6 * s ** 2, rtol=1e-5)
        np.testing.assert_allclose(h, 24 * s, rtol=1e-5)


def test_graft_entry_gan_dryrun_on_two_gloo_ranks():
    graft_entry.dryrun_multichip_gan(2)


def test_trainer_cli_mesh_two(tmp_path):
    """``train.gan --mesh 2`` on two gloo ranks (rank 0 writes) against the
    one-rank run: the same checkpoint keys and step counts."""
    from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.data import (
        gan_dataset,
    )
    from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.train import (
        checkpoint,
    )

    src = tmp_path / "src"
    src.mkdir()
    np.save(src / "t.npy", np.random.default_rng(0).integers(
        0, 255, (16, 16, 16, 3)).astype(np.uint8))
    gan_dataset._main(["--src", str(src), "--out", str(tmp_path / "s"),
                       "--max-size", "8"], device="cpu")
    common = ["--data_dir", str(tmp_path / "s"), "--init_size", "4",
              "--max_size", "8", "--step_every", "1", "--epochs", "2",
              "--code_size", "32", "--width_mult", "0.0625",
              "--batch_override", "4", "--max_batches", "2"]
    assert gan.main(common + ["--output_dir", str(tmp_path / "one")],
                    device="cpu") == 0
    assert gan.main(common + ["--output_dir", str(tmp_path / "two"),
                              "--mesh", "2"], device="cpu") == 0
    a = checkpoint.load_raw(str(tmp_path / "one" / "checkpoint"
                                / "train_step-1.model"))
    b = checkpoint.load_raw(str(tmp_path / "two" / "checkpoint"
                                / "train_step-1.model"))
    assert sorted(a) == sorted(b)
    assert int(b["d_optimizer/count"]) == 4
    with pytest.raises(RuntimeError, match="not divisible over --mesh 3"):
        gan.main(common + ["--output_dir", str(tmp_path / "x"), "--mesh",
                           "3"], device="cpu")
