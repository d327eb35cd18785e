"""The port's WGAN-GP StyleGAN trainer (``train/gan.py``) against the JAX
package's on the CPU: the same weights, the same inputs and the JAX
package's own random draws (rebuilt by the helpers below).

Tolerances: the critic and generator losses and their gradients (the
gradient penalty's double backward included) to 2e-5 x max(1, max|g|);
one Adam step with the EMA, also with ``--grad_accum 2``, to 1e-6 x
max(1, max|p|) on every parameter element whose gradient is above 1e-6
(Adam's first step is lr x g / (|g| + 1e-8): the sign of a larger
gradient, but for a gradient that is zero up to rounding the sign of the
rounding; those elements, under 1 % of each network, are counted, and
the Adam moments are held everywhere); ``--remat`` against the plain
steps to 1e-6 after two steps. The
5-part checkpoints cross between the packages bit for bit; a resumed run
replays the straight run bit for bit; the sample grid's PNG decodes to
the JAX package's pixels."""

import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import conftest  # noqa: F401
from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu.models import (
    stylegan as jsg,
)
from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu.train import (
    checkpoint as jck,
)
from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu.train import (
    gan as jgan,
)
from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch import (
    train as train_pkg,
)
from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.data import (
    gan_dataset,
)
from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.train import (
    checkpoint,
    gan,
)
from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.models import (
    stylegan as sg,
)
from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.utils import (
    interop,
)

# ------------------------------------------------------------------ helpers
# The JAX package's random draws of one critic or generator step, rebuilt
# from its own keys and handed to the port's losses in the port's layouts,
# and the two packages' networks with the same weights (also used by
# tests/test_torch_gan_mesh.py and tests/test_torch_gan_interop.py).
W, D = 1 / 16, 32


def t(x):
    return torch.from_numpy(np.array(x))


def nets(width=W, code=D, seed=0):
    """(JAX generator params, JAX critic params, port generator, port
    critic), the port's holding the JAX weights."""
    pg = jsg.init_styled_generator(jax.random.PRNGKey(seed), style_dim=code,
                                   width_mult=width)
    pd = jsg.init_discriminator(jax.random.PRNGKey(seed + 1),
                                width_mult=width)
    g = sg.init_styled_generator(torch.Generator().manual_seed(0),
                                 style_dim=code, width_mult=width,
                                 device="cpu")
    d = sg.init_discriminator(torch.Generator().manual_seed(0),
                              width_mult=width, device="cpu")
    interop.load_gan_flat(g, jck._flatten(pg))
    interop.load_gan_flat(d, jck._flatten(pd))
    return pg, pd, g, d


def masks(key, disc, B, step):
    """``apply_discriminator``'s per-block Bernoulli(0.5) masks for ``key``,
    NCHW."""
    out = []
    for shape in sg.keep_shapes(disc, B, step):
        key, sub = jax.random.split(key)
        b, c, h, w = shape
        out.append(t(jax.random.bernoulli(sub, 0.5, (b, h, w, c)))
                   .permute(0, 3, 1, 2).contiguous())
    return out


def noise(key, B, step):
    return [t(n).permute(0, 3, 1, 2).contiguous()
            for n in jsg.make_noise(key, B, step)]


def d_draws(key, disc, B, step):
    """``make_d_loss``'s draws for ``key``: r_drop, r_noise, r_eps,
    r_drop2, r_drop3 = split(key, 5)."""
    r_drop, r_noise, r_eps, r_drop2, r_drop3 = jax.random.split(key, 5)
    return {"keep_real": masks(r_drop, disc, B, step),
            "noise": noise(r_noise, B, step),
            "eps": t(jax.random.uniform(r_eps, (B, 1, 1, 1))),
            "keep_fake": masks(r_drop2, disc, B, step),
            "keep_gp": masks(r_drop3, disc, B, step)}


def g_draws(key, disc, B, step):
    """``make_g_loss``'s draws: r_noise, r_drop = split(key)."""
    r_noise, r_drop = jax.random.split(key)
    return {"noise": noise(r_noise, B, step),
            "keep": masks(r_drop, disc, B, step)}


def cat_draws(parts):
    """Microbatches' draws joined along the batch axis."""
    first = parts[0]
    if isinstance(first, torch.Tensor):
        return torch.cat(parts, dim=0)
    if isinstance(first, dict):
        return {k: cat_draws([p[k] for p in parts]) for k in first}
    return [cat_draws([p[i] for p in parts]) for i in range(len(first))]


def accum_draws(fn, key, disc, B, step, n):
    """The draws of a ``grad_accum=n`` step: microbatch k draws with key k
    of split(key, n), as the JAX package's scan does (``key`` itself for
    n = 1)."""
    if n == 1:
        return fn(key, disc, B, step)
    return cat_draws([fn(k, disc, B // n, step)
                      for k in jax.random.split(key, n)])


def flat_gap(module, jax_tree, where=None):
    """Max |port - JAX| over a module's parameters in the JAX layout,
    relative to max(1, max |JAX|); ``where`` (flat key -> boolean array)
    restricts each leaf to its True elements."""
    got = interop.gan_flat_from_module(module)
    want = {k: np.asarray(v) for k, v in jck._flatten(jax_tree).items()}
    assert set(got) == set(want)
    scale = max(1.0, max(float(np.abs(v).max()) for v in want.values()))
    worst = 0.0
    for k in want:
        diff = np.abs(got[k] - want[k])
        if where is not None:
            diff = diff[where[k]]
        if diff.size:
            worst = max(worst, float(diff.max()))
    return worst / scale


def determined(mu_tree, floor=1e-6):
    """Flat key -> the elements whose first-step gradient (optax's ``mu``
    after one step with b1 = 0) is above ``floor``: where Adam's step,
    g / (|g| + eps), is fixed by the gradient and not by its rounding."""
    return {k: np.abs(np.asarray(v)) > floor
            for k, v in jck._flatten(mu_tree).items()}

SEL = [0, 1, 1, 1, 1, 1, 1, 1, 1]


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(x, np.float32).transpose(0, 3, 1, 2)))


def batch(step, B, seed=0):
    rng = np.random.default_rng(seed)
    s = 4 * 2 ** step
    return (rng.uniform(-1, 1, (B, s, s, 3)).astype(np.float32),
            rng.standard_normal((2, B, D)).astype(np.float32))


def grads_of(module, loss_terms):
    params = list(module.parameters())
    gs = torch.autograd.grad(sum(loss_terms), params, allow_unused=True)
    by = {p: (g if g is not None else torch.zeros_like(p))
          for p, g in zip(params, gs)}
    return interop.gan_flat_from_module(module, lambda p: by[p])


def gap(got: dict, want_tree):
    want = {k: np.asarray(v) for k, v in jck._flatten(want_tree).items()}
    assert set(got) == set(want)
    scale = max(1.0, max(float(np.abs(v).max()) for v in want.values()))
    return max(float(np.abs(got[k] - want[k]).max()) for k in want) / scale


@pytest.mark.parametrize("step", [0, 1, 2])
def test_critic_loss_and_gradients_match_jax(step):
    """The WGAN-GP loss, its gradient penalty and the critic's gradients
    (through the double backward) against jax.grad, with JAX's draws."""
    pg, pd, g, d = nets()
    B = 4
    real, zs = batch(step, B, step)
    key = jax.random.PRNGKey(7 + step)
    (jv, jaux), jg = jax.value_and_grad(
        jgan.make_d_loss(step, width_mult=W, from_rgb_activate=True),
        has_aux=True)(pd, pg, jnp.asarray(real), jnp.asarray(zs),
                      jnp.asarray(SEL), 0.5, key)
    terms = []
    v, aux = gan.d_loss(g, d, nchw(real), torch.from_numpy(zs), SEL, 0.5,
                        d_draws(key, d, B, step), step=step,
                        sink=terms.append)
    assert abs(float(v) - float(jv)) <= 2e-5 * max(1.0, abs(float(jv)))
    for k in ("disc_loss", "grad_penalty"):
        assert abs(float(aux[k]) - float(jaux[k])) <= \
            2e-5 * max(1.0, abs(float(jaux[k])))
    assert float(aux["grad_penalty"]) > 0
    assert gap(grads_of(d, terms), jg) <= 2e-5


@pytest.mark.parametrize("step,loss_kind", [(0, "wgan-gp"), (1, "r1"),
                                            (2, "wgan-gp")])
def test_generator_loss_and_gradients_match_jax(step, loss_kind):
    pg, pd, g, d = nets()
    B = 4
    _, zs = batch(step, B, 10 + step)
    key = jax.random.PRNGKey(20 + step)
    (jv, _), jg = jax.value_and_grad(
        jgan.make_g_loss(step, width_mult=W, from_rgb_activate=True,
                         loss_kind=loss_kind),
        has_aux=True)(pg, pd, jnp.asarray(zs), jnp.asarray(SEL), 0.5, key)
    v = gan.g_loss(g, d, torch.from_numpy(zs), SEL, 0.5,
                   g_draws(key, d, B, step), step=step, loss_kind=loss_kind)
    assert abs(float(v) - float(jv)) <= 2e-5 * max(1.0, abs(float(jv)))
    assert gap(grads_of(g, [v]), jg) <= 2e-5


def _jax_steps(step, grad_accum=1, ema_warmup=False):
    tx = jgan.make_optimizers()
    kw = dict(width_mult=W, from_rgb_activate=True, tx=tx,
              grad_accum=grad_accum)
    return (tx, jgan.make_d_step(step, **kw),
            jgan.make_g_step(step, ema_decay=0.9, ema_warmup=ema_warmup,
                             **kw))


def _port_steps(step, grad_accum=1, ema_warmup=False, remat=False):
    return (gan.make_d_step(step, grad_accum=grad_accum, remat=remat),
            gan.make_g_step(step, grad_accum=grad_accum, remat=remat,
                            ema_decay=0.9, ema_warmup=ema_warmup))


def _steps(step, B, grad_accum, ema_warmup, remat=False, rounds=1):
    """Rounds of (d_step, g_step) in each package from the same weights
    and draws; returns the gaps of the critic, the generator, the EMA and
    the critic's Adam moments, the losses, and the port's modules."""
    pg, pd, g, d = nets()
    tx, jd, jgs = _jax_steps(step, grad_accum, ema_warmup)
    pd_step, pg_step = _port_steps(step, grad_accum, ema_warmup, remat)
    opt_d, opt_g = tx.init(pd), tx.init(pg)
    ema_j = pg
    ema = copy.deepcopy(g).requires_grad_(False)
    g_opt, d_opt = gan.make_optimizers(g, d)
    losses = []
    for r in range(rounds):
        real, zs = batch(step, B, 30 + r)
        key_d, key_g = jax.random.split(jax.random.PRNGKey(40 + r))
        pd, opt_d, jaux = jd(pd, opt_d, pg, jnp.asarray(real),
                             jnp.asarray(zs), jnp.asarray(SEL),
                             jnp.float32(0.5), jnp.float32(1e-3), key_d)
        aux = pd_step(g, d, d_opt, nchw(real), torch.from_numpy(zs), SEL,
                      0.5, 1e-3, accum_draws(d_draws, key_d, d, B, step,
                                               grad_accum))
        pg, opt_g, ema_j, jgl = jgs(pg, opt_g, ema_j, pd, jnp.asarray(zs),
                                    jnp.asarray(SEL), jnp.float32(0.5),
                                    jnp.float32(1e-3), key_g)
        gl = pg_step(g, d, g_opt, ema, torch.from_numpy(zs), SEL, 0.5, 1e-3,
                     accum_draws(g_draws, key_g, d, B, step, grad_accum))
        losses.append((float(jaux["disc_loss"]), float(aux["disc_loss"]),
                       float(jgl), float(gl)))
    where_d = determined(opt_d.mu) if rounds == 1 else None
    where_g = determined(opt_g.mu) if rounds == 1 else None
    for where, mu in ((where_d, opt_d.mu), (where_g, opt_g.mu)):
        if where is not None:  # the undetermined elements, zeros aside
            n = sum(w.size for w in where.values())
            used = sum(int(w.sum()) for w in where.values())
            zero = sum(int((np.asarray(v) == 0).sum())
                       for v in jck._flatten(mu).values())
            assert n - used - zero <= 0.01 * n
    gaps = {"disc": flat_gap(d, pd, where_d),
            "gen": flat_gap(g, pg, where_g),
            "ema": flat_gap(ema, ema_j, where_g)}
    count, mu, nu = interop.gan_adam_to_flat(d, d_opt)
    assert int(count) == int(opt_d.count) == rounds
    gaps["d_mu"] = gap(mu, opt_d.mu)
    gaps["d_nu"] = gap(nu, opt_d.nu)
    return gaps, losses, (g, d, ema)


@pytest.mark.parametrize("grad_accum,ema_warmup", [(1, False), (1, True),
                                                   (2, False)])
def test_adam_and_ema_steps_match_jax(grad_accum, ema_warmup):
    """A critic and a generator step (Adam (0, 0.99), the style MLP at
    lr x 0.01, the EMA, with and without the warm-up; ``grad_accum=2``
    against JAX's scan over two microbatches with its split keys)."""
    gaps, losses, _ = _steps(1, 8, grad_accum, ema_warmup)
    for name, v in gaps.items():
        assert v <= 1e-6, (name, v)
    for jd, pd, jg, pg in losses:
        assert abs(jd - pd) <= 2e-5 * max(1.0, abs(jd))
        assert abs(jg - pg) <= 2e-5 * max(1.0, abs(jg))


def test_grad_accum_is_the_microbatch_average():
    """``grad_accum=2`` steps with the average of the two microbatches'
    gradients, each microbatch's minibatch stddev its own."""
    _, _, g, d = nets()
    step, B = 1, 4
    real, zs = batch(step, B, 3)
    draws = d_draws(jax.random.PRNGKey(3), d, B, step)
    d_hand = copy.deepcopy(d)
    avg = {}
    for sl in (slice(0, 2), slice(2, 4)):
        terms = []
        gan.d_loss(g, d_hand, nchw(real)[sl], torch.from_numpy(zs)[:, sl],
                   SEL, 0.5, gan._rows(draws, sl), step=step,
                   sink=terms.append)
        for k, v in grads_of(d_hand, terms).items():
            avg[k] = avg.get(k, 0.0) + v / 2
    d_opt = torch.optim.Adam(d.parameters())
    captured = {}
    real_step = gan._adam_step

    def capture(opt, lr):
        captured.update(interop.gan_flat_from_module(
            d, lambda p: p.grad if p.grad is not None
            else torch.zeros_like(p)))
        real_step(opt, lr)

    gan._adam_step = capture
    try:
        gan.make_d_step(step, grad_accum=2)(g, d, d_opt, nchw(real),
                                            torch.from_numpy(zs), SEL, 0.5,
                                            1e-3, draws)
    finally:
        gan._adam_step = real_step
    for k, v in avg.items():
        np.testing.assert_allclose(captured[k], v, rtol=0, atol=1e-6)


def test_remat_matches_plain():
    """``--remat`` (non-reentrant checkpointing, carrying the gradient
    penalty's second order) gives the plain steps' parameters."""
    *_, plain = _steps(2, 4, 1, False, rounds=2)
    *_, remat = _steps(2, 4, 1, False, remat=True, rounds=2)
    for a, b in zip(plain, remat):
        for (k, x), y in zip(interop.gan_flat_from_module(a).items(),
                             interop.gan_flat_from_module(b).values()):
            assert np.abs(x - y).max() <= 1e-6 * max(1.0, np.abs(x).max()), k


def test_bf16_steps_are_finite_and_update():
    _, _, g, d = nets()
    before = [p.detach().clone() for p in d.parameters()]
    g_opt, d_opt = gan.make_optimizers(g, d)
    ema = copy.deepcopy(g).requires_grad_(False)
    step, B = 1, 4
    real, zs = batch(step, B)
    gen = torch.Generator().manual_seed(0)
    aux = gan.make_d_step(step, compute_dtype=torch.bfloat16)(
        g, d, d_opt, nchw(real), torch.from_numpy(zs), SEL, 1.0, 1e-3,
        gan.draw_d(gen, d, B, step))
    gl = gan.make_g_step(step, compute_dtype=torch.bfloat16)(
        g, d, g_opt, ema, torch.from_numpy(zs), SEL, 1.0, 1e-3,
        gan.draw_g(gen, d, B, step))
    assert all(np.isfinite(float(v)) for v in (*aux.values(), gl))
    assert aux["grad_penalty"].dtype == torch.float32
    assert any(not torch.equal(a, b) for a, b in zip(before, d.parameters()))
    assert all(p.dtype == torch.float32 for p in g.parameters())


# ---------------------------------------------------------------- the CLI
@pytest.fixture
def store(tmp_path):
    """A resolution-keyed store (4-16 px) built by the port from a tile
    stack."""
    src = tmp_path / "src"
    src.mkdir()
    np.save(src / "tiles.npy", np.random.default_rng(0).integers(
        0, 255, (16, 32, 32, 3)).astype(np.uint8))
    assert gan_dataset._main(["--src", str(src), "--out",
                              str(tmp_path / "store"), "--max-size", "16"],
                             device="cpu") == 0
    return tmp_path / "store"


def _main(store, out, *extra):
    return gan.main(["--data_dir", str(store), "--output_dir", str(out),
                     "--init_size", "4", "--max_size", "16",
                     "--step_every", "1", "--code_size", str(D),
                     "--width_mult", str(W), "--batch_override", "4",
                     "--max_batches", "2", "--phase", "16", "--mixing",
                     *extra], device="cpu")


def test_resume_replays_the_straight_run_bit_for_bit(store, tmp_path):
    assert _main(store, tmp_path / "a", "--epochs", "3") == 0
    assert _main(store, tmp_path / "b", "--epochs", "2") == 0
    ckpt = tmp_path / "b" / "checkpoint" / "train_step-1.model"
    assert _main(store, tmp_path / "b", "--epochs", "3", "--epoch_start",
                 "2", "--ckpt", str(ckpt)) == 0
    a = checkpoint.load_raw(str(tmp_path / "a" / "checkpoint"
                                / "train_step-2.model"))
    b = checkpoint.load_raw(str(tmp_path / "b" / "checkpoint"
                                / "train_step-2.model"))
    assert sorted(a) == sorted(b)
    assert {k.split("/")[0] for k in a} == {
        "generator", "discriminator", "g_optimizer", "d_optimizer",
        "g_running"}
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert int(a["g_optimizer/count"]) == int(a["d_optimizer/count"]) == 6
    assert sorted(os.listdir(tmp_path / "a" / "sample")) == [
        "e0_gen.png", "e1_gen.png", "e2_gen.png"]


def test_checkpoints_cross_between_the_packages(tmp_path):
    """A JAX 5-part checkpoint (after a step, so Adam's moments are live)
    loads into the port, which writes it back bit for bit; the port's
    trainer checkpoint loads into JAX, which writes it back bit for bit;
    and the port's trainer resumes from the JAX file."""
    pg, pd, _, _ = nets()
    tx, jd, jgs = _jax_steps(0)
    opt_d, opt_g = tx.init(pd), tx.init(pg)
    real, zs = batch(0, 4)
    pd, opt_d, _ = jd(pd, opt_d, pg, jnp.asarray(real), jnp.asarray(zs),
                      jnp.asarray(SEL), jnp.float32(1.0), jnp.float32(1e-3),
                      jax.random.PRNGKey(0))
    pg, opt_g, ema, _ = jgs(pg, opt_g, pg, pd, jnp.asarray(zs),
                            jnp.asarray(SEL), jnp.float32(1.0),
                            jnp.float32(1e-3), jax.random.PRNGKey(1))
    src = str(tmp_path / "jax.model")
    jgan.save_gan_checkpoint(src, pg, pd, opt_g, opt_d, ema)

    _, _, g, d = nets(seed=5)
    ema_p = copy.deepcopy(g)
    g_opt, d_opt = gan.make_optimizers(g, d)
    res = gan.load_gan_checkpoint(src, g, d, g_opt, d_opt, ema_p)
    assert all(loaded == total for loaded, total in res.values())
    dest = str(tmp_path / "port.model")
    gan.save_gan_checkpoint(dest, g, d, g_opt, d_opt, ema_p)
    a, b = checkpoint.load_raw(src), checkpoint.load_raw(dest)
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)

    # and back: the port's file through JAX's loader and writer
    tpl_g = jax.tree_util.tree_map(jnp.zeros_like, pg)
    tpl_d = jax.tree_util.tree_map(jnp.zeros_like, pd)
    trees = jgan.load_gan_checkpoint(dest, tpl_g, tpl_d, tx.init(tpl_g),
                                     tx.init(tpl_d), tpl_g)
    again = str(tmp_path / "jax_again.model")
    jgan.save_gan_checkpoint(again, *trees)
    c = checkpoint.load_raw(again)
    assert sorted(c) == sorted(b)
    for k in c:
        np.testing.assert_array_equal(c[k], b[k], err_msg=k)


def test_trainer_resumes_from_a_jax_checkpoint(store, tmp_path):
    pg, pd, _, _ = nets()
    tx = jgan.make_optimizers()
    src = str(tmp_path / "jax.model")
    jgan.save_gan_checkpoint(src, pg, pd, tx.init(pg), tx.init(pd), pg)
    assert _main(store, tmp_path / "r", "--epochs", "1", "--ckpt", src) == 0
    out = checkpoint.load_raw(str(tmp_path / "r" / "checkpoint"
                                  / "train_step-0.model"))
    assert int(out["d_optimizer/count"]) == 2
    # the EMA moved from the JAX generator, a few steps at decay 0.999
    want = np.asarray(jck._flatten(pg)["style/0/w"])
    got = out["g_running/style/0/w"]
    assert not np.array_equal(got, want)
    assert np.abs(got - want).max() < 1e-2


def test_layout_mismatch_warns(tmp_path, capsys):
    pg, pd, _, _ = nets()
    tx = jgan.make_optimizers()
    src = str(tmp_path / "jax.model")
    jgan.save_gan_checkpoint(src, pg, pd, tx.init(pg), tx.init(pd), pg)
    _, _, g, d = nets(width=1 / 8)
    g_opt, d_opt = gan.make_optimizers(g, d)
    gan.load_gan_checkpoint(src, g, d, g_opt, d_opt, copy.deepcopy(g))
    assert "RANDOM init" in capsys.readouterr().out


def test_non_finite_losses_halt_without_a_checkpoint(store, tmp_path,
                                                     monkeypatch):
    real = gan.make_d_step

    def poisoned(step, **kw):
        fn = real(step, **kw)

        def d_step(*a):
            aux = fn(*a)
            return {**aux, "disc_loss": aux["disc_loss"] * float("nan")}

        return d_step

    monkeypatch.setattr(gan, "make_d_step", poisoned)
    rc = _main(store, tmp_path / "nan", "--epochs", "2")
    assert rc == train_pkg.DIVERGED_EXIT
    assert os.listdir(tmp_path / "nan" / "checkpoint") == []


def test_argument_checks_before_any_work(tmp_path):
    for extra, match in ((["--ckpt_every", "0"], "ckpt_every"),
                         (["--ema_decay", "1.0"], "ema_decay"),
                         (["--grad_accum", "3"], "not divisible")):
        with pytest.raises(RuntimeError, match=match):
            gan.main(["--data_dir", str(tmp_path / "none"), "--epochs", "1",
                      "--output_dir", str(tmp_path), *extra], device="cpu")


def test_sample_png_decodes_to_the_jax_pixels(tmp_path):
    """The port writes the grid's PNG with zlib and struct; Pillow decodes
    it to the pixels of the JAX package's Pillow-written file."""
    from PIL import Image

    imgs = np.random.default_rng(0).uniform(-1.2, 1.2, (7, 8, 8, 3)) \
        .astype(np.float32)
    jgan.save_image_grid(jnp.asarray(imgs), str(tmp_path / "jax.png"),
                         nrow=4)
    gan.save_image_grid(nchw(imgs), str(tmp_path / "port.png"), nrow=4)
    with Image.open(tmp_path / "jax.png") as a, \
            Image.open(tmp_path / "port.png") as b:
        assert a.mode == b.mode == "RGB" and a.size == b.size == (32, 16)
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_generate_writes_the_sample_and_mixing_grids(store, tmp_path):
    """``gan_generate.main`` from the trainer's checkpoint: the 3 x 5
    sample grid and the mixing grids (a blank corner, the sources along
    the top, each target beside its mixes), from the EMA section only;
    the mixing grid's blocks 0-1 take the source's style."""
    from PIL import Image

    from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.train import (
        gan_generate,
    )

    assert _main(store, tmp_path / "g", "--epochs", "1") == 0
    ckpt = str(tmp_path / "g" / "checkpoint" / "train_step-0.model")
    out = tmp_path / "gen"
    assert gan_generate.main([ckpt, "--size", "8", "--code_size", str(D),
                              "--width_mult", str(W), "--n_mixing", "2",
                              "--output_dir", str(out)], device="cpu") == 0
    assert sorted(os.listdir(out)) == ["sample.png", "sample_mixing_0.png",
                                       "sample_mixing_1.png"]
    with Image.open(out / "sample.png") as im:
        assert im.size == (5 * 8, 3 * 8)
    with Image.open(out / "sample_mixing_0.png") as im:
        assert im.size == (6 * 8, 4 * 8)
        top_left = np.asarray(im)[:8, :8]
    assert (top_left == 0).all()  # the blank (-1) corner
    g = sg.init_styled_generator(torch.Generator().manual_seed(0),
                                 style_dim=D, width_mult=W, device="cpu")
    gen = torch.Generator().manual_seed(3)
    with torch.no_grad():
        mean = gan_generate.get_mean_style(g, gen, code_size=D)
        grid = gan_generate.style_mixing(g, gen, 1, mean, 5, 3, code_size=D)
    assert grid.shape == (1 + 5 + 3 * (1 + 5), 3, 8, 8)
    assert torch.isfinite(grid).all()
