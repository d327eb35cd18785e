"""The port's StyleGAN (``models/stylegan.py``) against the JAX package's
on the CPU, with the same inputs (numpy, seeded) and the JAX weights
carried over through ``utils/interop.load_gan_flat``.

Tolerances: each op and the whole generator and critic at steps 0-2
(alpha 0.5, 1 and no blend) agree to 1e-5 relative to the largest output;
the port's convolutions run in another order of sums (the blur is a
grouped conv here, shift-adds there). The state-dict names are the
reference's (those the JAX package's exporter writes), and the style
mixing schedule is the same function of the same ``random.Random``."""

import random

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
from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu.utils import (
    torch_interop as jti,
)
from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.models import (
    stylegan as sg,
)
from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.utils import (
    interop,
)

W, D = 1 / 16, 32
REL = 1e-5


def rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(x, np.float32).transpose(0, 3, 1, 2)))


def nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


@pytest.fixture(scope="module")
def nets():
    """JAX parameters and the port's modules holding the same weights."""
    pg = jsg.init_styled_generator(jax.random.PRNGKey(0), style_dim=D,
                                   width_mult=W)
    pd = jsg.init_discriminator(jax.random.PRNGKey(1), width_mult=W)
    g = sg.init_styled_generator(torch.Generator().manual_seed(0),
                                 style_dim=D, width_mult=W, device="cpu")
    d = sg.init_discriminator(torch.Generator().manual_seed(0),
                              width_mult=W, device="cpu")
    assert interop.load_gan_flat(g, jck._flatten(pg)) == (123, 123)
    assert interop.load_gan_flat(d, jck._flatten(pd)) == (56, 56)
    return pg, pd, g, d


def test_fused_upsample_and_downsample_match_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 6, 6, 5)).astype(np.float32)
    w = rng.standard_normal((5, 5, 5, 7)).astype(np.float32)
    b = rng.standard_normal(7).astype(np.float32)
    want = jsg.fused_upsample(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                              padding=2)
    up = sg.FusedUpsample(5, 7, 5, 2)
    with torch.no_grad():
        up.weight.copy_(torch.from_numpy(w.transpose(2, 3, 0, 1)))
        up.bias.copy_(torch.from_numpy(b))
    got = up(nchw(x))
    assert got.shape == (2, 7, 12, 12)
    assert rel_err(nhwc(got), want) < REL

    want = jsg.fused_downsample(jnp.asarray(x), jnp.asarray(w[..., :7]),
                                jnp.asarray(b), padding=2)
    down = sg.FusedDownsample(5, 7, 5, 2)
    with torch.no_grad():
        down.weight.copy_(torch.from_numpy(w.transpose(3, 2, 0, 1)))
        down.bias.copy_(torch.from_numpy(b))
    got = down(nchw(x))
    assert got.shape == (2, 7, 3, 3)
    assert rel_err(nhwc(got), want) < REL


def test_blur_upsample_and_norms_match_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 8, 8, 4)).astype(np.float32)
    assert rel_err(nhwc(sg.Blur(4)(nchw(x))), jsg.blur(jnp.asarray(x))) < REL
    want = jax.image.resize(jnp.asarray(x), (3, 16, 16, 4), "bilinear")
    assert rel_err(nhwc(sg.upsample2x(nchw(x))), want) < REL
    assert rel_err(nhwc(sg.pixel_norm(nchw(x))),
                   jsg.pixel_norm(jnp.asarray(x))) < REL
    assert rel_err(nhwc(sg.instance_norm(nchw(x))),
                   jsg.instance_norm(jnp.asarray(x))) < REL
    z = rng.standard_normal((5, D)).astype(np.float32)
    assert rel_err(sg.pixel_norm(torch.from_numpy(z), dim=-1).numpy(),
                   jsg.pixel_norm(jnp.asarray(z))) < REL


def test_adain_noise_and_minibatch_stddev_match_jax():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((3, 8, 8, 4)).astype(np.float32)
    style = rng.standard_normal((3, D)).astype(np.float32)
    w = rng.standard_normal((D, 8)).astype(np.float32)
    b = rng.standard_normal(8).astype(np.float32)
    want = jsg.adain(jnp.asarray(x), jnp.asarray(style),
                     {"w": jnp.asarray(w), "b": jnp.asarray(b)})
    m = sg.AdaptiveInstanceNorm(4, D)
    with torch.no_grad():
        m.style.linear.weight_orig.copy_(torch.from_numpy(w.T))
        m.style.linear.bias.copy_(torch.from_numpy(b))
    assert rel_err(nhwc(m(nchw(x), torch.from_numpy(style))), want) < REL

    noise = rng.standard_normal((3, 8, 8, 1)).astype(np.float32)
    nw = rng.standard_normal(4).astype(np.float32)
    want = jsg.noise_inject(jnp.asarray(x), jnp.asarray(noise),
                            jnp.asarray(nw))
    ni = sg.NoiseInjection(4)
    with torch.no_grad():
        ni.weight_orig.copy_(torch.from_numpy(nw.reshape(1, 4, 1, 1)))
    assert rel_err(nhwc(ni(nchw(x), nchw(noise))), want) < REL

    got = sg.minibatch_stddev(nchw(x))
    assert got.shape == (3, 5, 8, 8)
    assert rel_err(nhwc(got), jsg.minibatch_stddev(jnp.asarray(x))) < REL


def test_state_dict_names_are_the_references(nets):
    """The modules' state dicts carry exactly the keys the JAX package's
    exporter writes, and load its export strictly."""
    pg, pd, g, d = nets
    flat_g = {k: np.asarray(v) for k, v in jck._flatten(pg).items()}
    flat_d = {k: np.asarray(v) for k, v in jck._flatten(pd).items()}
    sd_g = jti._export_gen_sd(flat_g)
    sd_d = jti._export_disc_sd(flat_d)
    assert set(sd_g) == set(g.state_dict())
    assert set(sd_d) == set(d.state_dict())
    g2 = sg.StyledGenerator(D, width_mult=W)
    g2.load_state_dict({k: torch.from_numpy(np.array(v))
                        for k, v in sd_g.items()}, strict=True)
    for k, v in g.state_dict().items():
        assert torch.equal(g2.state_dict()[k], v), k


@pytest.mark.parametrize("step", [0, 1, 2])
def test_generator_and_critic_match_jax(nets, step):
    pg, pd, g, d = nets
    rng = np.random.default_rng(10 + step)
    B, s = 3, 4 * 2 ** step
    zs = rng.standard_normal((2, B, D)).astype(np.float32)
    noise = [rng.standard_normal((B, 4 * 2 ** i, 4 * 2 ** i, 1))
             .astype(np.float32) for i in range(step + 1)]
    x = rng.standard_normal((B, s, s, 3)).astype(np.float32)
    sel = [0, 1, 1, 1, 1, 1, 1, 1, 1]
    for alpha in (0.5, 1.0, -1.0):
        want = jsg.apply_styled_generator(
            pg, jnp.asarray(zs), [jnp.asarray(n) for n in noise], step=step,
            alpha=alpha, style_sel=jnp.asarray(sel), width_mult=W)
        got = sg.apply_styled_generator(
            g, torch.from_numpy(zs), [nchw(n) for n in noise], step=step,
            alpha=alpha, style_sel=sel)
        assert got.shape == (B, 3, s, s)
        assert rel_err(nhwc(got), want) < REL, (step, alpha)
        want = jsg.apply_discriminator(pd, jnp.asarray(x), step=step,
                                       alpha=alpha, width_mult=W)
        got = sg.apply_discriminator(d, nchw(x), step=step, alpha=alpha)
        assert got.shape == (B, 1)
        assert rel_err(got.detach().numpy(), want) < REL, (step, alpha)


def test_critic_dropout_masks_match_jax(nets):
    """Train mode with JAX's own Bernoulli masks: the per-block key split
    of ``apply_discriminator`` reproduced, the masks handed to the port."""
    _, pd, _, d = nets
    step, B = 2, 4
    x = np.random.default_rng(3).standard_normal(
        (B, 16, 16, 3)).astype(np.float32)
    key = jax.random.PRNGKey(5)
    want = jsg.apply_discriminator(pd, jnp.asarray(x), step=step, alpha=0.5,
                                   width_mult=W, train=True, rng=key)
    masks, r = [], key
    for shape in sg.keep_shapes(d, B, step):
        r, sub = jax.random.split(r)
        b, c, h, w = shape
        masks.append(torch.from_numpy(np.asarray(
            jax.random.bernoulli(sub, 0.5, (b, h, w, c))).transpose(
                0, 3, 1, 2).copy()))
    got = sg.apply_discriminator(d, nchw(x), step=step, alpha=0.5,
                                 keep=masks)
    assert rel_err(got.detach().numpy(), want) < REL
    # a generator draws masks of the same shapes; eval differs from train
    drawn = sg.draw_dropout(torch.Generator().manual_seed(0), d, B, step)
    assert [tuple(m.shape) for m in drawn] == sg.keep_shapes(d, B, step)


def test_style_mixing_and_sample_style_sel(nets):
    pg, _, g, _ = nets
    n_blocks = g.n_blocks
    assert n_blocks == len(jsg._gen_layout(W))
    for step in range(0, 5):
        for n_styles in (1, 2):
            a = sg.sample_style_sel(random.Random(step), n_styles, step,
                                    n_blocks)
            b = jsg.sample_style_sel(random.Random(step), n_styles, step,
                                     n_blocks)
            assert a == b
    # mixing changes the output, and equals JAX's with the same sel
    rng = np.random.default_rng(4)
    zs = rng.standard_normal((2, 2, D)).astype(np.float32)
    noise = [rng.standard_normal((2, 4 * 2 ** i, 4 * 2 ** i, 1))
             .astype(np.float32) for i in range(3)]
    sel = sg.sample_style_sel(random.Random(1), 2, 2, n_blocks)
    got = sg.apply_styled_generator(g, torch.from_numpy(zs),
                                    [nchw(n) for n in noise], step=2,
                                    style_sel=sel)
    plain = sg.apply_styled_generator(g, torch.from_numpy(zs),
                                      [nchw(n) for n in noise], step=2)
    assert not torch.allclose(got, plain)
    want = jsg.apply_styled_generator(
        pg, jnp.asarray(zs), [jnp.asarray(n) for n in noise], step=2,
        style_sel=jnp.asarray(sel), width_mult=W)
    assert rel_err(nhwc(got), want) < REL


def test_mean_style_truncation_matches_jax(nets):
    pg, _, g, _ = nets
    z = np.random.default_rng(6).standard_normal((64, D)).astype(np.float32)
    want = jsg.mean_style(pg, jnp.asarray(z))
    got = sg.mean_style(g, torch.from_numpy(z))
    assert rel_err(got.detach().numpy(), want) < REL


def test_step_out_of_range_raises(nets):
    _, _, g, d = nets
    with pytest.raises(ValueError, match="out of range"):
        sg.apply_generator(g.generator, torch.zeros(1, 1, D), [], step=9)
    with pytest.raises(ValueError, match="out of range"):
        sg.apply_discriminator(d, torch.zeros(1, 3, 4, 4), step=-1)


# LeakyReLU(0.2) at exactly 0: JAX's ``where(x >= 0, x, 0.2 x)`` takes the
# derivative 1 there, PyTorch's leaky_relu the slope. A zero latent row
# (pixel_norm(0) = 0 meets the zero-initialised biases) and a black real
# batch (bias-free from_rgb outputs) put every activation of their path
# on the tie.


def test_style_mlp_gradient_with_a_zero_latent_row_matches_jax(nets):
    import test_torch_gan_train as H
    pg, _, g, _ = nets
    z = np.random.default_rng(3).standard_normal((4, D)).astype(np.float32)
    z[1] = 0.0
    want = jax.grad(lambda p: jnp.sum(jsg.apply_style_mlp(
        p, jnp.asarray(z))))(pg)
    got = H.grads_of(g, [sg.apply_style_mlp(g, torch.from_numpy(z)).sum()])
    assert H.gap(got, want) <= REL


def test_critic_step_at_the_ties_matches_jax():
    """One WGAN-GP critic loss and its gradients (the penalty's double
    backward through every activation) on a black real batch and a zero
    latent row, with JAX's draws."""
    import test_torch_gan_train as H
    from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu.train import (
        gan as jgan,
    )
    from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.train import (
        gan,
    )
    pg, pd, g, d = H.nets()
    step, B = 1, 4
    real, zs = H.batch(step, B, step)
    real[:] = 0.0
    zs[:, 1] = 0.0
    key = jax.random.PRNGKey(8)
    (jv, jaux), jg = jax.value_and_grad(
        jgan.make_d_loss(step, width_mult=W, from_rgb_activate=True),
        has_aux=True)(pd, pg, jnp.asarray(real), jnp.asarray(zs),
                      jnp.asarray(H.SEL), 0.5, key)
    terms = []
    v, aux = gan.d_loss(g, d, H.nchw(real), torch.from_numpy(zs), H.SEL,
                        0.5, H.d_draws(key, d, B, step), step=step,
                        sink=terms.append)
    for got, want in ((v, jv), (aux["disc_loss"], jaux["disc_loss"]),
                      (aux["grad_penalty"], jaux["grad_penalty"])):
        assert abs(float(got) - float(want)) <= REL * max(
            1.0, abs(float(want)))
    assert float(aux["grad_penalty"]) > 0
    assert H.gap(H.grads_of(d, terms), jg) <= REL


def test_leaky_relu_modules_hold_no_parameters(nets):
    """The activations standing in the reference's Sequentials are
    ``stylegan.LeakyReLU``, parameter-free, with JAX's derivative."""
    _, _, g, d = nets
    acts = [m for m in [*g.modules(), *d.modules()]
            if isinstance(m, sg.LeakyReLU)]
    assert len(acts) >= 8 and not any(
        isinstance(m, torch.nn.LeakyReLU) for m in [*g.modules(),
                                                    *d.modules()])
    assert all(not list(m.parameters()) for m in acts)
    x = torch.tensor([-1.0, 0.0, 2.0], requires_grad=True)
    (gx,) = torch.autograd.grad(sg.LeakyReLU()(x).sum(), x)
    np.testing.assert_array_equal(gx.numpy(), np.float32([0.2, 1.0, 1.0]))


def _norm_and_grad(fn, x0, gy):
    x = x0.clone().requires_grad_(True)
    y = fn(x)
    (gx,) = torch.autograd.grad(y, x, gy)
    return y.detach(), gx


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   "autocast"])
@pytest.mark.parametrize("shape", [(8, 64, 32, 32), (4, 16, 4, 4),
                                   (2, 512, 8, 8), (3, 5, 7, 9)])
def test_instance_norm_is_the_plain_formula_bit_for_bit(shape, dtype):
    """The saved-operand product changes no bit of the output or of x's
    gradient, against the formula written out, over several seeded draws
    (the 4x4 first block and a full-width C among the shapes), in f32, in
    bf16 and under the bf16 autocast of the GAN's ``--compute_dtype
    bf16``."""
    autocast = dtype == "autocast"
    for seed in range(3):
        g = torch.Generator().manual_seed(seed)
        x0 = (3 * torch.randn(shape, generator=g) + 1).to(
            torch.bfloat16 if autocast else dtype)
        gy = torch.randn(shape, generator=g).to(x0.dtype)
        with torch.autocast("cpu", dtype=torch.bfloat16, enabled=autocast):
            y_ref, gx_ref = _norm_and_grad(sg.instance_norm_plain, x0, gy)
            y, gx = _norm_and_grad(sg.instance_norm, x0, gy)
        assert torch.equal(y, y_ref) and torch.equal(gx, gx_ref)


def _saved_bytes(fn, x):
    """Bytes of the distinct storages autograd keeps for fn(x)'s backward."""
    storages = {}

    def pack(t):
        s = t.untyped_storage()
        storages[s.data_ptr()] = s.nbytes()
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        fn(x)
    return sum(storages.values())


def test_instance_norm_keeps_one_copy_of_the_centred_input():
    x = torch.randn(8, 64, 32, 32, requires_grad=True)
    plain, kept = _saved_bytes(sg.instance_norm_plain, x), _saved_bytes(
        sg.instance_norm, x)
    activation = x.numel() * x.element_size()
    assert plain >= 2 * activation
    assert activation <= kept < activation * 1.01


def test_instance_norm_cannot_be_differentiated_twice():
    x = torch.randn(2, 3, 4, 4, requires_grad=True)
    (gx,) = torch.autograd.grad(sg.instance_norm(x).pow(3).sum(), x,
                                create_graph=True)
    with pytest.raises(RuntimeError, match="once_differentiable"):
        gx.sum().backward()
