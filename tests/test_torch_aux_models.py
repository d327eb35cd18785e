"""The port's WAE (encoder, decoder, latent critic, DownConv / UpConv),
LatentUNet, cluster layer and SMOTE jitter against the JAX package's
``models/wae.py`` and ``models/unet.py``, parameters carried across by
``utils/interop.py`` (small widths, 32 px): the parameters are the
port's seeded init, handed to JAX as its tree by
``interop.aux_params_from_module`` (JAX's eager init of these trees costs
seconds each); ``aux_module_from_jax`` carries JAX's own init back, and
the two inits' scales are compared.

Forwards are held to a relative 1e-5 in f32, gradients of a
reconstruction loss to 2e-5 x max(1, max|g|). Where JAX draws from
``jax.random`` (dropout masks, SMOTE's noise) the test hands both
packages the same draws. The LatentUNet's encoder tap is resized to the
decoder's map when they differ; the JAX package's ``jax.image.resize``
"nearest" is matched by ``mode="nearest-exact"``, held here in both
directions.

The whole LatentUNet is held to JAX in float64 (both packages, JAX under
``jax.enable_x64``) to 1e-10 relative, and the port's float32 to its own
float64 to 1e-5: at these sizes its BNs normalise over a few dozen
values, and XLA:CPU's float32 forward is itself 3e-5..1.2e-4 (relative)
from the float64 result, 10-40x the port's float32 error (2e-6..1e-5),
so the two float32 results cannot be held to each other at 1e-5."""

import copy

import numpy as np
import pytest
import torch

import conftest  # noqa: F401
import jax
import jax.numpy as jnp

from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu.models import (
    unet as junet,
    wae as jwae,
)
from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.models import (
    unet,
    wae,
)
from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.utils import (
    interop,
)

ENC, DEC = ((3, 8), (8, 12)), ((3, 8), (8, 12))


def _tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _rel(got, want, tol=1e-5):
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got,
                     np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))
    assert err <= tol, err


def _x(shape=(2, 32, 32, 3), seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _feed_bernoulli(monkeypatch, masks):
    """jax.random.bernoulli returns ``masks`` in order."""
    it = iter(masks)

    def bernoulli(key, p, shape):
        m = next(it)
        assert tuple(m.shape) == tuple(shape)
        return jnp.asarray(m.numpy())

    monkeypatch.setattr(jax.random, "bernoulli", bernoulli)
    return it


def test_batch_norm_and_conv_transpose_match_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, 5, 3)).astype(np.float32)
    g, b = rng.standard_normal(3).astype(np.float32), rng.standard_normal(
        3).astype(np.float32)
    _rel(wae.batch_norm_2d(*map(torch.from_numpy, (x, g, b))),
         jwae.batch_norm_2d(*map(jnp.asarray, (x, g, b))))
    w = rng.standard_normal((2, 2, 3, 4)).astype(np.float32)
    bias = rng.standard_normal(4).astype(np.float32)
    got = wae.conv_transpose_2x2(torch.from_numpy(x),
                                 torch.from_numpy(w.transpose(2, 3, 0, 1)
                                                  .copy()),
                                 torch.from_numpy(bias))
    assert got.shape == (2, 10, 10, 4)
    _rel(got, jwae.conv_transpose_2x2(jnp.asarray(x), jnp.asarray(w),
                                      jnp.asarray(bias)))


def _seeded(init, seed, **kw):
    """A port module from its own init, and its tree for JAX."""
    model = init(torch.Generator().manual_seed(seed), device="cpu", **kw)
    return interop.aux_params_from_module(model), model


def test_encoder_decoder_discriminator_eval():
    je, enc = _seeded(wae.init_encoder, 0, channels=ENC)
    jd, dec = _seeded(wae.init_decoder, 1, channels=DEC)
    jc, crit = _seeded(wae.init_wae_discriminator, 2)
    x = _x()
    with torch.no_grad():
        z = wae.apply_encoder(enc, torch.from_numpy(x))
        img = wae.apply_decoder(dec, z)
        score = wae.apply_wae_discriminator(crit, z)
    jz = jwae.apply_encoder(je, jnp.asarray(x))
    assert z.shape == (2, 512) and img.shape == (2, 32, 32, 3)
    _rel(z, jz)
    _rel(img, jwae.apply_decoder(jd, jz, channels=DEC))
    _rel(score, jwae.apply_wae_discriminator(jc, jz))
    # train without a generator or masks runs as eval, as JAX without a key
    with torch.no_grad():
        np.testing.assert_array_equal(
            wae.apply_encoder(enc, torch.from_numpy(x), train=True).numpy(),
            z.numpy())


def test_encoder_and_critic_train_with_injected_masks(monkeypatch):
    je, enc = _seeded(wae.init_encoder, 3, channels=ENC)
    jc, crit = _seeded(wae.init_wae_discriminator, 4)
    x = torch.from_numpy(_x(seed=2))
    g = torch.Generator().manual_seed(3)
    masks = enc.masks(g, x)
    assert [tuple(m.shape) for m in masks[1]] == [
        (2, 16, 16, 12), (2, 16, 16, 12), (2, 1, 1, 12)]
    z = wae.apply_encoder(enc, x, train=True, masks=masks)
    # drawn from a generator: the same masks from the same seed
    z2 = wae.apply_encoder(enc, x, train=True,
                           generator=torch.Generator().manual_seed(3))
    np.testing.assert_array_equal(z.detach().numpy(), z2.detach().numpy())
    _feed_bernoulli(monkeypatch, [m for block in masks for m in block])
    jz = jwae.apply_encoder(je, jnp.asarray(x.numpy()), train=True,
                            rng=jax.random.PRNGKey(0))
    _rel(z, jz)
    cmasks = crit.masks(g, z)
    score = wae.apply_wae_discriminator(crit, z, train=True, masks=cmasks)
    _feed_bernoulli(monkeypatch, cmasks)
    _rel(score, jwae.apply_wae_discriminator(jc, jz, train=True,
                                             rng=jax.random.PRNGKey(0)),
         2e-5)


def _unet_pair(seed, **kw):
    return _seeded(unet.init_latent_unet, seed, **kw)


# latent 256: the decoder starts from 4x4 planes, so its first BN
# normalises over 32 values (at 64, over 8, float32 rounding alone moves
# the output 1e-5)
UNET = dict(depth=3, start_filts=4, input_size=32, latent_dim=256)


def _f64(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), tree)


def _unet_both(jp, model, x, **kw):
    """The port's outputs in float32 and float64, and JAX's in float64."""
    with torch.no_grad():
        got = unet.apply_latent_unet(model, torch.from_numpy(x), **kw)
        got64 = unet.apply_latent_unet(copy.deepcopy(model).double(),
                                       torch.from_numpy(x).double(), **kw)
    with jax.enable_x64(True):
        want = junet.apply_latent_unet(
            _f64(jp), jnp.asarray(x, jnp.float64),
            concat_layer=model.concat_layer, latent_dim=model.latent_dim,
            **{k: v for k, v in kw.items() if k == "early_stop"})
        want = [None if w is None else np.asarray(w) for w in want]
    return got, got64, want


def _held(got, got64, want):
    for g, g64, w in zip(got, got64, want):
        if w is None:
            assert g is None and g64 is None
            continue
        _rel(g64.numpy(), w, 1e-10)
        _rel(g.numpy(), g64.numpy(), 1e-5)


@pytest.mark.parametrize("concat_layer", [-1, 0, 1])
def test_latent_unet_matches_jax(concat_layer):
    jp, model = _unet_pair(0, concat_layer=concat_layer, **UNET)
    assert model.concat_layer == concat_layer
    x = _x()
    got, got64, want = _unet_both(jp, model, x)
    assert got[0].shape == (2, 16, 16, 3) and got[1].shape == (2, 256)
    _held(got, got64, want)
    bottom = _unet_both(jp, model, x, early_stop=True)
    _held(*bottom)
    np.testing.assert_array_equal(bottom[0][1].numpy(), got[1].numpy())


@pytest.mark.parametrize("merge_mode,side", [
    ("concat", 8), ("concat", 16), ("concat", 3), ("add", 8), ("add", 5),
    ("skip", 8)])
def test_up_block_merge_modes(merge_mode, side):
    """Every merge mode, with an encoder tap of the decoder's size (8) and
    of other sizes, which the block resizes (up and down)."""
    concat = 0 if merge_mode == "concat" else -1
    jp, model = _unet_pair(1, concat_layer=concat, **UNET)
    rng = np.random.default_rng(4)
    from_up = rng.standard_normal((2, 4, 4, 16)).astype(np.float32)
    from_down = rng.standard_normal((2, side, side, 10)).astype(np.float32)
    with torch.no_grad():
        got = model.up[0](torch.from_numpy(from_down),
                          torch.from_numpy(from_up), merge_mode=merge_mode)
    want = junet._up_block(jp["up"][0], jnp.asarray(from_down),
                           jnp.asarray(from_up), merge_mode=merge_mode)
    assert got.shape == (2, 8, 8, 8)
    _rel(got, want)
    with pytest.raises(ValueError, match="merge_mode"):
        model.up[0](torch.from_numpy(from_down), torch.from_numpy(from_up),
                    merge_mode="mean")


@pytest.mark.parametrize("src,dst", [(10, 74), (19, 74), (16, 4), (32, 8),
                                     (7, 5)])
def test_nearest_exact_is_jax_nearest(src, dst):
    a = np.random.default_rng(src).standard_normal(
        (1, src, src, 2)).astype(np.float32)
    want = jax.image.resize(jnp.asarray(a), (1, dst, dst, 2), "nearest")
    got = torch.nn.functional.interpolate(
        torch.from_numpy(a).permute(0, 3, 1, 2), size=(dst, dst),
        mode="nearest-exact").permute(0, 2, 3, 1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_latent_unet_perturbation(monkeypatch):
    jp, model = _unet_pair(2, concat_layer=1, **UNET)
    x = _x(seed=5)
    model, x64 = model.double(), torch.from_numpy(x).double()
    with torch.no_grad():
        recon, _, tap = unet.apply_latent_unet(
            model, x64, generator=torch.Generator().manual_seed(6),
            perturbation=True)
        plain = unet.apply_latent_unet(model, x64)[0]
    noise = torch.randn(tap.shape, generator=torch.Generator().manual_seed(6))
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape: jnp.asarray(noise.numpy(),
                                                       jnp.float64))
    with jax.enable_x64(True):
        jr, _, _ = junet.apply_latent_unet(
            _f64(jp), jnp.asarray(x, jnp.float64), rng=jax.random.PRNGKey(0),
            perturbation=True, concat_layer=1, latent_dim=256)
    _rel(recon.numpy(), np.asarray(jr), 1e-10)
    assert float((recon - plain).abs().max()) > 1e-4


def test_smote_layer_matches_jax(monkeypatch):
    x = torch.from_numpy(_x((4, 8), seed=7))
    out = unet.smote_layer(x, torch.Generator().manual_seed(8))
    noise = torch.randn((4, 8), generator=torch.Generator().manual_seed(8))
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape: jnp.asarray(noise.numpy()))
    want = junet.smote_layer(jnp.asarray(x.numpy()), jax.random.PRNGKey(0))
    np.testing.assert_array_equal(out.numpy(), np.asarray(want))
    assert 0 < float((out - x).abs().max()) < 0.05


def test_cluster_layer_matches_jax():
    jp, layer = _seeded(unet.init_cluster_layer, 0, n_clusters=3, dim=8)
    x = _x((5, 2, 4), seed=9)
    with torch.no_grad():
        inertia, xe, cl = unet.apply_cluster_layer(layer,
                                                   torch.from_numpy(x))
    ji, jx, jcl = junet.apply_cluster_layer(jp, jnp.asarray(x))
    np.testing.assert_array_equal(cl.numpy(), np.asarray(jcl))
    _rel(inertia, ji)
    _rel(xe, jx)
    back = interop.aux_module_from_jax("cluster", _tree(
        junet.init_cluster_layer(jax.random.PRNGKey(0), 3, dim=8)),
        device="cpu")
    assert back.centers.shape == (3, 8)


def _grads_close(module, want, tol=2e-5):
    got = interop.aux_params_from_module(
        module, value=lambda p: torch.zeros_like(p) if p.grad is None
        else p.grad)  # JAX gives the unused taps zeros
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        b = np.asarray(b)
        assert a.shape == b.shape
        assert np.abs(a - b).max() <= tol * max(1.0, np.abs(b).max())


def test_reconstruction_gradients_match_jax():
    """One backward of a reconstruction loss through the WAE (encoder +
    decoder) and through the LatentUNet."""
    je, enc = _seeded(wae.init_encoder, 5, channels=ENC)
    jd, dec = _seeded(wae.init_decoder, 6, channels=DEC)
    x = _x(seed=10)
    loss = ((wae.apply_decoder(dec, wae.apply_encoder(
        enc, torch.from_numpy(x))) - torch.from_numpy(x)) ** 2).mean()
    loss.backward()
    jg = jax.jit(jax.grad(lambda e, d: jnp.mean((jwae.apply_decoder(
        d, jwae.apply_encoder(e, jnp.asarray(x)), channels=DEC)
        - jnp.asarray(x)) ** 2), argnums=(0, 1)))(je, jd)
    _grads_close(enc, jg[0])
    _grads_close(dec, jg[1])

    # the LatentUNet in float64, as its forward above
    jp, model = _unet_pair(4, concat_layer=0, **UNET)
    model = model.double()
    target = _x((2, 16, 16, 3), seed=11).astype(np.float64)
    recon, _, _ = unet.apply_latent_unet(model,
                                         torch.from_numpy(x).double())
    ((recon - torch.from_numpy(target)) ** 2).mean().backward()
    with jax.enable_x64(True):
        jgu = jax.jit(jax.grad(lambda p: jnp.mean((junet.apply_latent_unet(
            p, jnp.asarray(x, jnp.float64), concat_layer=0,
            latent_dim=256)[0] - jnp.asarray(target)) ** 2)))(_f64(jp))
        jgu = _tree(jgu)
    # interop hands the gradients over as float32: 1e-6 covers its rounding
    _grads_close(model, jgu, 1e-6)


def test_init_matches_jax_scales():
    """JAX's own inits (jitted), carried into the port's modules and back,
    against the port's inits: the same leaves, the same scales."""
    jp = _tree(jax.jit(lambda k: junet.init_latent_unet(
        k, concat_layer=1, **UNET))(jax.random.PRNGKey(0)))
    je = _tree(jax.jit(jwae.init_encoder)(jax.random.PRNGKey(0)))
    pairs = []
    for kind, tree, ours in (
            ("latent_unet", jp, unet.init_latent_unet(
                torch.Generator().manual_seed(0), device="cpu",
                concat_layer=1, **UNET)),
            ("encoder", je, wae.init_encoder(
                torch.Generator().manual_seed(0), device="cpu"))):
        back = interop.aux_params_from_module(
            interop.aux_module_from_jax(kind, tree, device="cpu"))
        for a, b in zip(jax.tree_util.tree_leaves(back),
                        jax.tree_util.tree_leaves(tree)):
            np.testing.assert_array_equal(a, b)
        pairs.append((tree, interop.aux_params_from_module(ours)))
    for a_tree, b_tree in pairs:
        for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(a_tree),
                                jax.tree_util.tree_leaves(b_tree)):
            assert a.shape == b.shape, path
            if path[-1].key in ("b", "beta"):
                np.testing.assert_array_equal(b, 0.0)
            elif path[-1].key == "gamma":
                np.testing.assert_array_equal(b, 1.0)
            elif a.size >= 2000:
                assert abs(np.std(b) / np.std(a) - 1.0) < 0.1, path


def _input_grad_close(got, want, tol=1e-5):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err <= tol * max(1.0, float(np.abs(want).max())), err


# ReLU ties: at a zero input every pre-activation ahead of the first
# nonzero bias is exactly 0, where JAX's ``jnp.maximum(x, 0)`` takes the
# derivative 0.5 and PyTorch's ReLU 0 (``ops/nn.relu`` takes JAX's). The
# batch-statistics BNs of a constant input divide by sqrt(eps), so the
# WAE and LatentUNet gradients are held in float64 (JAX under x64).


def test_wae_encoder_gradient_at_zero_input():
    je, enc = _seeded(wae.init_encoder, 5, channels=ENC)
    enc = enc.double()
    r = np.random.default_rng(0).standard_normal((2, 512))
    x = torch.zeros((2, 32, 32, 3), dtype=torch.float64, requires_grad=True)
    (wae.apply_encoder(enc, x) * torch.from_numpy(r)).sum().backward()
    with jax.enable_x64(True):
        jgx, jgp = jax.grad(lambda xx, p: jnp.sum(
            jwae.apply_encoder(p, xx) * r), argnums=(0, 1))(
                jnp.zeros((2, 32, 32, 3), jnp.float64), _f64(je))
        jgx, jgp = np.asarray(jgx), _tree(jgp)
    _input_grad_close(x.grad.numpy(), jgx)
    assert float(np.abs(jgp["fc"]["b"]).max()) > 0.1
    _input_grad_close(enc.fc.bias.grad.numpy(), jgp["fc"]["b"])


def test_latent_unet_gradient_at_zero_input():
    jp, model = _unet_pair(4, concat_layer=0, **UNET)
    model = model.double()
    target = _x((2, 16, 16, 3), seed=11).astype(np.float64)
    x = torch.zeros((2, 32, 32, 3), dtype=torch.float64, requires_grad=True)
    recon, _, _ = unet.apply_latent_unet(model, x)
    ((recon - torch.from_numpy(target)) ** 2).mean().backward()
    with jax.enable_x64(True):
        want = np.asarray(jax.grad(lambda xx: jnp.mean((
            junet.apply_latent_unet(_f64(jp), xx, concat_layer=0,
                                    latent_dim=256)[0]
            - jnp.asarray(target)) ** 2))(jnp.zeros((2, 32, 32, 3),
                                                    jnp.float64)))
    _input_grad_close(x.grad.numpy(), want)


def test_tiny_extractor_gradient_at_zero_tile():
    """``models/blocks.py``'s TinyExtractor: its stem is a bias-free conv
    and a ReLU, so a zero tile meets the tie at every stem output."""
    from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu.models import (
        blocks as jblocks,
    )
    from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.models import (
        blocks,
    )
    jp = _tree(jblocks.init_tiny_extractor(jax.random.PRNGKey(2), 10))
    params = jax.tree_util.tree_map(torch.from_numpy, jp)
    r = np.random.default_rng(1).standard_normal((1, 10)).astype(np.float32)
    x = torch.zeros((1, 192, 192, 3), requires_grad=True)
    (blocks.apply_tiny_extractor(params, x, 10)
     * torch.from_numpy(r)).sum().backward()
    want = np.asarray(jax.jit(jax.grad(lambda xx: jnp.sum(
        jblocks.apply_tiny_extractor(jp, xx, 10) * r)))(
            jnp.zeros((1, 192, 192, 3))))
    assert float(np.abs(want).max()) > 1e-2
    _input_grad_close(x.grad.numpy(), want)
