"""The port's interpretability kit against the JAX package's, from the
same numpy inputs, the ResNet-26's weights carried across by
utils/interop.py (widths 8, one block a stage, 32 px, embed_dim 3).

Gradients are held to 2e-5 x max(1, max|g|) in f32 (summation order is
all that differs); the guided gradients' zero pattern (the masks) is
held exactly. Where JAX draws from ``jax.random`` (smooth-grad's noise,
the optimizers' start images) the test hands both packages the same
draws. The optimizers' deterministic core is held after three steps
(``recreate_image`` patched to pass the float image through);
``deep_dream``, which draws nothing, end to end at its defaults.
Saliency through the attention-MIL head runs JAX's pool as its own CPU
tests run it (the Pallas kernel in interpret mode) and the port's plain
pool."""

import numpy as np
import pytest
import torch

import conftest  # noqa: F401
import jax
import jax.numpy as jnp

from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu.interpret import (
    gradcam as jgradcam,
    guided as jguided,
    misc as jmisc,
    optimize as joptimize,
    saliency as jsaliency,
)
from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu.models import (
    attention_mil as jamil,
    resnet as jresnet,
)
from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.interpret import (
    gradcam,
    guided,
    misc,
    optimize,
    saliency,
)
from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.models import (
    attention_mil as tamil,
    resnet as tresnet,
)
from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.utils import (
    helpers,
    interop,
)

WIDTHS, BLOCKS, EMBED = (8, 8, 8, 8), (1, 1, 1, 1), 3
TAPS = ("stem", "stage1", "stage2", "stage3", "stage4")


def _close(got, want, tol=2e-5):
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got,
                     np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, (err, scale)


@pytest.fixture(scope="module")
def net():
    jp = jresnet.init_resnet26(jax.random.PRNGKey(0), embed_dim=EMBED,
                               widths=WIDTHS, blocks=BLOCKS)
    jp = jax.tree_util.tree_map(np.asarray, jp)
    model = tresnet.ResNet26(embed_dim=EMBED, widths=WIDTHS, blocks=BLOCKS,
                             device="cpu")
    interop.load_jax_params(model, jp)
    x = np.random.default_rng(0).random((1, 32, 32, 3)).astype(np.float32)
    return jp, model, x


def _japply(p, inp, act_fn=None):
    return jresnet.apply_resnet26(p, inp, act_fn=act_fn)


def test_guided_leaky_relu_matches_jax():
    rng = np.random.default_rng(3)
    x = rng.standard_normal(64).astype(np.float32)
    x[:4] = 0.0                    # the kink: no gradient, forward x
    up = rng.standard_normal(64).astype(np.float32)
    want_y = jguided.guided_leaky_relu(jnp.asarray(x))
    want_g = jax.grad(lambda v: jnp.sum(jguided.guided_leaky_relu(v)
                                        * jnp.asarray(up)))(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    y = guided.guided_leaky_relu(xt)
    (g,) = torch.autograd.grad((y * torch.from_numpy(up)).sum(), xt)
    np.testing.assert_array_equal(y.detach().numpy(), np.asarray(want_y))
    np.testing.assert_array_equal(g.numpy(), np.asarray(want_g))


@pytest.mark.parametrize("target", [0, 2])
def test_vanilla_and_grad_times_image(net, target):
    jp, model, x = net
    jscore = jsaliency.class_score_fn(_japply, jp, target)
    score = saliency.class_score_fn(tresnet.apply_resnet26, model, target)
    xt = torch.from_numpy(x)
    _close(saliency.vanilla_backprop(score, xt),
           jsaliency.vanilla_backprop(jscore, x))
    _close(saliency.grad_times_image(score, xt),
           jsaliency.grad_times_image(jscore, x))


def test_integrated_gradients(net):
    jp, model, x = net
    jscore = jsaliency.class_score_fn(_japply, jp, 1)
    score = saliency.class_score_fn(tresnet.apply_resnet26, model, 1)
    path = saliency.generate_images_on_linear_path(torch.from_numpy(x), 5)
    jpath = jsaliency.generate_images_on_linear_path(jnp.asarray(x), 5)
    for a, b in zip(path, jpath):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    _close(saliency.integrated_gradients(score, torch.from_numpy(x),
                                         steps=12),
           jsaliency.integrated_gradients(jscore, x, steps=12))


def test_smooth_grad_with_the_same_draws(net, monkeypatch):
    jp, model, x = net
    n = 4
    g = torch.Generator().manual_seed(7)
    noise = [torch.randn(x.shape, generator=g).numpy() for _ in range(n)]
    draws = iter(noise)
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape: jnp.asarray(next(draws)))
    jscore = jsaliency.class_score_fn(_japply, jp, 2)
    score = saliency.class_score_fn(tresnet.apply_resnet26, model, 2)
    want = jsaliency.smooth_grad(
        lambda v: jsaliency.vanilla_backprop(jscore, v), x,
        jax.random.PRNGKey(0), param_n=n)
    got = saliency.smooth_grad(
        lambda v: saliency.vanilla_backprop(score, v), torch.from_numpy(x),
        torch.Generator().manual_seed(7), param_n=n)
    _close(got, want)


def _masks_equal(got, want):
    np.testing.assert_array_equal(got.numpy() != 0, np.asarray(want) != 0)


def test_guided_backprop(net):
    jp, model, x = net
    want = jguided.guided_backprop(jp, x, 1)
    got = guided.guided_backprop(model, torch.from_numpy(x), 1)
    _masks_equal(got, want)
    _close(got, want)
    # another model through apply_fn, as JAX's apply_fn
    got2 = guided.guided_backprop(
        model, torch.from_numpy(x), 1,
        apply_fn=lambda m, v, act_fn: tresnet.apply_resnet26(
            m, v, act_fn=act_fn))
    np.testing.assert_array_equal(got2.numpy(), got.numpy())


@pytest.mark.parametrize("layer", ["stem", "stage2", "stage4"])
def test_layer_activation_guided_backprop(net, layer):
    jp, model, x = net
    want = jguided.layer_activation_guided_backprop(jp, x, layer, 3)
    got = guided.layer_activation_guided_backprop(model, torch.from_numpy(x),
                                                  layer, 3)
    _masks_equal(got, want)
    _close(got, want)


def test_act_fn_default_is_leaky_relu(net):
    _, model, x = net
    xt = torch.from_numpy(x)
    with torch.no_grad():
        plain = tresnet.apply_resnet26(model, xt)
        given = tresnet.apply_resnet26(model, xt,
                                       act_fn=guided.guided_leaky_relu)
    np.testing.assert_array_equal(plain.numpy(), given.numpy())


@pytest.mark.parametrize("layer", TAPS)
def test_gradcam_at_every_tap(net, layer):
    jp, model, x = net
    want = jgradcam.gradcam(jp, x, 1, layer)
    got = gradcam.gradcam(model, torch.from_numpy(x), 1, layer)
    assert got.shape == (32, 32)
    _close(got, want)


def test_guided_gradcam(net):
    jp, model, x = net
    want = jgradcam.guided_gradcam(jp, x, 2, "stage3")
    got = gradcam.guided_gradcam(model, torch.from_numpy(x), 2, "stage3")
    _close(got, want)


@pytest.fixture
def float_images(monkeypatch):
    """recreate_image passes the float image through, in both packages."""
    monkeypatch.setattr(jmisc, "recreate_image", np.asarray)
    monkeypatch.setattr(misc, "recreate_image", np.asarray)


def _same_start(monkeypatch, x0):
    """Both packages' start image is ``x0``, whatever range they ask."""
    monkeypatch.setattr(jax.random, "uniform",
                        lambda key, shape, minval=0.0, maxval=1.0:
                        jnp.asarray(x0))
    monkeypatch.setattr(optimize, "_uniform",
                        lambda generator, shape, lo, hi, device:
                        torch.from_numpy(x0))


def _hold_run(got, want):
    (x_g, h_g), (x_w, h_w) = got, want
    _close(x_g, x_w)
    _close(h_g, h_w)
    assert len(h_g) == 3


def test_ascend_cnn_layer_visualization(net, float_images, monkeypatch):
    jp, model, _ = net
    x0 = np.random.default_rng(4).uniform(
        -0.14, 0.14, (1, 32, 32, 3)).astype(np.float32)
    _same_start(monkeypatch, x0)
    _hold_run(optimize.cnn_layer_visualization(model, "stage1", 2, size=32,
                                               steps=3, lr=1.0),
              joptimize.cnn_layer_visualization(jp, "stage1", 2, size=32,
                                                steps=3, lr=1.0))


def test_ascend_inverted_representation(net, float_images, monkeypatch):
    jp, model, x = net
    base = (np.clip((x[0] * 0.5 + 0.5) * 255.0, 0, 255)).astype(np.uint8)
    x0 = 0.1 * np.random.default_rng(5).random((1, 32, 32, 3)).astype(
        np.float32)
    _same_start(monkeypatch, x0)
    _hold_run(optimize.inverted_representation(model, base, "stage2",
                                               steps=3, lr=1e-2),
              joptimize.inverted_representation(jp, base, "stage2", steps=3,
                                                lr=1e-2))


def test_ascend_class_specific_image_generation(net, float_images,
                                                monkeypatch):
    jp, model, _ = net
    x0 = np.random.default_rng(6).uniform(
        -1.0, 1.0, (1, 32, 32, 3)).astype(np.float32)
    _same_start(monkeypatch, x0)
    _hold_run(optimize.class_specific_image_generation(
        model, 2, size=32, steps=3, lr=0.5),
        joptimize.class_specific_image_generation(jp, 2, size=32, steps=3,
                                                  lr=0.5))


def test_ascend_deep_dream(net, float_images):
    jp, model, _ = net
    base = np.random.default_rng(1).integers(0, 256, (32, 32, 3), np.uint8)
    _hold_run(optimize.deep_dream(model, base, "stage3", 1, steps=3),
              joptimize.deep_dream(jp, base, "stage3", 1, steps=3))


def test_deep_dream_end_to_end(net):
    jp, model, _ = net
    base = np.random.default_rng(1).integers(0, 256, (32, 32, 3), np.uint8)
    img, hist = optimize.deep_dream(model, base, "stage3", 1)
    jimg, jhist = joptimize.deep_dream(jp, base, "stage3", 1)
    assert img.dtype == np.uint8 and img.shape == (32, 32, 3)
    assert len(hist) == 50
    _close(hist, jhist)
    np.testing.assert_array_equal(img, jimg)


def test_default_starts_are_device_independent(net):
    _, model, _ = net
    a = optimize._uniform(None, (1, 4, 4, 3), -1.0, 1.0, "cpu")
    b = optimize._uniform(torch.Generator().manual_seed(0), (1, 4, 4, 3),
                          -1.0, 1.0, "cpu")
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert float(a.min()) >= -1.0 and float(a.max()) <= 1.0


@pytest.fixture(scope="module")
def head():
    cfg = jamil.MILConfig(widths=(8, 8, 8, 8), blocks=(1, 1, 1, 1), L=16)
    jp = jax.tree_util.tree_map(
        np.asarray, jamil.init_attention_mil(jax.random.PRNGKey(2), cfg))
    model = tamil.AttentionMIL(tamil.MILConfig(**vars(cfg)), device="cpu")
    interop.load_jax_params(model, jp)
    H = np.random.default_rng(9).standard_normal((40, cfg.L)).astype(
        np.float32)
    return cfg, jp, model, H


def _jhead_score(jp, cfg, c):
    def score(H):
        return jamil.attention_pool(jp, H, cfg, use_pallas_pool=True)[
            "logits"][0, c]
    return score


def _head_score(model, cfg, c):
    tcfg = tamil.MILConfig(**vars(cfg))

    def score(H):
        return tamil.attention_pool(model, H, tcfg)["logits"][0, c]
    return score


@pytest.mark.parametrize("c", [0, 2])
def test_saliency_through_the_head(head, c):
    cfg, jp, model, H = head
    jscore, score = _jhead_score(jp, cfg, c), _head_score(model, cfg, c)
    Ht = torch.from_numpy(H)
    _close(saliency.vanilla_backprop(score, Ht),
           jsaliency.vanilla_backprop(jscore, H))
    _close(saliency.integrated_gradients(score, Ht, steps=5),
           jsaliency.integrated_gradients(jscore, H, steps=5))


def test_misc_helpers_match_jax(tmp_path):
    rng = np.random.default_rng(2)
    g = rng.standard_normal((16, 16, 3))
    for name in ("normalize_01", "convert_to_grayscale", "format_np_output"):
        np.testing.assert_array_equal(getattr(misc, name)(g),
                                      getattr(jmisc, name)(g))
    for a, b in zip(misc.get_positive_negative_saliency(g),
                    jmisc.get_positive_negative_saliency(g)):
        np.testing.assert_array_equal(a, b)
    img = rng.integers(0, 256, (16, 16, 3), np.uint8)
    x = misc.preprocess_image(img)
    np.testing.assert_array_equal(x, jmisc.preprocess_image(img))
    np.testing.assert_array_equal(misc.recreate_image(x),
                                  jmisc.recreate_image(x))
    act = rng.random((16, 16))
    for a, b in zip(misc.apply_colormap_on_image(img, act),
                    jmisc.apply_colormap_on_image(img, act)):
        np.testing.assert_array_equal(a, b)
    ours = misc.save_gradient_images(g, str(tmp_path / "a" / "g.png"))
    theirs = jmisc.save_gradient_images(g, str(tmp_path / "b" / "g.png"))
    assert open(ours, "rb").read() == open(theirs, "rb").read()


def test_colormap_refused_without_matplotlib(monkeypatch):
    monkeypatch.setattr(helpers, "pyplot", lambda: None)
    img = np.zeros((4, 4, 3), np.uint8)
    with pytest.raises(RuntimeError, match="matplotlib"):
        misc.apply_colormap_on_image(img, np.ones((4, 4)))
