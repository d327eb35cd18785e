"""The mesh programs' collectives as JAX's programs have them, held to the
results of the full ones.

* The bag's metrics on a tile group of four gloo CPU ranks (one launch for
  the module, ``make_mesh(4, slides=1)``): the count crosses once and
  ``KLD``, ``Aterm_mu`` and ``Aterm_var`` come from one detached sum of
  their partials (``models/attention_mil._group_diagnostics``). The bag
  forward on the tiles is held to the JAX package's ``apply_attention_mil``
  on the whole bag within 1e-5 x max(1, |ref|); ``attention_pool`` on
  features is held to the port's one-card pool within 1e-6 relative (on
  features, so that the ResNet's rounding on a share of the tiles, which
  moves the metrics ~1e-6, does not enter; ``Aterm_var``, a mean of
  cosines that cancels, relative to the cosines' scale, 1).
* The StyleGAN's live set on the same four ranks: every rank's backward
  reaches the parameters ``stylegan.generator_live_parameters`` /
  ``critic_live_parameters`` name, and the ranks name the same set.
* The StyleGAN steps on two gloo ranks with the live-only gradient sync
  against the full-tree sync (``torch_mesh_workers.full_tree_sync``: every
  gradient, a missing one as zeros): the parameters after a critic and a generator step bit
  for bit, with and without ``grad_accum``. On two ranks each element's
  sum is one addition, so the two syncs can only differ where the live
  set leaves a gradient out.

The inputs are numpy arrays from a seed; the ranks run
``tests/torch_mesh_workers.py``, which imports no JAX."""

import numpy as np
import pytest
import torch

import conftest  # noqa: F401
import jax
import jax.numpy as jnp
import torch_mesh_workers as W

from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu.models import (
    attention_mil as jamil,
)
from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.models import (
    attention_mil as tamil,
)
from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.models import (
    stylegan as sg,
)
from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.ops import (
    nn as TN,
)
from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.parallel import (
    mesh as TM,
)
from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.utils import (
    interop,
)

TINY = dict(widths=(8, 8, 8, 8), blocks=(1, 1, 1, 1), L=16, D=8)
PX, N = 16, 4
# (T, masked rows, label): T a multiple of the tile axis, and T = 22,
# which the ranks pad with two zero-mask rows
BAGS = ((24, 0, 0), (22, 5, 2), (37, 9, 1))
GAN_WIDTH, GAN_CODE = 1 / 32, 32
# (step, alpha): the fade-in running (the skip branch's layers live), and
# done
GAN_CASES = ((1, 0.7), (1, 1.0), (2, 0.3))
METRICS = ("KLD", "Aterm_mu", "Aterm_var")


@pytest.fixture(scope="module")
def session():
    jcfg = jamil.MILConfig(**TINY)
    jp = jax.jit(jamil.init_attention_mil, static_argnums=1)(
        jax.random.PRNGKey(7), jcfg)
    model = interop.load_jax_params(
        tamil.AttentionMIL(tamil.MILConfig(**TINY), device="cpu"), jp).eval()
    state = {k: v.numpy() for k, v in model.state_dict().items()}
    rng = np.random.default_rng(11)
    bags = []
    for t, masked, label in BAGS:
        tiles = rng.uniform(-1, 1, (t, PX, PX, 3)).astype(np.float32)
        H = rng.normal(size=(t, TINY["L"])).astype(np.float32)
        mask = np.ones(t, np.float32)
        if masked:
            mask[rng.choice(t, masked, replace=False)] = 0.0
        bags.append((tiles, H, mask, label))
    metrics = TM.launch(W.bag_metrics, N, slides=1, devices=["cpu"] * N,
                        args=(TINY, state, bags))
    live = TM.launch(W.gan_live_sets, N, devices=["cpu"] * N,
                     args=(GAN_WIDTH, GAN_CODE, GAN_CASES))
    return jcfg, jp, model, bags, metrics, live


@pytest.mark.parametrize("b", range(len(BAGS)))
def test_fused_metrics_match_jax(session, b):
    jcfg, jp, _, bags, metrics, _ = session
    tiles, _, mask, label = bags[b]
    want = jamil.apply_attention_mil(jp, jnp.asarray(tiles), label, jcfg,
                                     mask=jnp.asarray(mask))
    for rank in metrics:
        got = rank[b]["bag"]
        for key in METRICS:
            ref = float(want[key])
            assert abs(float(got[key]) - ref) <= 1e-5 * max(1.0, abs(ref)), \
                key
        np.testing.assert_allclose(got["y_pred"], np.asarray(want["y_pred"]),
                                   atol=1e-5)


@pytest.mark.parametrize("b", range(len(BAGS)))
def test_fused_metrics_match_one_card(session, b):
    _, _, model, bags, metrics, _ = session
    _, H, mask, _ = bags[b]
    H, mask = torch.from_numpy(H), torch.from_numpy(mask)
    with torch.no_grad():
        want = tamil.attention_pool(model, H, model.cfg, mask=mask)
        want["KLD"] = 0.5 * TN.masked_mean((H ** 2).mean(dim=1), mask)
    for rank in metrics:
        for key in METRICS:
            ref = float(want[key])
            # relative to the value; Aterm_var is a mean of cosines of
            # either sign, each at most 1, whose sum cancels: relative to
            # that scale
            scale = 1.0 if key == "Aterm_var" else abs(ref)
            assert abs(float(rank[b]["pool"][key]) - ref) <= 1e-6 * scale, \
                key
            # the ranks hold one sum
            assert rank[b]["pool"][key] == metrics[0][b]["pool"][key]


@pytest.mark.parametrize("case", range(len(GAN_CASES)))
def test_gan_live_set_agrees_across_four_ranks(session, case):
    """Each step's live set is what every rank's backward reached, the
    same on all four ranks; it leaves layers out (the resolutions above
    the step), and holds the skip branch's layer while alpha fades in."""
    live = session[-1]
    step, alpha = GAN_CASES[case]
    d_live, g_live = live[0][case][0][1], live[0][case][1][1]
    for rank in live:
        (d_reached, d_set), (g_reached, g_set) = rank[case]
        assert d_reached == sorted(d_set) and d_set == d_live
        assert g_reached == sorted(g_set) and g_set == g_live
    gen = sg.StyledGenerator(GAN_CODE, 8, GAN_WIDTH, device="meta")
    disc = sg.Discriminator(GAN_WIDTH, device="meta")
    assert 0 < len(g_live) < len(list(gen.parameters()))
    assert 0 < len(d_live) < len(list(disc.parameters()))
    fading = alpha < 1.0
    assert (f"generator.generator.to_rgb.{step - 1}.conv.weight_orig"
            in g_live) == fading
    index = disc.n_blocks - step
    assert (f"discriminator.from_rgb.{index}.0.conv.weight_orig"
            in d_live) == fading


@pytest.mark.parametrize("alpha,accum", [(0.7, 1), (1.0, 2)])
def test_live_sync_is_the_full_tree_sync_on_two_ranks(alpha, accum):
    rng = np.random.default_rng(4)
    step, B = 1, 8
    real = rng.uniform(-1, 1, (B, 3, 8, 8)).astype(np.float32)
    zs = rng.standard_normal((1, B, GAN_CODE)).astype(np.float32)
    ranks = TM.launch(W.gan_sync_ab, 2, devices=["cpu"] * 2,
                      args=(GAN_WIDTH, GAN_CODE, step, [(alpha, accum)],
                            real, zs))
    for rank in ranks:
        pair = rank[0]
        assert sorted(pair["live"]) == sorted(pair["full"])
        for name, v in pair["full"].items():
            np.testing.assert_array_equal(pair["live"][name], v, name)
    for name, v in ranks[0][0]["live"].items():
        np.testing.assert_array_equal(ranks[1][0]["live"][name], v, name)
