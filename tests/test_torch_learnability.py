"""The port's twin of ``tests/test_learnability.py``: on color-separable
synthetic bags the port's training step (``parallel/steps.py``: a bag's
backward summed over a window, then Adam at the reference's main-stage
lr) must lower the loss and classify held-out bags, by the JAX test's
own assertions: the loss down by more than 0.03 over 200 windows of 3
bags, and at least 10 of 12 fresh bags right. The run is the JAX
test's: its bags (24 tiles of 16 px, one color per class under noise),
its tiny arch's starting weights (``PRNGKey(0)``, carried over by
``utils/interop.py``) and its training draws (each bag's Gumbel scores
and dropout mask, rebuilt from its keys as ``apply_attention_mil`` draws
them), handed to the port's step on the CPU in float32: the port's loss
goes 1.0997 -> 1.0501 with 11 of 12 bags right, the JAX run's 1.0997 ->
1.0433 with 11.

Why the JAX test's weights and draws: the bars are marginal in JAX
itself. 200 windows end in the middle of the break from ln 3, so the
bars measure the starting point and the draws as much as the step. Over
100 starting keys by 5 draw keys (``tools/torch_learnability_sweep.py``
on the CPU), the JAX run meets both bars in 69 of 500 runs (the test's
own pair is one of them); the port from its own seeded init and its own
draws in 79 of 500, and from the JAX init with its own draws in 60 of
500 (paired on the init, its draws move the loss drop by -0.0012 +-
0.0015). The test therefore takes a pair that passes in JAX and hands
it to the port, whose step then follows the JAX run.

The sweep tool's own test runs a few windows of that run in both
packages."""

import numpy as np
import torch

import conftest  # noqa: F401
import jax

from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu.models import (
    attention_mil as jamil,
)
from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.models import (
    attention_mil as amil,
)
from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.parallel import (
    steps,
)
from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.utils import (
    interop,
)

COLORS = {0: (150, 60, 170), 1: (80, 150, 90), 2: (70, 90, 180)}


def _bag(rng, cls, t=24, res=16):
    c = np.array(COLORS[cls], np.float32) / 127.5 - 1
    return torch.from_numpy(c + rng.normal(0, 0.2, (t, res, res, 3))
                            .astype(np.float32))


def test_training_learns_separable_classes():
    rng = np.random.default_rng(0)
    widths = dict(widths=(8, 8, 8, 8), blocks=(1, 1, 1, 1))
    cfg = amil.MILConfig(**widths)
    jp = jax.jit(jamil.init_attention_mil, static_argnums=1)(
        jax.random.PRNGKey(0), jamil.MILConfig(**widths))
    model = interop.load_jax_params(amil.AttentionMIL(cfg, device="cpu"), jp)
    opt = steps.make_optimizer(model)
    grad_fn = steps.make_bag_grad(cfg)
    key = jax.random.PRNGKey(1)
    mask = torch.ones(24)
    kept = max(1, int(24 * cfg.train_tile_fraction))

    losses = []
    for _ in range(200):
        total = 0.0
        for cls in range(3):
            key, k = jax.random.split(key)
            r_sub, r_do = jax.random.split(k)
            scores = torch.from_numpy(np.array(jax.random.gumbel(
                r_sub, (24,))))
            keep = torch.from_numpy(np.array(jax.random.bernoulli(
                r_do, 1.0 - cfg.dropout, (kept, cfg.L))))
            outs = grad_fn(model, _bag(rng, cls), mask, torch.tensor(cls),
                           scores=scores, keep=keep)
            total += float(outs["loss"])
        steps.apply_updates(opt, 2e-4)
        losses.append(total / 3)

    assert losses[-1] < losses[0] - 0.03, (losses[0], losses[-1])

    fwd = steps.make_bag_forward(cfg)
    correct = sum(
        int(fwd(model, _bag(rng, c), mask, torch.tensor(c))["y_pred_hat"])
        == c for c in range(3) for _ in range(4))
    assert correct >= 10, correct  # 12 fresh bags


def test_sweep_tool_runs_one_run_in_both_packages():
    """``tools/torch_learnability_sweep.py``, which measured how marginal
    the bars are: its port run given the JAX run's weights and draws
    follows its JAX run, and the port's own init and draws run too."""
    from tools import torch_learnability_sweep as sweep

    j_first, j_last, _ = sweep.run_jax(0, 1, windows=3)
    p_first, p_last, _ = sweep.run_port(0, 1, jax_weights=True,
                                        jax_draws=True, windows=3)
    np.testing.assert_allclose([p_first, p_last], [j_first, j_last],
                               rtol=1e-5)
    first, last, right = sweep.run_port(0, 1, windows=2)
    assert np.isfinite([first, last]).all() and 0 <= right <= 12
