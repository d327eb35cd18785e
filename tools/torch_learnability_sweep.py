"""The learnability run of ``tests/test_learnability.py`` (and of its port
twin, ``tests/test_torch_learnability.py``) over other starting weights
and other training draws, on the CPU, to tell a marginal task from a
fault of one package: the tiny arch (widths 8, blocks 1), color-separable
24-tile 16 px bags, 200 Adam windows of 3 bags at lr 2e-4, then 12 fresh
bags. The bars are the test's: the loss down by more than 0.03, and at
least 10 of 12 bags right.

``--impl jax`` is the JAX test itself, its weights from
``PRNGKey(init)`` and its draws from ``PRNGKey(draws)`` (the test's run
is init 0, draws 1). ``--impl port`` is the port on its own: its seeded
init (``torch.Generator().manual_seed(init)``, as ``train/classify.py``
seeds it) and its own Gumbel and dropout draws from a generator seeded
``draws``. ``--jax_weights`` starts the port from the JAX init at
``PRNGKey(init)`` instead (carried over by ``utils/interop.py``), and
``--jax_draws`` hands it the JAX run's Gumbel scores and dropout masks
from ``PRNGKey(draws)``, as the port's test does; with both, the port
runs the JAX run step for step. The bags are the test's (numpy
``default_rng(0)``) in every run. One JSON line per (init, draws) pair.

Run::

    JAX_PLATFORMS=cpu python tools/torch_learnability_sweep.py \\
        --impl jax --init 0 1 2 --draws 1 2 3
    python tools/torch_learnability_sweep.py --impl port \\
        --init 0 1 2 --draws 1 2 3 [--jax_weights] [--jax_draws]
"""

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

COLORS = {0: (150, 60, 170), 1: (80, 150, 90), 2: (70, 90, 180)}
WIDTHS = dict(widths=(8, 8, 8, 8), blocks=(1, 1, 1, 1))
WINDOWS, LR, T = 200, 2e-4, 24


def _bag(rng, cls, res=16):
    c = np.array(COLORS[cls], np.float32) / 127.5 - 1
    return (c + rng.normal(0, 0.2, (T, res, res, 3))).astype(np.float32)


def run_jax(init: int, draws: int, windows: int = WINDOWS):
    """The JAX test's loop at ``PRNGKey(init)`` / ``PRNGKey(draws)``:
    (first loss, last loss, fresh bags right)."""
    import jax
    import jax.numpy as jnp

    from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu.models import (
        attention_mil as amil,
    )
    from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu.parallel import (
        steps,
    )

    jax.config.update("jax_platforms", "cpu")
    rng = np.random.default_rng(0)
    cfg = amil.MILConfig(**WIDTHS)
    state = steps.init_train_state(
        amil.init_attention_mil(jax.random.PRNGKey(init), cfg))
    grad_fn = steps.make_bag_grad(cfg)
    acc = steps.make_accumulate()
    apply_u = steps.make_apply_updates()
    key = jax.random.PRNGKey(draws)
    ones = jnp.ones((T,))
    losses = []
    for _ in range(windows):
        g = steps.zeros_like_grads(state.params)
        total = 0.0
        for cls in range(3):
            key, k = jax.random.split(key)
            outs, grads = grad_fn(state.params, jnp.asarray(_bag(rng, cls)),
                                  ones, jnp.int32(cls), k)
            g = acc(g, grads)
            total += float(outs["loss"])
        state = apply_u(state, g, jnp.float32(LR))
        losses.append(total / 3)
    fwd = steps.make_bag_forward(cfg)
    right = sum(int(fwd(state.params, jnp.asarray(_bag(rng, c)), ones,
                        jnp.int32(c))["y_pred_hat"]) == c
                for c in range(3) for _ in range(4))
    return losses[0], losses[-1], right


def _jax_draws(draws: int, cfg):
    """The JAX run's per-bag (Gumbel scores, dropout keep mask), drawn
    from its keys as ``apply_attention_mil`` draws them."""
    import jax
    import torch

    key = jax.random.PRNGKey(draws)
    kept = max(1, int(T * cfg.train_tile_fraction))
    while True:
        key, k = jax.random.split(key)
        r_sub, r_do = jax.random.split(k)
        yield {"scores": torch.from_numpy(np.array(
                   jax.random.gumbel(r_sub, (T,)))),
               "keep": torch.from_numpy(np.array(jax.random.bernoulli(
                   r_do, 1.0 - cfg.dropout, (kept, cfg.L))))}


def run_port(init: int, draws: int, jax_weights=False, jax_draws=False,
             windows: int = WINDOWS):
    """The port's twin loop, from its own seeded init and its own draws,
    or from the JAX run's (:func:`build_argparser`)."""
    import torch

    from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.models import (
        attention_mil as amil,
    )
    from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.parallel import (
        steps,
    )

    rng = np.random.default_rng(0)
    cfg = amil.MILConfig(**WIDTHS)
    if jax_weights:
        import jax

        from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu.models import (
            attention_mil as jamil,
        )
        from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.utils import (
            interop,
        )

        jp = jax.jit(jamil.init_attention_mil, static_argnums=1)(
            jax.random.PRNGKey(init), jamil.MILConfig(**WIDTHS))
        model = interop.load_jax_params(
            amil.AttentionMIL(cfg, device="cpu"), jp).train()
    else:
        model = amil.init_attention_mil(torch.Generator().manual_seed(init),
                                        cfg, device="cpu").train()
    opt = steps.make_optimizer(model)
    grad_fn = steps.make_bag_grad(cfg)
    gen = torch.Generator().manual_seed(draws)
    noise = _jax_draws(draws, cfg) if jax_draws else None
    mask = torch.ones(T)
    losses = []
    for _ in range(windows):
        total = 0.0
        for cls in range(3):
            outs = grad_fn(model, torch.from_numpy(_bag(rng, cls)), mask,
                           torch.tensor(cls), gen,
                           **(next(noise) if jax_draws else {}))
            total += float(outs["loss"])
        steps.apply_updates(opt, LR)
        losses.append(total / 3)
    fwd = steps.make_bag_forward(cfg)
    right = sum(int(fwd(model, torch.from_numpy(_bag(rng, c)), mask,
                        torch.tensor(c))["y_pred_hat"]) == c
                for c in range(3) for _ in range(4))
    return losses[0], losses[-1], right


def build_argparser():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--impl", choices=("jax", "port"), required=True)
    p.add_argument("--init", type=int, nargs="+", default=[0])
    p.add_argument("--draws", type=int, nargs="+", default=[1])
    p.add_argument("--windows", type=int, default=WINDOWS)
    p.add_argument("--jax_weights", action="store_true",
                   help="port: start from the JAX init at PRNGKey(init)")
    p.add_argument("--jax_draws", action="store_true",
                   help="port: take the JAX run's draws from "
                        "PRNGKey(draws)")
    return p


def main(argv=None):
    args = build_argparser().parse_args(argv)
    if args.impl == "port":
        import torch

        torch.set_num_threads(1)  # several sweeps side by side
    if args.impl == "jax":
        def run(init, draws):
            return run_jax(init, draws, args.windows)
    else:
        def run(init, draws):
            return run_port(init, draws, args.jax_weights, args.jax_draws,
                            args.windows)
    for init in args.init:
        for draws in args.draws:
            t0 = time.perf_counter()
            first, last, right = run(init, draws)
            print(json.dumps({
                "impl": args.impl, "init": init, "draws": draws,
                "jax_weights": args.jax_weights, "jax_draws": args.jax_draws,
                "loss_first": first, "loss_last": last,
                "drop": first - last, "right_of_12": right,
                "passes": bool(last < first - 0.03 and right >= 10),
                "seconds": time.perf_counter() - t0}), flush=True)


if __name__ == "__main__":
    main()
