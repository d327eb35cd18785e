"""Where does the PyTorch port's StyleGAN WGAN-GP step spend its time?

The twin of ``tools/profile_gan.py``: the generator forward, the critic
forward, the critic's gradient WITHOUT the gradient penalty, the gradient
of the penalty alone (its double backward), the full ``d_step`` and
``g_step`` of ``<port>/train/gan.py``, and microbenchmarks of the ops the
reference writes with custom autograd (blur and the fused up/down
samples) against the plain conv followed by a 2x2 mean, at the shapes the
trainer runs. The modules are ``<port>/models/stylegan.py``'s, initialised
from seeded ``torch.Generator`` s; the random draws (noise planes,
interpolation ``eps``, the critic's dropout masks) are the port's explicit
draws (``gan.draw_d`` / ``draw_g``) from a seeded generator on the device.

Each piece is timed with CUDA events around one call on inputs drawn for
that call, the pieces interleaved round by round, and the median over
``--rounds`` reported (the first call of each piece is a warm-up). The
standalone forward and gradient rows stay float32; ``--dtype`` sets the
compute dtype of the full steps. ``--dtype ab`` interleaves the f32 and
bf16 full steps in one process and also times the d+g pair in one
window, which is what ``tools/exp_gan_bf16.py`` measures: this mode is
that tool's twin as well.

Prints the twin's tables, then one JSON line with the medians, the card's
name and power limit. Runs on the card unless ``--device cpu``. Imports
nothing of JAX.

Run:  python tools/torch_profile_gan.py [--res 64] [--batch 64] [--rounds 3]
"""

import argparse
import copy
import json
import math
import os
import statistics
import sys

import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))  # repo root, for `python tools/...`

from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.models import (  # noqa: E402,E501
    stylegan as sg,
)
from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.train import (  # noqa: E402,E501
    gan,
)
from tools import torch_measure as TM  # noqa: E402

CODE = 512
ALPHA = 0.5
LR = 0.001
DTYPES = {"f32": None, "bf16": torch.bfloat16}


def d_loss_no_gp(disc, real, fake, keep_real, keep_fake, step, alpha=ALPHA):
    """The critic's loss without the penalty: -(E[D(real)] - 0.001
    E[D(real)^2]) + E[D(fake)] (the real and fake terms of
    ``gan.d_loss``)."""
    rp = sg.apply_discriminator(disc, real, step=step, alpha=alpha,
                                keep=keep_real)
    fp = sg.apply_discriminator(disc, fake, step=step, alpha=alpha,
                                keep=keep_fake)
    return -(rp.mean() - 0.001 * (rp ** 2).mean()) + fp.mean()


def gp_only(disc, real, fake, eps, keep_gp, step, alpha=ALPHA):
    """The gradient penalty alone: 10 E[(||grad_x D(x_hat)|| - 1)^2],
    ``x_hat = eps real + (1 - eps) fake``, with its graph for the double
    backward."""
    x_hat = (eps * real + (1 - eps) * fake).detach().requires_grad_(True)
    d_sum = sg.apply_discriminator(disc, x_hat, step=step, alpha=alpha,
                                   keep=keep_gp).sum()
    g, = torch.autograd.grad(d_sum, x_hat, create_graph=True)
    norms = torch.sqrt((g.reshape(g.shape[0], -1) ** 2).sum(dim=1))
    return 10.0 * ((norms - 1.0) ** 2).mean()


def param_grad(loss, params):
    """The gradient of ``loss`` for each of ``params`` (zeros where the
    loss does not reach one)."""
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g
            for p, g in zip(params, grads)]


def make_nets(width, device, seed=0):
    """The generator, the critic, their Adam optimisers and the EMA copy,
    at full structure (``width`` scales the channels)."""
    gen = sg.init_styled_generator(torch.Generator().manual_seed(seed),
                                   width_mult=width, device=device)
    disc = sg.init_discriminator(torch.Generator().manual_seed(seed + 1),
                                 width_mult=width, device=device)
    g_opt, d_opt = gan.make_optimizers(gen, disc)
    ema = copy.deepcopy(gen)
    return gen, disc, g_opt, d_opt, ema


def build_timed(res, width, device, compute_dtype=None):
    """``{name: fn(real, zs, draws_d, draws_g)}`` for the six timed pieces
    at ``res`` px. ``fake`` for the critic pieces is ``real`` flipped
    along its rows, as the twin takes it."""
    step = int(math.log2(res)) - 2
    gen, disc, g_opt, d_opt, ema = make_nets(width, device)
    sel = [0] * gen.n_blocks
    d_step = gan.make_d_step(step, compute_dtype=compute_dtype)
    g_step = gan.make_g_step(step, compute_dtype=compute_dtype)
    d_params = list(disc.parameters())

    def g_fwd(real, zs, dd, dg):
        with torch.no_grad():
            return sg.apply_styled_generator(gen, zs, dg["noise"], step=step,
                                             alpha=ALPHA)

    def d_fwd(real, zs, dd, dg):
        with torch.no_grad():
            return sg.apply_discriminator(disc, real, step=step, alpha=ALPHA,
                                          keep=dd["keep_real"])

    def d_grad_no_gp(real, zs, dd, dg):
        return param_grad(d_loss_no_gp(disc, real, real.flip(2),
                                       dd["keep_real"], dd["keep_fake"],
                                       step), d_params)

    def gp_grad_only(real, zs, dd, dg):
        return param_grad(gp_only(disc, real, real.flip(2), dd["eps"],
                                  dd["keep_gp"], step), d_params)

    def d_step_full(real, zs, dd, dg):
        return d_step(gen, disc, d_opt, real, zs, sel, ALPHA, LR, dd)

    def g_step_full(real, zs, dd, dg):
        return g_step(gen, disc, g_opt, ema, zs, sel, ALPHA, LR, dg)

    return {"fns": {"g_fwd": g_fwd, "d_fwd": d_fwd,
                    "d_grad_no_gp": d_grad_no_gp,
                    "gp_grad_only": gp_grad_only,
                    "d_step_full": d_step_full, "g_step_full": g_step_full},
            "disc": disc, "step": step}


def _event_ms(fn, device):
    """One call of ``fn`` timed with CUDA events (the host clock on the
    CPU)."""
    return TM.time_ms(fn, device, iters=1, repeats=1, warmup=0)


def time_fns(fns, res, batch, rounds, device, disc, step):
    """Median milliseconds of each piece over ``rounds`` interleaved
    rounds; every call gets its own real images, latents and draws, made
    before its timed window."""
    g = torch.Generator(device=device).manual_seed(5)

    def inputs():
        real = torch.randn((batch, 3, res, res), generator=g, device=device)
        zs = torch.randn((1, batch, CODE), generator=g, device=device)
        return (real, zs, gan.draw_d(g, disc, batch, step, device),
                gan.draw_g(g, disc, batch, step, device))

    for name, fn in fns.items():   # warm-up: cuDNN's plans, allocator
        args = inputs()
        fn(*args)
        TM.sync(device)
        print(f"# warmed {name}", file=sys.stderr, flush=True)
    results = {n: [] for n in fns}
    for _ in range(rounds):
        for name, fn in fns.items():
            args = inputs()
            TM.sync(device)
            results[name].append(_event_ms(lambda: fn(*args), device))
    return {n: float(statistics.median(v)) for n, v in results.items()}


def op_modules(res, width, device, seed=0):
    """The microbenchmark's modules at the critic's block for ``res``
    (the twin's ``op_microbench`` shapes): ``(cin, cout, down, plain,
    up)`` with 5x5 kernels, padding 2, weights N(0, 1) and zero biases
    from a seeded generator. ``plain`` is the ``EqualConv2d`` the plain
    path runs before its 2x2 mean."""
    layout, _ = sg._disc_layout(width)
    step = int(math.log2(res)) - 2
    cin, cout = layout[len(layout) - step - 1][:2]
    g = torch.Generator().manual_seed(seed)
    down = sg.FusedDownsample(cin, cout, 5, 2, device=device)
    plain = sg.EqualConv2d(cin, cout, 5, 2, device=device)
    up = sg.FusedUpsample(cin, cin, 5, 2, device=device)
    with torch.no_grad():
        w5 = torch.randn((cout, cin, 5, 5), generator=g)
        down.weight.copy_(w5)
        down.bias.zero_()
        plain.conv.weight_orig.copy_(w5)
        plain.conv.bias.zero_()
        up.weight.copy_(torch.randn((cin, cin, 5, 5), generator=g))
        up.bias.zero_()
    return cin, cout, down, plain, up


def op_fns(down, plain, up):
    """blur, the fused and the plain down, and the fused up, as the twin
    names them."""
    return {"blur": sg.blur, "fused_down": down,
            "plain_down": lambda x: F.avg_pool2d(plain(x), 2),
            "fused_up": up}


def op_microbench(res, batch, width, rounds, device):
    """blur / fused-down vs plain-down at the critic's first-block shape,
    fused-up at the same input; the median ms of each."""
    cin, _, down, plain, up = op_modules(res, width, device)
    fns = op_fns(down, plain, up)
    g = torch.Generator(device=device).manual_seed(999)

    def fresh():
        return torch.randn((batch, cin, res, res), generator=g, device=device)

    out = {n: [] for n in fns}
    with torch.no_grad():
        for fn in fns.values():
            fn(fresh())
        for _ in range(rounds):
            for name, fn in fns.items():
                x = fresh()
                TM.sync(device)
                out[name].append(_event_ms(lambda: fn(x), device))
    return {n: float(statistics.median(v)) for n, v in out.items()}, cin


def build_argparser():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--res", type=int, default=64)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--width", type=float, default=1.0)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--dtype", default="f32", choices=["f32", "bf16", "ab"],
                    help="compute dtype for d_step/g_step (the full-step "
                    "rows only; the standalone fwd/grad rows stay f32). "
                    "'ab' interleaves f32 and bf16 full steps, and the d+g "
                    "pair of each, in ONE process")
    ap.add_argument("--device", default=None, help="the card unless 'cpu'")
    return ap


def run_ab(args, device, card):
    """The interleaved f32 / bf16 full steps and d+g pairs."""
    fns = {}
    disc0 = step = None
    for tag, cdt in (("f32", None), ("bf16", torch.bfloat16)):
        built = build_timed(args.res, args.width, device, compute_dtype=cdt)
        for n in ("d_step_full", "g_step_full"):
            fns[f"{n}_{tag}"] = built["fns"][n]
        d_fn, g_fn = built["fns"]["d_step_full"], built["fns"]["g_step_full"]
        fns[f"pair_{tag}"] = (lambda d_fn, g_fn: lambda *a: (d_fn(*a),
                                                             g_fn(*a)))(
            d_fn, g_fn)
        disc0, step = built["disc"], built["step"]
    times = time_fns(fns, args.res, args.batch, args.rounds, device, disc0,
                     step)
    print(f"\n== interleaved f32 vs bf16 (res {args.res}, batch "
          f"{args.batch}, width x{args.width}, {args.rounds} rounds; "
          f"{card['card']}, {card['power_limit']}) ==")
    for n, ms in times.items():
        print(f"{n:18s} {ms:8.1f} ms")
    ratios = {}
    for n in ("d_step_full", "g_step_full", "pair"):
        ratios[n] = times[f"{n}_bf16"] / times[f"{n}_f32"]
        print(f"{n}: bf16/f32 = {ratios[n]:.3f}x")
    pair = {tag: {"ms": times[f"pair_{tag}"],
                  "imgs_per_sec": args.batch / times[f"pair_{tag}"] * 1e3}
            for tag in ("f32", "bf16")}
    return {"mode": "ab", "times_ms": times, "bf16_over_f32": ratios,
            "pair": pair,
            "bf16_speedup": times["pair_f32"] / times["pair_bf16"]}


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    device = TM.resolve(args.device, "torch_profile_gan")
    card = TM.card_record(device)
    head = {"res": args.res, "batch": args.batch, "width": args.width,
            "rounds": args.rounds, "dtype": args.dtype,
            "conv_tf32": torch.backends.cudnn.allow_tf32,
            "device": device.type, **card}
    if args.dtype == "ab":
        print(json.dumps({**head, **run_ab(args, device, card)}), flush=True)
        return 0

    built = build_timed(args.res, args.width, device,
                        compute_dtype=DTYPES[args.dtype])
    times = time_fns(built["fns"], args.res, args.batch, args.rounds, device,
                     built["disc"], built["step"])
    print(f"\n== per-piece medians (res {args.res}, batch {args.batch}, "
          f"width x{args.width}; {card['card']}, {card['power_limit']}) ==")
    for n, ms in times.items():
        print(f"{n:14s} {ms:8.1f} ms")
    gp_marginal = times["d_step_full"] - times["d_grad_no_gp"]
    print(f"{'gp_marginal':14s} {gp_marginal:8.1f} ms  "
          "(d_step_full - d_grad_no_gp; includes Adam+fake gen)")
    del built
    ops, cin = op_microbench(args.res, args.batch, args.width, args.rounds,
                             device)
    print(f"\n== op microbench ([{args.batch}, {cin}, {args.res}, "
          f"{args.res}]) ==")
    for n, ms in ops.items():
        print(f"{n:14s} {ms:8.2f} ms")
    print(json.dumps({**head, "pieces_ms": times,
                      "gp_marginal_ms": gp_marginal, "ops_ms": ops,
                      "op_shape": [args.batch, cin, args.res, args.res]}),
          flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
