"""How far the gated pool's backward kernel lies from float64, seed by seed.

    python3 tools/torch_pool_bwd_seeds.py [--T 50000] [--seeds 300:400]

For each seed, the inputs ``chip_smoke.py``'s ``check_pool_backward``
draws for a case of that seed (``chip_smoke.pool_backward_case``: K = 3,
O = 1, part of the mask zero, all three cotangents random); the kernel's
backward and the plain version's in float32 on the card, and the plain
version in float64 on the host from the same inputs (the kernel's forward
A1T included). Prints, per seed and output, each float32 result's error
from float64 relative to max|ref| (the scale ``check_pool_backward``
bounds at 1e-5) and, for ``dw``, relative to the size of the terms that
cancel in it (``chip_smoke.pool_bwd_scales``, in float32 epsilons), then
a summary line. ``dw`` sums T terms of both signs: where they cancel, its
float32 error relative to max|dw| grows with the cancellation. Needs the
card; exits 1 without one. Imports nothing of JAX.
"""

import argparse
import json
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.ops import (  # noqa: E402,E501
    gated_pool,
)
from tools import torch_measure as TM  # noqa: E402

NAMES = ("dA_raw", "dB", "dw")


def seed_row(t, seed):
    """One seed's errors from float64."""
    args, a1t, cots = cs.pool_backward_case(t, seed, False, False)
    got = gated_pool.gated_attention_pool_backward(*args, a1t, *cots)
    plain = gated_pool.gated_attention_pool_backward_reference(*args, a1t,
                                                               *cots)
    torch.cuda.synchronize()
    want = gated_pool.gated_attention_pool_backward_reference(
        *[x.double().cpu() for x in args], a1t.double().cpu(),
        *[x.double().cpu() for x in cots])
    scale = float(cs.pool_bwd_scales(*args, a1t, *cots)[2].abs().max())
    row = {"seed": seed}
    for name, g, p, w in zip(NAMES, got, plain, want):
        ref = float(w.abs().max())
        row[name] = {
            "kernel_rel": float((g.double().cpu() - w).abs().max()) / ref,
            "plain_rel": float((p.double().cpu() - w).abs().max()) / ref,
            "kernel_vs_plain_rel": float((g - p).abs().max()) / float(
                p.abs().max())}
    err = float((got[2].double().cpu() - want[2]).abs().max())
    row["dw"]["kernel_eps_of_terms"] = err / (cs.F32_EPS * scale)
    row["dw"]["cancellation"] = scale / float(want[2].abs().max())
    return row


def build_argparser():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--T", type=int, default=50000)
    ap.add_argument("--seeds", default="300:400",
                    help="a range lo:hi of seeds")
    return ap


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_pool_bwd_seeds: no CUDA device (the card) is "
              "available; this tool runs on the card only", file=sys.stderr)
        return 1
    card = TM.card_record("cuda")
    lo, hi = (int(x) for x in args.seeds.split(":"))
    rows = []
    for seed in range(lo, hi):
        row = seed_row(args.T, seed)
        rows.append(row)
        print(json.dumps({"T": args.T, **row}), flush=True)
    dw = [r["dw"] for r in rows]
    print(json.dumps({
        "T": args.T, "seeds": f"{lo}:{hi}", **card,
        "dw_kernel_vs_plain_over_1e-5": sum(
            d["kernel_vs_plain_rel"] > 1e-5 for d in dw),
        "dw_kernel_rel_max": max(d["kernel_rel"] for d in dw),
        "dw_plain_rel_max": max(d["plain_rel"] for d in dw),
        "dw_kernel_eps_of_terms_max": max(d["kernel_eps_of_terms"]
                                          for d in dw),
        "dw_cancellation_max": max(d["cancellation"] for d in dw),
        "dA_raw_kernel_rel_max": max(r["dA_raw"]["kernel_rel"]
                                     for r in rows),
        "dB_kernel_rel_max": max(r["dB"]["kernel_rel"] for r in rows)}),
        flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
