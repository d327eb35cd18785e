"""How far the StyleGAN's convergence run spreads over training seeds, in
JAX and in the PyTorch port, on the CPU.

Runs JAX's own ``tools/gan_convergence_run.py`` and the port's
``tools/torch_gan_convergence_run.py`` at each of ``--seeds`` with the same
arguments (one ``--width``, or ``--tiny``, that a CPU trains in minutes;
float32), each run in its own interpreter, and prints one JSON line a run
and then, for each trainer, its band distances, their min / median / max
and how many seeds miss the 0.15 bar. The result is a CPU proxy for the
full-width runs on the card.

The JAX tool hard-codes its trainer's seed to 1 and reads ``sys.argv``.
Its run here is its own ``main``, unchanged, with the JAX package's
``train.gan.main`` wrapped so that the one argument that differs is the
seed (:func:`seed_argv`). This is a comparison tool: unlike the port's
tools it imports JAX (in the JAX runs' interpreters only).

Usage:
    python tools/torch_gan_seed_spread.py --width 0.25 --jobs 2
    python tools/torch_gan_seed_spread.py --tiny --epochs 1 --n_images 64 \\
        --batch 16 --seeds 1,2                                  # smoke
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BAR = 0.15  # the tools' criterion on the band distance
JAX_PKG = "deep_convolutional_neural_network_resnet_26_and_attention_network_tpu"


def seed_argv(argv, seed):
    """``argv`` with the value after ``--seed`` replaced by ``seed``."""
    out = list(argv)
    out[out.index("--seed") + 1] = str(seed)
    return out


def jax_child(seed, tool_args):
    """In a JAX run's interpreter: the JAX tool's ``main`` over
    ``tool_args``, its trainer's seed set to ``seed`` (the interpreter's
    ``JAX_PLATFORMS`` puts JAX on the CPU)."""
    import importlib

    sys.path.insert(0, _ROOT)
    gan = importlib.import_module(f"{JAX_PKG}.train.gan")
    real = gan.main

    def main(argv=None, *a, **k):
        return real(seed_argv(argv, seed), *a, **k)

    gan.main = main
    from tools import gan_convergence_run

    sys.argv = ["gan_convergence_run.py", *tool_args]
    return gan_convergence_run.main()


def tool_args(args):
    """The arguments both tools take."""
    out = ["--res", str(args.res), "--n_images", str(args.n_images),
           "--epochs", str(args.epochs), "--batch", str(args.batch)]
    return out + (["--tiny"] if args.tiny else ["--width", str(args.width)])


def command(trainer, seed, args):
    if trainer == "jax":
        return [sys.executable, os.path.abspath(__file__), "--jax-child",
                str(seed), "--", *tool_args(args)]
    return [sys.executable, os.path.join(_ROOT, "tools",
                                         "torch_gan_convergence_run.py"),
            *tool_args(args), "--device", "cpu", "--compute_dtype", "f32",
            "--seed", str(seed)]


def run_one(trainer, seed, args):
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS=str(args.threads))
    proc = subprocess.run(command(trainer, seed, args), capture_output=True,
                          text=True, env=env, cwd=_ROOT)
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
    rec = json.loads(lines[-1]) if lines else {
        "reason": proc.stderr[-2000:]}
    row = {"trainer": trainer, "seed": seed, "rc": proc.returncode,
           "band_dist_generator": rec.get("band_dist_generator"),
           "band_dist_init": rec.get("band_dist_init"),
           "band_dist_g_running": rec.get("band_dist_g_running"),
           "converged": rec.get("converged"),
           "train_wall_secs": rec.get("train_wall_secs"),
           "width_mult": rec.get("width_mult"), "card": "cpu"}
    if "reason" in rec:
        row["reason"] = rec["reason"]
    print(json.dumps(row), flush=True)
    return row


def spread(rows):
    """Each trainer's distances, min / median / max and misses of the bar."""
    out = {}
    for trainer in sorted({r["trainer"] for r in rows}):
        mine = sorted((r for r in rows if r["trainer"] == trainer),
                      key=lambda r: r["seed"])
        d = [r["band_dist_generator"] for r in mine]
        ok = [v for v in d if v is not None]
        out[trainer] = {
            "seeds": [r["seed"] for r in mine], "band_dist_generator": d,
            "min": min(ok) if ok else None,
            "median": statistics.median(ok) if ok else None,
            "max": max(ok) if ok else None,
            "miss_bar": sum(v is None or v >= BAR for v in d)}
    return out


def build_argparser():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", default="1,2,3,4,5")
    ap.add_argument("--trainers", default="jax,port")
    ap.add_argument("--res", type=int, default=8)
    ap.add_argument("--n_images", type=int, default=2048)
    ap.add_argument("--epochs", type=int, default=30)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--width", type=float, default=0.25)
    ap.add_argument("--tiny", action="store_true", help="width_mult 1/16")
    ap.add_argument("--jobs", type=int, default=2,
                    help="runs side by side")
    ap.add_argument("--threads", type=int, default=4,
                    help="OpenMP threads a run (the port's)")
    return ap


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv[:1] == ["--jax-child"]:
        return jax_child(int(argv[1]), argv[3:])
    args = build_argparser().parse_args(argv)
    runs = [(t, int(s)) for t in args.trainers.split(",")
            for s in args.seeds.split(",")]
    with ThreadPoolExecutor(args.jobs) as pool:
        rows = list(pool.map(lambda ts: run_one(*ts, args), runs))
    print(json.dumps({"spread": spread(rows), "bar": BAR,
                      "args": tool_args(args), "card": "cpu"}), flush=True)
    return 0 if all(r["rc"] in (0, 1) for r in rows) else 1


if __name__ == "__main__":
    raise SystemExit(main())
