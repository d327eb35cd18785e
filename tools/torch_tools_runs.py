"""The full card runs of the port's measuring tools, one after another.

Runs, on one card, each tool at the sizes PERF.md reports: the
health probe; the bf16 calibration; the ResNet-26 per-stage profile at
batch 128 and 1024 with the cuDNN stem and the stem kernel; the
training-step decomposition at 500 and 2500 tiles a bag; the StyleGAN's
pieces at 64 px (batch 64) and 512 px (batch 16), f32 and ``--dtype ab``;
the fit sweep at 512 and 1024 px (both dtypes, the ladder 16,8,4,2,1,
``--remat`` and ``--grad_accum 2`` where a plain batch-16 row did not
fit, the batches above 16 up to where the memory ends, and each
configuration ``GAN512_r04.jsonl`` / ``GAN1024_r04.jsonl`` lists), the
smallest out-of-memory batch of each dtype rerun once with
``--mem_history`` to name what holds the memory; the serving sweep on
its default cohort (24 slides x 64 tiles) and on six 2000-tile slides;
the extractor's K x B sweep with both stems; the daemon's ``--io_depth``
A/B on six cold 6000 px slides at roi 1200 and at roi 300; the
mixed-size cohort; the StyleGAN's f32 convergence run at seeds 4 and 5;
and the three EMA configs of the r05 script's twin (under
``<out>/gan_r05``).

Each run's stdout and stderr go to ``<out>/<name>.out`` / ``.err``; a run
that fails does not stop the others, and the runner then exits 1.
``--only PREFIX[,PREFIX]`` runs only the runs whose names start with one
of them (``fit1024`` selects every 1024 px fit run). Imports nothing of
JAX.

    python3 tools/torch_tools_runs.py --out <dir>
"""

import argparse
import json
import os
import subprocess
import sys
import time

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUN_TIMEOUT = 1800.0   # seconds a run may take


def plan():
    """``[(name, tool argv)]`` of the fixed runs, in order."""
    runs = [("health", ["torch_chip_health.py"]),
            ("calibration", ["torch_profile_stages.py",
                             "--device-calibration"])]
    for batch in (128, 1024):
        for stem in ("cudnn", "kernel"):
            runs.append((f"stages_{stem}_b{batch}", [
                "torch_profile_stages.py", "--batch", str(batch), "--stem",
                stem, "--json"]))
    for bag in (500, 2500):
        runs.append((f"train_{bag}", ["torch_profile_stages.py", "--train",
                                      "--tiles-per-bag", str(bag), "--json"]))
    for res, batch in ((64, 64), (512, 16)):
        for dtype in ("f32", "ab"):
            runs.append((f"gan{res}_{dtype}", [
                "torch_profile_gan.py", "--res", str(res), "--batch",
                str(batch), "--dtype", dtype]))
    return runs


def run(name, argv, out):
    """One tool in a subprocess; returns its exit code and JSON rows."""
    cmd = [sys.executable, os.path.join(_ROOT, "tools", argv[0]), *argv[1:]]
    print(f"== {name}: {' '.join(argv)}", file=sys.stderr, flush=True)
    t0 = time.perf_counter()
    with open(os.path.join(out, f"{name}.out"), "w") as fo, \
            open(os.path.join(out, f"{name}.err"), "w") as fe:
        try:
            rc = subprocess.run(cmd, stdout=fo, stderr=fe, cwd=_ROOT,
                                timeout=RUN_TIMEOUT).returncode
        except subprocess.TimeoutExpired:
            rc = 124
    secs = time.perf_counter() - t0
    with open(os.path.join(out, f"{name}.out")) as f:
        rows = [json.loads(ln) for ln in f if ln.startswith("{")]
    print(json.dumps({"run": name, "rc": rc, "seconds": round(secs, 1),
                      "rows": len(rows)}), flush=True)
    return rc, rows


# batches above the ladder's 16, to find where the card's memory ends
UPPER = {512: "64,48,32", 1024: "32,24"}


def r04_configs(res):
    """The (batch, dtype, remat, grad_accum) configurations the JAX sweep
    recorded at ``res`` (``GAN512_r04.jsonl`` / ``GAN1024_r04.jsonl``; their
    configurations only), each once."""
    out, seen = [], set()
    with open(os.path.join(_ROOT, f"GAN{res}_r04.jsonl")) as f:
        for line in f:
            r = json.loads(line)
            key = (r["batch"], r["dtype"], bool(r.get("remat")),
                   int(r.get("grad_accum", 1)))
            if key not in seen:
                seen.add(key)
                out.append({"batch": key[0], "dtype": key[1],
                            "remat": key[2], "grad_accum": key[3]})
    return out


def build_argparser():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", required=True,
                    help="the directory each run's output goes to")
    ap.add_argument("--only", default=None,
                    help="comma-separated prefixes of run names (health, "
                         "calibration, stages, train, gan, fit512, fit1024, "
                         "serve, megabatch, serve_io, serve_hetero, "
                         "gan_seed, gan_r05)")
    return ap


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    only = None if args.only is None else tuple(args.only.split(","))
    failed = []

    def go(name, tool_argv):
        if only is not None and not name.startswith(only):
            return []
        rc, rows = run(name, tool_argv, args.out)
        if rc != 0:
            failed.append(name)
        return rows

    for name, tool_argv in plan():
        go(name, tool_argv)
    for res in (512, 1024):
        name = f"fit{res}"
        tool_argv = ["torch_exp_gan512.py", "--res", str(res)]
        rows = go(name, tool_argv)
        plain16 = [r for r in rows if r.get("batch") == 16]
        if any(not r.get("fit") for r in plain16):
            go(f"{name}_remat", tool_argv + ["--remat"])
            go(f"{name}_accum2", tool_argv + ["--grad_accum", "2"])
        # where the card's memory ends, above the ladder
        rows += go(f"{name}_upper", tool_argv + ["--batches", UPPER[res]])
        # the configurations the JAX sweep lists, each once
        for i, cfg in enumerate(r04_configs(res)):
            go(f"{name}_r04_{i}", [
                "torch_exp_gan512.py", "--probe", "--res", str(res),
                "--batch", str(cfg["batch"]), "--dtype", cfg["dtype"],
                "--grad_accum", str(cfg.get("grad_accum", 1))]
                + (["--remat"] if cfg.get("remat") else []))
        # the smallest batch of each dtype that ran out of memory, again,
        # recording what allocated what it held
        for dtype in ("f32", "bf16"):
            oom = sorted(r["batch"] for r in rows
                         if r.get("oom") and r.get("dtype") == dtype)
            if oom:
                go(f"{name}_oom_{dtype}_b{oom[0]}", [
                    "torch_exp_gan512.py", "--probe", "--res", str(res),
                    "--batch", str(oom[0]), "--dtype", dtype,
                    "--mem_history", "--iters", "1"])
    go("serve64", ["torch_exp_serve.py"])
    go("serve2000", ["torch_exp_serve.py", "--tiles", "2000", "--slides",
                     "6", "--batch", "0"])
    go("megabatch", ["torch_exp_megabatch.py", "--stem", "cudnn,kernel"])
    go("serve_io_roi1200", ["torch_exp_serve_io.py"])
    go("serve_io_roi300", ["torch_exp_serve_io.py", "--roi", "300"])
    go("serve_hetero", ["torch_exp_serve_hetero.py"])
    for seed in (4, 5):
        go(f"gan_seed{seed}", ["torch_gan_convergence_run.py", "--seed",
                               str(seed)])
    go("gan_r05", ["torch_gan_convergence_r05.py", "--out",
                   os.path.join(args.out, "gan_r05")])
    print(json.dumps({"failed": failed}), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
