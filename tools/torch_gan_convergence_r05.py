"""Three EMA variants of the StyleGAN convergence run across two
progressive-growing transitions (8 -> 16 -> 32 px), assembled into one
JSON keyed by config: the twin of ``tools/gan_convergence_r05.sh``.

The configs are the JAX script's, each ``tools/torch_gan_convergence_run.py
--max_res 32`` in its own interpreter:

  * ``decay_0999``: the reference's EMA decay, 30 epochs;
  * ``decay_099``: decay 0.99, 30 epochs;
  * ``ema_warmup_60``: ``--ema_warmup`` at the reference's decay, 60 epochs
    at 10 a resolution (40 settled at 32 px).

Each config's stdout and stderr go to ``<out>/<name>.out`` / ``.err``; the
assembled record (each config's last JSON line, or its error) is printed
and written to ``<out>/gan_convergence_r05.json``. Extra arguments after
``--`` go to every run (``--device cpu --tiny ...`` for a smoke). The
JAX script's record is ``GAN_CONVERGENCE_r05.json``, from a TPU.

Usage:
    python tools/torch_gan_convergence_r05.py --out <dir>          # card
    python tools/torch_gan_convergence_r05.py --out <dir> -- --device cpu \\
        --tiny --n_images 64 --batch 16 --epochs 3 --step_every 1  # smoke

Imports nothing of JAX.
"""

import argparse
import json
import os
import subprocess
import sys

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _ROOT)  # repo root, for `python tools/...`

from tools import torch_measure as TM  # noqa: E402

CONFIGS = (("decay_0999", ["--ema_decay", "0.999"]),
           ("decay_099", ["--ema_decay", "0.99"]),
           ("ema_warmup_60", ["--ema_warmup", "--epochs", "60",
                              "--step_every", "10"]))
RUN_TIMEOUT = 9000   # seconds a config may take (the JAX script's)


def run_config(name, extra, out, common):
    cmd = [sys.executable, os.path.join(_ROOT, "tools",
                                        "torch_gan_convergence_run.py"),
           "--max_res", "32", *extra, *common]
    with open(os.path.join(out, f"{name}.out"), "w") as fo, \
            open(os.path.join(out, f"{name}.err"), "w") as fe:
        try:
            rc = subprocess.run(cmd, stdout=fo, stderr=fe, cwd=_ROOT,
                                timeout=RUN_TIMEOUT).returncode
        except subprocess.TimeoutExpired:
            rc = 124
    with open(os.path.join(out, f"{name}.out")) as f:
        rows = [json.loads(ln) for ln in f if ln.startswith("{")]
    print(json.dumps({"config": name, "rc": rc}), file=sys.stderr, flush=True)
    return rows[-1] if rows else {"error": f"rc={rc}, no record"}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    common = []
    if "--" in argv:
        at = argv.index("--")
        argv, common = argv[:at], argv[at + 1:]
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", required=True,
                    help="the directory each config's output goes to")
    args = ap.parse_args(argv)
    # the runs' device: without a card, exit 1 here and not once a config
    TM.resolve(common[common.index("--device") + 1] if "--device" in common
               else None, "torch_gan_convergence_r05",
               cpu_flag="-- --device cpu")
    os.makedirs(args.out, exist_ok=True)
    record = {name: run_config(name, extra, args.out, common)
              for name, extra in CONFIGS}
    with open(os.path.join(args.out, "gan_convergence_r05.json"), "w") as f:
        json.dump(record, f, indent=1)
    print(json.dumps(record), flush=True)
    return 0 if all("error" not in r for r in record.values()) else 1


if __name__ == "__main__":
    raise SystemExit(main())
