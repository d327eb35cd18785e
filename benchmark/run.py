"""Run one cell of the port's benchmark (``BENCHMARK.json``) and print its
result as the last line of standard output.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Each run is a new process: it makes its weights and tiles from the seed,
warms up every shape the cell's traffic uses, measures for ``--seconds``
(with ``--trace 1`` under the profiler, reporting the per-layer metrics
instead of the end-to-end ones), then checks what the window produced
against the plain reference. It needs a CUDA card and exits 1 without one,
printing no result. The numbers compared, each beside its limit, are the
last lines of standard error and the last key of the result.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CACHE = os.path.join(HERE, ".cache")
# every build and kernel cache lives at a fixed path inside the checkout
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
os.environ["USE_FLAX"] = "0"
sys.path.insert(0, ROOT)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch

    from benchmark import harness, timing

    cell = harness.load_cell(args.workload)
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell["chips"]:
        print(f"run.py: {args.workload} needs {cell['chips']} CUDA card(s); "
              f"{torch.cuda.device_count()} available", file=sys.stderr)
        return 1
    torch.set_num_threads(4)
    device = torch.device("cuda", 0)
    result, lines, _ = harness.run_cell(
        cell, seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
        device=device, t_start=T_START)
    bad = harness.forbidden_modules()
    if bad:
        print(f"run.py: modules of JAX or the JAX package are loaded: {bad}",
              file=sys.stderr)
        return 1
    print(f"card: {json.dumps(timing.card_record(device))}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
