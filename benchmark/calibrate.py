"""Readings from which a cell's limits are set (``limits/<cell>.json``): the
numbers of ``compare.py`` for the program on many seeds, for the control
on a few, and for faults planted in the reference put in the program's
place, each seed in one process after the other.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,3 \\
        --seconds 5 --as program|control|fp8|half_batch

``program``: the cell as ``run.py`` runs it, with a window of ``--seconds``.
``control``: the nearest precision below the configuration's in the
program's place: the program's own W8A8 int8 path for a bfloat16 serving
configuration, else the plain reference in bfloat16 (for float32 under
TF32) or in float8 (for bfloat16 training). ``fp8``: the plain reference
in the program's place with its head's products in float8, the control
of a bfloat16 head, which neither of those reaches; its embedder's are
those of ``control``'s reference (bfloat16 under TF32, else float8).
``half_batch``: half of the
work left out and the mean taken over the rest: in training the reference
in the program's place over half of each window's bags; in serving the
program with its gated pool over the first half of each slide's tiles.
Prints one JSON line a seed.
"""

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(HERE, ".cache",
                                                  "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(HERE, ".cache", "triton")


class ReferenceInPlace:
    """The plain reference at precision ``prec`` in the program's place on
    the serving path (the warm-ups do nothing: it compiles nothing)."""

    def __init__(self, ref, cfg, weights, prec, head_prec=None):
        self.ref, self.cfg, self.w, self.prec = ref, cfg, weights, prec
        self.head_prec = head_prec
        self.chunk = 1

    def onepass(self, raw):
        return self.ref.slide(self.w, raw, self.cfg, prec=self.prec,
                              head_prec=self.head_prec)

    def stream(self, raw, coords, chunk):
        return self.onepass(raw)

    def warm_stream_chunk(self, n):
        pass

    def warm_bag(self, n):
        pass

    def warm_tiles(self, n):
        pass


def control(run):
    """The control of the run's configuration, in the program's place."""
    from benchmark import harness

    cfg = run.cfg
    if cfg["precision"] == "bf16":
        return harness.program_module(cfg).Program(
            cfg, run.weights, run.device, int8=True, calib=run.pool[:256])
    return ReferenceInPlace(run.ref, cfg, run.weights, _below(cfg))


def _below(cfg):
    """The reference's precision one step below the configuration's."""
    return "bf16" if cfg["precision"] in ("tf32", "f32") else "fp8"


def head_control(run):
    """The reference in the program's place, its head in float8."""
    return ReferenceInPlace(run.ref, run.cfg, run.weights, _below(run.cfg),
                            head_prec="fp8")


def pool_over_half(pool):
    """``pool`` (``ops/gated_pool.gated_attention_pool``) over the first
    half of each bag's tiles."""
    def half(a_raw, b, mask, weight_mask):
        mask = mask.clone()
        mask[mask.shape[0] // 2:] = 0.0
        return pool(a_raw, b, mask, weight_mask)
    return half


def dump(path, pairs):
    """The sampled slides' outputs, the program's and the reference's, as
    arrays in one ``.npz``."""
    import numpy as np

    arrays = {}
    for i, (p, r) in enumerate(pairs):
        for side, out in (("prog", p), ("ref", r)):
            for k, v in out.items():
                arrays[f"{i}.{side}.{k}"] = np.asarray(v)
    np.savez_compressed(path, **arrays)


def one_seed(cell, seed, seconds, kind, device, dump_dir=None):
    """One seed's numbers with ``kind`` in the program's place."""
    import torch

    from benchmark import compare, harness

    t0 = time.perf_counter()
    mix = cell["mix"]
    train_ref = mix["mode"] == "train" and kind != "program"
    run = harness.Run(cell, seed, device, program_factory=(
        (lambda r: None) if train_ref else
        control if kind == "control" else
        head_control if kind == "fp8" else None))
    if train_ref:
        run.windows = run.traffic.windows()
        run.checked = [next(run.windows)
                       for _ in range(mix["reference_steps"])]

        def steps(windows, prec):
            return run.ref.train_steps(
                run.weights, windows,
                lambda o: run._raw(mix["bag_tiles"], o), run.cfg,
                lr=mix["lr"], pad=mix["pad"], prec=prec)

        prog = (steps(run.checked, "fp8") if kind == "control" else
                steps([w[:len(w) // 2] for w in run.checked], "f32"))
        numbers = compare.train_numbers(prog, steps(run.checked, "f32"))
    else:
        from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.ops import gated_pool  # noqa: E501

        plain = gated_pool.gated_attention_pool
        if kind == "half_batch":
            gated_pool.gated_attention_pool = pool_over_half(plain)
        try:
            run.setup()
            run.window(seconds)
        finally:
            gated_pool.gated_attention_pool = plain
        run.free_program()
        numbers = run.check()
        if dump_dir:
            dump(os.path.join(dump_dir, f"{cell['name']}.{kind}.{seed}.npz"),
                 run.check_pairs)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return {"seed": seed, "as": kind, "numbers": numbers,
            "done": len(run.done) or run.counts.get("windows", 0),
            "seconds": time.perf_counter() - t0}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--as", dest="kind", default="program",
                   choices=("program", "control", "fp8", "half_batch"))
    p.add_argument("--dump", default=None,
                   help="a directory for each serving seed's outputs")
    args = p.parse_args(argv)

    import torch

    from benchmark import harness

    if not torch.cuda.is_available():
        print("calibrate.py: no CUDA card", file=sys.stderr)
        return 1
    cell = harness.load_cell(args.workload)
    device = torch.device("cuda", 0)
    for s in args.seeds.split(","):
        row = one_seed(cell, int(s), args.seconds, args.kind, device,
                       dump_dir=args.dump)
        row["workload"] = args.workload
        print(json.dumps(row), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
