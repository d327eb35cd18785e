"""One run of one cell: set-up, the measured window, the per-layer reading
of a traced window, and the check of what the window produced against the
plain reference.

A cell of ``BENCHMARK.json`` names a configuration (``configs/<name>.json``,
whose ``architecture`` names the program driver ``programs/<arch>.py`` and
the plain reference ``reference/<arch>.py``) and a traffic mix
(``traffic/<mix>.json``, whose ``mode`` is one of :data:`MODES`); its
limits are ``limits/<cell>.json`` and each per-layer metric's reader is
``metrics/<metric>.py``. Nothing here names a cell, a configuration or a
metric.
"""

import importlib
import importlib.util
import json
import math
import os
import sys
import time
from types import SimpleNamespace

import numpy as np
import torch

from . import compare, generator, tracing
from .generator import Traffic

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
JAX_PACKAGE = ("deep_convolutional_neural_network_resnet_26_and_attention_"
               "network_tpu")
FORBIDDEN = ("jax", "jaxlib", "flax", JAX_PACKAGE)
MODES = ("stream", "onepass", "train")
ADAM_BETA1 = 0.9


def forbidden_modules():
    """The loaded modules whose top-level name, whole, is JAX's or the JAX
    package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def _json(path):
    with open(path) as f:
        return json.load(f)


def load_cell(workload, bench=None):
    """Everything a run of ``workload`` needs, found by name."""
    if bench is None:
        bench = _json(os.path.join(ROOT, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    w = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    lim = os.path.join(HERE, "limits", workload + ".json")

    def here(m):
        return "workloads" not in m or workload in m["workloads"]

    return {
        "name": workload, "chips": w["chips"],
        "config": _json(os.path.join(ROOT, conf["file"])),
        "mix": _json(os.path.join(HERE, "traffic", w["traffic"] + ".json")),
        "limits": _json(lim)["numbers"] if os.path.isfile(lim) else {},
        "end_to_end": [m for m in bench["end_to_end"] if here(m)],
        "per_layer": [m for m in bench["per_layer"] if here(m)],
    }


def program_module(cfg):
    return importlib.import_module(
        f"benchmark.programs.{cfg['architecture']}")


def reference_module(cfg):
    return importlib.import_module(
        f"benchmark.reference.{cfg['architecture']}")


def metric_reader(name):
    """``metrics/<name>.py``'s ``read``."""
    path = os.path.join(HERE, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "benchmark.metrics." + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def make_weights(shapes, seed, device):
    """The weights of ``shapes`` (``reference.param_shapes``), drawn on
    ``device`` from the seed in one call and cut into leaves."""
    gen = torch.Generator(device=device)
    gen.manual_seed(generator.torch_seed(seed, generator.WEIGHTS))
    sizes = {k: math.prod(s) for k, (s, (kind, _)) in shapes.items()
             if kind == "normal"}
    flat = torch.randn(sum(sizes.values()), generator=gen, device=device)
    out, at = {}, 0
    for k, (shape, (kind, val)) in shapes.items():
        if kind == "normal":
            out[k] = (flat[at:at + sizes[k]] * val).reshape(shape)
            at += sizes[k]
        elif kind == "const":
            out[k] = torch.full(shape, float(val), device=device)
        else:
            out[k] = val.to(device).reshape(shape).clone()
    return out


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Run:
    """One run of ``cell`` at ``seed`` on ``device``. ``program_factory``,
    called with the run once its weights and pool exist, puts something
    else in the program's place (the calibration's control)."""

    def __init__(self, cell, seed, device, *, program_factory=None):
        self.cell, self.seed, self.device = cell, int(seed), device
        self.cfg, self.mix = cell["config"], cell["mix"]
        if self.mix["mode"] not in MODES:
            raise ValueError(f"unknown mode {self.mix['mode']!r}")
        self.phases = {}    # set-up seconds by phase
        t = time.perf_counter()
        self.ref = reference_module(self.cfg)
        self.prog_mod = program_module(self.cfg)
        self.weights = make_weights(self.ref.param_shapes(self.cfg),
                                    self.seed, device)
        self.pool = generator.make_pool(self.mix["pool_tiles"],
                                        self.cfg["tile_px"], self.seed,
                                        device)
        self.phases["imports_weights_pool"] = time.perf_counter() - t
        t = time.perf_counter()
        side = int(math.ceil(math.sqrt(self.mix["pool_tiles"])))
        ij = np.arange(self.mix["pool_tiles"], dtype=np.int64)
        self.coords = np.stack([ij // side, ij % side], axis=1)
        self.traffic = Traffic(self.mix, self.cfg, self.seed,
                               self.mix["pool_tiles"])
        self.program = (program_factory(self) if program_factory else
                        self.prog_mod.Program(self.cfg, self.weights, device))
        self.phases["program"] = time.perf_counter() - t
        self.done = []      # (tiles, offset, outputs, seconds) a slide
        self.counts = {"tiles": 0, "flops": 0.0, "pool_fwd_T": [],
                       "pool_bwd_T": []}

    # ------------------------------------------------------------ serving
    def _raw(self, t, offset):
        return self.pool[offset:offset + t]

    def serve_slide(self, t, o):
        """One closed-loop call: the outputs of the slide of ``t`` tiles at
        offset ``o``."""
        raw = self._raw(t, o)
        with tracing.span("slide"):
            if self.mix["mode"] == "stream":
                return self.program.stream(raw, self.coords[:t],
                                           self.mix["chunk"])
            return self.program.onepass(raw)

    def warm(self):
        """Every shape the window will meet, once."""
        mode, p, sizes = self.mix["mode"], self.program, self.traffic.sizes
        if mode == "stream":
            chunk = self.mix["chunk"]
            for n in sorted({t % chunk or chunk for t in sizes}
                            | {min(chunk, min(sizes))}):
                p.warm_stream_chunk(n)
            self.serve_slide(min(sizes), 0)
        elif mode == "onepass":
            self.serve_slide(min(sizes), 0)
            for t in sorted(set(sizes)):
                p.warm_bag(t)
            for n in sorted({t % p.chunk for t in sizes} - {0}):
                p.warm_tiles(n)
        _sync(self.device)

    def serve_window(self, seconds):
        it = self.traffic.slides()
        t0 = time.perf_counter()
        deadline = t0 + seconds
        while True:
            t, o = next(it)
            tp = time.perf_counter()
            out = self.serve_slide(t, o)
            td = time.perf_counter()
            self.done.append((t, o, out, td - tp))
            if td >= deadline:
                break
        return td - t0

    def serve_counts(self, flops_a_tile):
        tiles = sum(t for t, _, _, _ in self.done)
        self.counts.update(tiles=tiles, flops=tiles * flops_a_tile,
                           pool_fwd_T=[t for t, _, _, _ in self.done])

    def serve_check(self):
        """The reference over a sample of the slides the window finished,
        drawn from the seed, the longest among them."""
        rs = generator.rng(self.seed, generator.CHECK)
        n = len(self.done)
        longest = max(range(n), key=lambda i: self.done[i][0])
        rest = [i for i in range(n) if i != longest]
        k = min(self.mix["check"]["slides"] - 1, len(rest))
        picks = [longest] + [rest[i] for i in
                             rs.choice(len(rest), size=k, replace=False)]
        pairs = []
        for i in picks:
            t, o, out, _ = self.done[i]
            pairs.append((out, self.ref.slide(self.weights, self._raw(t, o),
                                              self.cfg)))
        self.check_pairs = pairs
        return compare.serve_numbers(pairs)

    # ----------------------------------------------------------- training
    def train_window_call(self, window):
        raws = [self._raw(self.mix["bag_tiles"], o) for o, _, _ in window]
        with tracing.span("window_step"):
            return self.program.train_window(
                raws, [n for _, n, _ in window], [lb for _, _, lb in window],
                self.mix["lr"], self.mix["pad"])

    def train_prelude(self):
        """The window's first steps, through its own call and feed: their
        losses, the first step's gradient as Adam holds it and the
        parameters' change after the last (host norms)."""
        self.windows = self.traffic.windows()
        self.checked = [next(self.windows)
                        for _ in range(self.mix["reference_steps"])]
        losses, grad = [], None
        for window in self.checked:
            metrics = self.train_window_call(window)
            losses.append(float(metrics["loss"]))
            if grad is None:
                grad = {k: float(torch.linalg.vector_norm(m))
                        / (1 - ADAM_BETA1)
                        for k, m in self.program.first_moments().items()}
        change = {k: float(torch.linalg.vector_norm(p.detach()
                                                    - self.weights[k]))
                  for k, p in self.program.params().items()}
        self.prelude = {"losses": losses, "grad": grad, "change": change}
        _sync(self.device)

    def train_run_window(self, seconds):
        t0 = time.perf_counter()
        deadline = t0 + seconds
        n = 0
        while True:
            self.train_window_call(next(self.windows))
            n += 1
            td = time.perf_counter()
            if td >= deadline:
                break
        T, accum = self.mix["bag_tiles"], self.mix["accum"]
        k = max(1, int(T * self.cfg["train_tile_fraction"]))
        self.counts.update(
            tiles=n * accum * T, windows=n,
            flops=n * accum * k * self.ref.train_tile_flops(self.cfg),
            pool_fwd_T=[k] * (n * accum), pool_bwd_T=[k] * (n * accum))
        return td - t0

    def train_check(self):
        ref = self.ref.train_steps(
            self.weights, self.checked,
            lambda o: self._raw(self.mix["bag_tiles"], o), self.cfg,
            lr=self.mix["lr"], pad=self.mix["pad"])
        return compare.train_numbers(self.prelude, ref)

    # ------------------------------------------------------------- a run
    def setup(self):
        t = time.perf_counter()
        if self.mix["mode"] == "train":
            self.train_prelude()
        else:
            self.warm()
        self.phases["warm"] = time.perf_counter() - t

    def window(self, seconds):
        if self.mix["mode"] == "train":
            return self.train_run_window(seconds)
        return self.serve_window(seconds)

    def check(self):
        if self.mix["mode"] == "train":
            return self.train_check()
        return self.serve_check()

    def free_program(self):
        self.program = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def end_to_end_values(run, window_s, setup_s):
    out = {"setup_s": setup_s}
    tiles = run.counts["tiles"]
    if run.mix["mode"] == "train":
        out["train_tiles_per_s"] = tiles / window_s
    else:
        out["serve_tiles_per_s"] = tiles / window_s
        out["slide_latency_p90_s"] = generator.quantile(
            [s for _, _, _, s in run.done], 90)
    return out


def run_cell(cell, *, seed, seconds, trace, device, t_start,
             program_factory=None):
    """One run: ``(result, lines, numbers)``: the last line's object, the
    lines for standard error (the set-up's phases, every number the check
    computed, then each number compared beside its limit), and those
    numbers."""
    run = Run(cell, seed, device, program_factory=program_factory)
    run.setup()
    _sync(device)
    setup_s = time.perf_counter() - t_start
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    held = {}
    if trace:
        with tracing.traced(device, held):
            with tracing.span("window"):
                window_s = run.window(seconds)
                _sync(device)
    else:
        window_s = run.window(seconds)
        _sync(device)
    if run.mix["mode"] != "train":
        run.serve_counts(run.ref.tile_flops(run.cfg))
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    attempted = (run.counts.get("windows", 0) if run.mix["mode"] == "train"
                 else len(run.done))
    run.free_program()
    numbers = run.check()
    correct, checks = compare.verdict(numbers, cell["limits"])
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    dev = {"platform": "gpu" if device.type == "cuda" else "cpu",
           "kind": name, "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": correct, "attempted": attempted, "failed": 0}
    if trace:
        tr = held["trace"]
        ctx = SimpleNamespace(trace=tr, window_s=window_s, counts=run.counts,
                              cfg=run.cfg, mix=run.mix)
        metrics = {}
        for m in cell["per_layer"]:
            v = metric_reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        dev.update(busy_s=tr.busy_s, window_s=tr.window_s)
        result.update(metrics=metrics, device=dev,
                      breakdown={"device_ops": tr.device_ops(),
                                 "idle_gaps": tr.idle_gaps()})
    else:
        vals = end_to_end_values(run, window_s, setup_s)
        result.update(metrics={m["name"]: {"value": vals[m["name"]],
                                           "unit": m["unit"]}
                               for m in cell["end_to_end"]}, device=dev)
    result["checks"] = checks
    lines = [f"setup phases (s): {json.dumps(run.phases)}",
             f"numbers: {json.dumps(numbers)}"]
    if trace:
        lines.append("pool launches recorded / made: " + json.dumps({
            k: [len(held["trace"].durations(k)), len(run.counts[c])]
            for k, c in (("gated_pool_fwd_kernel", "pool_fwd_T"),
                         ("gated_pool_bwd_kernel", "pool_bwd_T"))}))
    lines += [f"check {k} {c['value']!r} limit {c['limit']!r}"
              for k, c in checks.items()]
    if not checks:
        lines.append("check none: this cell has no limits")
    return result, lines, numbers
