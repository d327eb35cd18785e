"""Sweep and A/B of the gated pool's forward kernel on one card.

    python3 tools/torch_pool_fwd_sweep.py [--sweep] [--ab PARENT.cu]

Builds ``csrc/gated_pool.cu`` of the port and, for each candidate cut of T
(path (i), one cluster of C = 1, 4, 8 or 16 blocks; path (ii), a
cooperative grid of 512 tiles a block), holds the one-call entry
and one shard of the split pair against the plain version (M 1e-5, A1T
and wROIs 1e-6, the split shard bit-identical to the one-call entry, two
calls bit-identical), then times them with torch.profiler's device
durations (``chip_smoke.device_ms``): the one-call entry and the split
pair, and at ``pool_fwd_partition``'s cut the partials alone and the
finish alone in blocks of 128, 256 and 512 threads, at each T of
``SWEEP_T`` with every candidate (``--sweep``), or at each T of ``AB_T``
with the partition's cut alone. ``--ab PARENT.cu`` builds an earlier
version of the source beside it, whose forward entries take (T, K, O,
range, nblk) with a scratch table of [K, nblk, 1+O] floats (a range of
2048 tiles a block), and times the two in turns (parent, change, change,
parent) at each T of ``AB_T``, the one-call entry and one shard of the
split pair. Prints JSON lines, each with the card's name and power limit;
the last line is ``{"ok": true, ...}``. Exits non-zero without a card or
when a candidate disagrees.
"""

import argparse
import ctypes
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.ops import (  # noqa: E402
    _build,
    gated_pool,
)

K, O = 3, 1
SWEEP_T = (500, 1000, 1200, 1500, 2000, 2500, 3000, 4000, 4500, 5000, 6000,
           8000, 12000, 50000)
# the finish's blocks: one tile a thread
FINISH_TILES = (128, 256, 512)
AB_T = (500, 2000, 5000, 50000)
SPLIT_AB_T = (2000, 50000)
ITERS = 200


def candidates(t):
    """The cuts of ``t`` tiles to sweep: ``(path, blocks, tiles)`` for
    clusters of 1, 4, 8 or 16 blocks of at most 8192 tiles and grids of 512
    tiles a block."""
    out = [("cluster", c, -(-t // c)) for c in (1, 4, 8, 16)
           if (c == 1 or -(-t // c) * (c - 1) < t) and -(-t // c) <= 8192]
    for tiles in (512,):
        blocks = -(-t // tiles)
        if 1 < blocks <= gated_pool.FWD_MAX_GRID:
            out.append(("grid", blocks, -(-t // blocks)))
    return out


class Entries:
    """Raw ctypes calls of one build of the pool's forward entries on
    fixed inputs, at a given cut of T."""

    def __init__(self, lib, args, t, parent=False):
        self.lib, self.t, self.parent = lib, t, parent
        self.args = args
        self.stream = torch.cuda.current_stream().cuda_stream
        dev = args[0].device
        self.m = torch.empty((K, O), device=dev)
        self.a1t = torch.empty((K, t), device=dev)
        self.wrois = torch.empty((K, t), device=dev)
        self.sums = torch.empty((K, 1 + O), device=dev)
        self.rows = torch.empty((max(gated_pool.FWD_MAX_GRID,
                                     -(-t // 2048)) * K * (1 + O),),
                                device=dev)
        for name, n_ptr, n_int in (
                ("gated_pool_forward", 8, 5 if parent else 6),
                ("gated_pool_forward_partials", 6, 5 if parent else 6),
                ("gated_pool_forward_finish", 8, 5)):
            fn = getattr(lib, name)
            fn.argtypes = ([ctypes.c_void_p] * n_ptr
                           + [ctypes.c_int] * n_int + [ctypes.c_void_p])
            fn.restype = ctypes.c_int
        self.ins = [x.data_ptr() for x in args]

    def cut(self, path, blocks, tiles):
        if self.parent:
            nblk = -(-self.t // 2048)
            return (self.t, K, O, 2048, nblk)
        return (self.t, K, O, tiles, blocks, int(path == "grid"))

    def one_call(self, path=None, blocks=None, tiles=None):
        rc = self.lib.gated_pool_forward(
            *self.ins, self.m.data_ptr(), self.a1t.data_ptr(),
            self.wrois.data_ptr(), self.rows.data_ptr(),
            *self.cut(path, blocks, tiles), self.stream)
        if rc:
            raise RuntimeError(f"gated_pool_forward: {rc}")

    def partials(self, path=None, blocks=None, tiles=None):
        rc = self.lib.gated_pool_forward_partials(
            *self.ins, self.sums.data_ptr(), self.rows.data_ptr(),
            *self.cut(path, blocks, tiles), self.stream)
        if rc:
            raise RuntimeError(f"gated_pool_forward_partials: {rc}")

    def finish(self, tiles=None):
        if self.parent:
            ints = (self.t, K, O, 2048, -(-self.t // 2048))
        else:
            tiles = tiles or gated_pool.FWD_FINISH_TILES
            ints = (self.t, K, O, tiles, -(-self.t // tiles))
        rc = self.lib.gated_pool_forward_finish(
            *self.ins, self.sums.data_ptr(), self.m.data_ptr(),
            self.a1t.data_ptr(), self.wrois.data_ptr(), *ints, self.stream)
        if rc:
            raise RuntimeError(f"gated_pool_forward_finish: {rc}")

    def outputs(self):
        torch.cuda.synchronize()
        return [x.clone() for x in (self.m, self.a1t, self.wrois)]


def build_parent(src):
    """nvcc of an earlier gated_pool.cu with the port's flags, into the
    build directory beside the port's own library."""
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    out = os.path.join(_build.BUILD_DIR, "libgated_pool_parent.so")
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", out, src],
                          capture_output=True, text=True, check=False)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for {src}:\n{proc.stdout}"
                           f"{proc.stderr}")
    return ctypes.CDLL(out)


def check(e, cut, want):
    """The one-call entry and one split shard at ``cut`` against the plain
    outputs ``want``: the errors, and whether the split shard and a second
    call are the first call bit for bit."""
    e.one_call(*cut)
    first = e.outputs()
    e.one_call(*cut)
    again = e.outputs()
    e.partials(*cut)
    e.finish()
    split = e.outputs()
    errs = [float((g - w).abs().max()) for g, w in zip(first, want)]
    same = all(torch.equal(a, b) for a, b in zip(first, again))
    split_same = all(torch.equal(a, b) for a, b in zip(first, split))
    ok = (errs[0] <= 1e-5 and errs[1] <= 1e-6 and errs[2] <= 1e-6 and same
          and split_same)
    return {"err_M": errs[0], "err_A1T": errs[1], "err_wROIs": errs[2],
            "repeat_bit_identical": same, "split_bit_identical": split_same,
            "ok": ok}


def times(e, cut, each):
    """Device us per call of the one-call entry and the split pair, and
    with ``each`` of the partials and the finish alone, each with its
    launches a call."""
    out = {}
    fns = [("one_call", lambda: e.one_call(*cut)),
           ("split_pair", lambda: (e.partials(*cut), e.finish()))]
    if each:
        fns += [("partials", lambda: e.partials(*cut))]
        fns += [(f"finish_{n}", lambda n=n: e.finish(n)) for n in FINISH_TILES]
    for name, fn in fns:
        ms, how = cs.device_ms(fn, ITERS, match="gated_pool_")
        out[name] = {"us": 1e3 * ms,
                     "launches_per_call": how.get("launches_per_call"),
                     "source": how["source"]}
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--ab", metavar="PARENT_CU")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("torch_pool_fwd_sweep: no CUDA device")
    card = cs.card_line()
    name, limit = [s.strip() for s in card.split(",", 1)]
    tag = {"card": name, "power_limit": limit}
    lib = _build.load("gated_pool")
    report = cs.ptxas_report(_build.BUILD_LOG.get("gated_pool", ""),
                             "gated_pool_fwd")
    cs.emit({"phase": "ptxas_forward", "kernels": report})
    cs.require_no_spill(report)
    failed = []
    for t in (SWEEP_T if args.sweep else AB_T):
        inputs = cs.pool_inputs(t, K, O, seed=t)
        want = gated_pool.gated_attention_pool_reference(*inputs)
        e = Entries(lib, inputs, t)
        chosen = gated_pool.pool_fwd_partition(t)
        for cut in (candidates(t) if args.sweep else [chosen]):
            row = {"phase": "fwd_sweep", "T": t, "path": cut[0],
                   "blocks": cut[1], "tiles": cut[2],
                   "chosen": cut == chosen, **check(e, cut, want)}
            if row["ok"]:
                row.update(times(e, cut, cut == chosen))
            else:
                failed.append((t, cut))
            cs.emit({**row, **tag})
    if args.ab:
        parent_lib = build_parent(args.ab)
        for t in AB_T:
            inputs = cs.pool_inputs(t, K, O, seed=t)
            new = Entries(lib, inputs, t)
            old = Entries(parent_lib, inputs, t, parent=True)
            cut = gated_pool.pool_fwd_partition(t)
            rows = {"parent": [], "change": []}
            for who, e in (("parent", old), ("change", new), ("change", new),
                           ("parent", old)):
                fns = {"one_call": lambda e=e: e.one_call(*cut)}
                if t in SPLIT_AB_T:
                    fns["split_pair"] = lambda e=e: (e.partials(*cut),
                                                     e.finish())
                rows[who].append({
                    k: 1e3 * cs.device_ms(fn, ITERS, match="gated_pool_")[0]
                    for k, fn in fns.items()})
            cs.emit({"phase": "fwd_ab", "T": t, "cut": cut, **rows, **tag})
    print(card, flush=True)
    cs.emit({"ok": not failed, "failed": failed, **tag})
    if failed:
        sys.exit(1)


if __name__ == "__main__":
    main()
