"""High-resolution WGAN-GP fit sweep of the PyTorch port: where does the
card's memory end?

The twin of ``tools/exp_gan512.py``. For each ``(res, dtype, batch)``
attempt, down the ``--batches`` ladder for each of ``--dtypes``, one
full-width ``d_step`` + ``g_step`` pair of ``<port>/train/gan.py`` (the
WGAN-GP double backward, the fade-in blend alive at alpha 0.5, the style
MLP and the EMA) runs in its OWN interpreter, so that one out-of-memory
attempt cannot leave the allocator's state to the next. The ladder stops
for a dtype at its first batch that fits. ``--remat`` and ``--grad_accum``
probe the trainer's options of those names.

A row has the twin's keys (``fit``, ``imgs_per_sec``, ``step_secs`` (the
median of ``--iters`` d+g pairs, CUDA events), ``compile_secs`` (the wall
of the first pair, which carries cuDNN's plans and the allocator's
growth), ``platform``), the losses of the last pair (which must be
finite), ``peak_mem_gb`` (``torch.cuda.max_memory_allocated``) and the
card's name and power limit. ``torch.OutOfMemoryError`` gives a row with
``"fit": false, "oom": true`` and the memory held when it was raised: the
allocator's active blocks summed by the port's source line that allocated
them (``torch.cuda.memory_snapshot``; with ``--mem_history`` the lines
are recorded, else the sizes only). Any other failure gives a row with
``"oom": false`` and makes the sweep exit 1. No failure is swallowed.

Runs on the card unless ``--device cpu``. Imports nothing of JAX.

Usage:
  python tools/torch_exp_gan512.py                        # 512 px ladder
  python tools/torch_exp_gan512.py --res 1024 --remat     # 1024 with remat
  python tools/torch_exp_gan512.py --probe --res 512 --batch 8 --dtype f32
  python tools/torch_exp_gan512.py --probe --device cpu --res 8 --batch 2
"""

from __future__ import annotations

import argparse
import collections
import json
import math
import os
import statistics
import subprocess
import sys
import time

import torch

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _ROOT)  # repo root, for `python tools/...`

from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.train import (  # noqa: E402,E501
    gan,
)
from tools import torch_measure as TM  # noqa: E402
from tools.torch_profile_gan import ALPHA, CODE, DTYPES, LR, make_nets  # noqa: E402,E501

HOLDERS = 12   # memory holders listed in an out-of-memory row
ATTEMPT_TIMEOUT = 1800.0   # seconds an attempt's interpreter may take


def _site(frames) -> str:
    """The innermost two frames of the port (else of the tools) among an
    allocation's recorded frames."""
    ours = [f for f in frames if TM.PORT in f["filename"]] or [
        f for f in frames if "/tools/" in f["filename"]]
    if not ours:
        return "not recorded (run with --mem_history)"
    return " < ".join(f"{f['filename'].split(TM.PORT + '/')[-1]}:"
                      f"{f['line']} {f['name']}" for f in ours[:2])


def memory_report(top: int = HOLDERS) -> dict:
    """What the card's allocator holds now: totals, and the active blocks
    summed by :func:`_site`, the largest ``top``."""
    snap = torch.cuda.memory._snapshot()
    by_site = collections.Counter()
    blocks = 0
    for seg in snap["segments"]:
        for blk in seg["blocks"]:
            if blk["state"] == "active_allocated":
                by_site[_site(blk.get("frames") or [])] += blk["size"]
                blocks += 1
    return {"allocated_gb": torch.cuda.memory_allocated() / 1e9,
            "reserved_gb": torch.cuda.memory_reserved() / 1e9,
            "max_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
            "active_blocks": blocks,
            "holders_gb": [[s, b / 1e9] for s, b in by_site.most_common(top)]}


def probe(res: int, batch: int, dtype_name: str, remat: bool,
          grad_accum: int = 1, iters: int = 3, device=None,
          mem_history: bool = False) -> dict:
    """One attempt: full-width nets, ``iters`` + 1 d+g pairs on fresh
    images, latents and draws from seeded generators."""
    device = torch.device(device)
    cuda = device.type == "cuda"
    step = int(math.log2(res)) - 2  # 4 px = step 0
    dtype = DTYPES[dtype_name]
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
        if mem_history:
            torch.cuda.memory._record_memory_history(max_entries=200_000)
    gen, disc, g_opt, d_opt, ema = make_nets(1.0, device)
    d_step = gan.make_d_step(step, compute_dtype=dtype, remat=remat,
                             grad_accum=grad_accum)
    g_step = gan.make_g_step(step, compute_dtype=dtype, remat=remat,
                             grad_accum=grad_accum)
    sel = [0] * gen.n_blocks
    g = torch.Generator(device=device).manual_seed(7)

    def run_iter():
        real = torch.randn((batch, 3, res, res), generator=g, device=device)
        zs = torch.randn((1, batch, CODE), generator=g, device=device)
        dd = gan.draw_d(g, disc, batch, step, device)
        dg = gan.draw_g(g, disc, batch, step, device)
        TM.sync(device)
        t0 = time.perf_counter()
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
        aux = d_step(gen, disc, d_opt, real, zs, sel, ALPHA, LR, dd)
        gl = g_step(gen, disc, g_opt, ema, zs, sel, ALPHA, LR, dg)
        if cuda:
            end.record()
            end.synchronize()
            secs = start.elapsed_time(end) / 1e3
        else:
            secs = time.perf_counter() - t0
        return secs, float(aux["disc_loss"]), float(gl)

    try:
        t_c = time.perf_counter()
        run_iter()
        compile_secs = time.perf_counter() - t_c
        runs = [run_iter() for _ in range(iters)]
    except torch.OutOfMemoryError as e:
        # the frames of the traceback still hold the step's tensors here
        if cuda:
            e.memory = memory_report()
        raise
    finally:
        if cuda and mem_history:
            torch.cuda.memory._record_memory_history(enabled=None)
    med = statistics.median(r[0] for r in runs)
    d_loss, g_loss = runs[-1][1:]
    if not (math.isfinite(d_loss) and math.isfinite(g_loss)):
        raise FloatingPointError(f"non-finite losses: disc_loss {d_loss}, "
                                 f"g_loss {g_loss}")
    return {"res": res, "batch": batch, "dtype": dtype_name,
            "remat": remat, "grad_accum": grad_accum, "fit": True,
            "imgs_per_sec": round(batch / med, 3),
            "step_secs": round(med, 4),
            "compile_secs": round(compile_secs, 1),
            "platform": "gpu" if cuda else "cpu",
            "peak_mem_gb": (torch.cuda.max_memory_allocated(device) / 1e9
                            if cuda else None),
            "disc_loss": d_loss, "g_loss": g_loss,
            "conv_tf32": torch.backends.cudnn.allow_tf32, "iters": iters,
            **TM.card_record(device)}


def _failure_row(args, e, oom: bool) -> dict:
    msg = str(e).strip() or type(e).__name__
    row = {"res": args.res, "batch": args.batch, "dtype": args.dtype,
           "remat": args.remat, "grad_accum": args.grad_accum,
           "fit": False, "oom": oom,
           "error": f"{type(e).__name__}: {msg.splitlines()[0][:200]}"}
    if oom and getattr(e, "memory", None) is not None:
        row["memory"] = e.memory
        row["peak_mem_gb"] = e.memory["max_allocated_gb"]
    return row


def build_argparser():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--probe", action="store_true",
                    help="child mode: one (res, batch, dtype) attempt")
    ap.add_argument("--res", type=int, default=512,
                    help="target resolution (power of two, 8..1024)")
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--dtype", default="f32", choices=["f32", "bf16"])
    ap.add_argument("--remat", action="store_true",
                    help="probe the rematerialized (checkpointed) step")
    ap.add_argument("--grad_accum", type=int, default=1,
                    help="probe the gradient-accumulation step "
                         "(batch must divide)")
    ap.add_argument("--batches", default="16,8,4,2,1",
                    help="driver mode: descending ladder per dtype")
    ap.add_argument("--dtypes", default="f32,bf16")
    ap.add_argument("--iters", type=int, default=3,
                    help="timed d+g pairs after the first")
    ap.add_argument("--mem_history", action="store_true",
                    help="record each allocation's source lines, so that "
                         "an out-of-memory row names what holds the memory")
    ap.add_argument("--device", default=None, help="the card unless 'cpu'")
    return ap


def run_probe(args) -> int:
    """Child mode: one attempt, one JSON row. 0 when it fit or ran out of
    memory, 1 on any other failure."""
    device = TM.resolve(args.device, "torch_exp_gan512")
    try:
        row = probe(args.res, args.batch, args.dtype, args.remat,
                    args.grad_accum, args.iters, device, args.mem_history)
    except torch.OutOfMemoryError as e:
        print(json.dumps(_failure_row(args, e, oom=True)), flush=True)
        return 0
    except Exception as e:  # noqa: BLE001 — reported in the row, exit 1
        print(json.dumps(_failure_row(args, e, oom=False)), flush=True)
        raise
    print(json.dumps(row), flush=True)
    return 0


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    if args.probe:
        try:
            return run_probe(args)
        except Exception:  # noqa: BLE001 — its row is printed; exit 1
            import traceback

            traceback.print_exc()
            return 1

    TM.resolve(args.device, "torch_exp_gan512")
    rows = []
    failed = False
    for dtype in args.dtypes.split(","):
        for batch in (int(b) for b in args.batches.split(",")):
            if batch % args.grad_accum:
                print(f"# skip batch {batch}: not divisible by "
                      f"--grad_accum {args.grad_accum}",
                      file=sys.stderr, flush=True)
                continue
            print(f"# probing res {args.res} {dtype} batch {batch} "
                  f"remat={args.remat} accum={args.grad_accum}",
                  file=sys.stderr, flush=True)
            child = [sys.executable, os.path.abspath(__file__), "--probe",
                     "--res", str(args.res), "--batch", str(batch),
                     "--dtype", dtype, "--grad_accum", str(args.grad_accum),
                     "--iters", str(args.iters)]
            if args.remat:
                child.append("--remat")
            if args.mem_history:
                child.append("--mem_history")
            if args.device:
                child += ["--device", args.device]
            try:
                proc = subprocess.run(
                    child, capture_output=True, text=True,
                    timeout=ATTEMPT_TIMEOUT,
                    env=dict(os.environ,
                             PYTHONPATH=_ROOT + os.pathsep
                             + os.environ.get("PYTHONPATH", "")))
                line = next((ln for ln in proc.stdout.splitlines()
                             if ln.startswith("{")), None)
                detail = f"child rc={proc.returncode}: " + \
                    proc.stderr.strip()[-300:]
            except subprocess.TimeoutExpired:
                proc, line = None, None
                detail = f"child exceeded {ATTEMPT_TIMEOUT} s"
            row = json.loads(line) if line else {
                "res": args.res, "batch": batch, "dtype": dtype,
                "remat": args.remat, "grad_accum": args.grad_accum,
                "fit": False, "oom": False}
            if proc is None or proc.returncode != 0:
                row.setdefault("error", detail)
                row["oom"] = False
                failed = True
            rows.append(row)
            print(json.dumps(row), flush=True)
            if row.get("fit"):
                break  # boundary found for this dtype
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
