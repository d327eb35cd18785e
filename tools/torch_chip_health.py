"""Is the card healthy enough to trust a measurement of the PyTorch port?

The twin of ``tools/chip_health.py``. Three staged probes run in a child
process, each under its own ``--budget`` watchdog, so that a card that
hangs is reported instead of hanging the caller:

  1. device listing        (the CUDA runtime answers)
  2. small-product dispatch (host wall of one 256^2 bf16 ``torch.matmul``
     and its synchronise, median of 20 after warm-up)
  3. chained 4096^3 bf16 products (the marginal TFLOP/s of 32 chained
     products less 16, each chain timed with CUDA events, median of 3)

The probe is ``torch.matmul``: it measures the card, and ports no kernel.
Prints one JSON line (with the card's name and power limit as
``nvidia-smi`` gives them); exit 0 = healthy (marginal >= ``--min-tflops``),
exit 1 = degraded, unreachable, or no card. ``--device cpu`` lists the host
and reports it healthy without the compute probe, as the twin does on a
CPU-only host. Imports nothing of JAX.

    python tools/torch_chip_health.py && python tools/torch_profile_stages.py
"""

import argparse
import json
import multiprocessing as mp
import os
import queue
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))  # repo root, for `python tools/...`

N = 4096
CHAINS = (16, 32)


def _chain_ms(b, n, repeats=3):
    import torch

    def run():
        x = b
        for _ in range(n):
            x = x @ b
        return x

    run()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def probe(q, device):
    """The three stages; each puts ``(stage, value, extra)`` on ``q``."""
    import torch

    t0 = time.perf_counter()
    if device == "cpu":
        q.put(("devices", "cpu", time.perf_counter() - t0))
        q.put(("cpu_host", True, None))
        return
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    torch.zeros(1, device="cuda")
    q.put(("devices", name, time.perf_counter() - t0, count))

    g = torch.Generator(device="cuda").manual_seed(0)
    a = torch.randn((256, 256), generator=g, device="cuda",
                    dtype=torch.bfloat16)
    for _ in range(3):
        torch.matmul(a, a)
    torch.cuda.synchronize()
    walls = []
    for _ in range(20):
        t = time.perf_counter()
        torch.matmul(a, a)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t)
    q.put(("dispatch_ms", statistics.median(walls) * 1e3, None))

    # N(0, 1/N) entries keep the chained products' scale near 1
    b = (torch.randn((N, N), generator=g, device="cuda") / N ** 0.5).to(
        torch.bfloat16)
    ms = {f"c{n}": _chain_ms(b, n) for n in CHAINS}
    dt = (ms["c32"] - ms["c16"]) / 1e3
    marginal = (CHAINS[1] - CHAINS[0]) * 2 * N ** 3 / max(dt, 1e-9) / 1e12
    q.put(("marginal_tflops", marginal, ms))


def build_argparser():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--budget", type=float, default=120.0,
                    help="seconds a stage may take before the probe is "
                         "declared hung")
    ap.add_argument("--min-tflops", type=float, default=200.0,
                    help="marginal bf16 TFLOP/s below which the card is "
                         "reported degraded (H100 SXM data sheet: 989 dense)")
    ap.add_argument("--device", default=None,
                    help="the card unless 'cpu'")
    return ap


def main(argv=None, *, target=probe) -> int:
    """Runs ``target(q, device)`` in a spawned child and returns the exit
    code after printing the JSON line."""
    args = build_argparser().parse_args(argv)
    from tools import torch_measure

    device = torch_measure.resolve(args.device, "torch_chip_health").type
    out = {"healthy": False, "stage": "unreachable",
           **torch_measure.card_record(device)}
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    proc = ctx.Process(target=target, args=(q, device), daemon=True)
    t0 = time.time()
    proc.start()
    deadline = t0 + args.budget
    stages = 0
    while time.time() < deadline and stages < 3:
        try:
            # a short poll, so that a child that died early is seen at once
            item = q.get(timeout=min(2.0, max(0.1, deadline - time.time())))
        except queue.Empty:
            if not proc.is_alive() and q.empty():
                out["probe_exitcode"] = proc.exitcode
                break
            continue
        stages += 1
        deadline = time.time() + args.budget  # each stage its own budget
        name, val, extra = item[:3]
        if name == "devices":
            out.update(stage="listed", device=val, list_secs=round(extra, 2))
            if len(item) > 3:
                out["count"] = item[3]
        elif name == "cpu_host":
            out.update(stage="cpu_host", healthy=True)
            break
        elif name == "dispatch_ms":
            out.update(stage="dispatch", dispatch_ms=round(val, 3))
        elif name == "marginal_tflops":
            out.update(stage="compute", marginal_tflops=round(val, 1),
                       chain_ms={k: round(v, 3) for k, v in extra.items()})
            out["healthy"] = val >= args.min_tflops
    if proc.is_alive():
        proc.kill()
    proc.join(timeout=10)
    out["probe_secs"] = round(time.time() - t0, 1)
    print(json.dumps(out), flush=True)
    q.close()
    q.cancel_join_thread()
    return 0 if out["healthy"] else 1


if __name__ == "__main__":
    rc = main()
    sys.stdout.flush()
    os._exit(rc)
