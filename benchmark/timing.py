"""The card's record and CUDA-event timing: frozen copies of the port's
measuring helpers (``tools/torch_measure.card_record``, ``time_ms``)."""

import statistics
import subprocess
import time

import torch


def card_line() -> str:
    """``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` of
    card 0."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def card_record(device) -> dict:
    """``{"card": name, "power_limit": limit}`` as nvidia-smi gives them on
    the card; on the host ``{"card": "cpu", "power_limit": None}``."""
    if torch.device(device).type != "cuda":
        return {"card": "cpu", "power_limit": None}
    try:
        name, limit = [s.strip() for s in card_line().split(",", 1)]
    except (OSError, subprocess.SubprocessError, ValueError):
        return {"card": torch.cuda.get_device_name(device),
                "power_limit": None}
    return {"card": name, "power_limit": limit}


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def time_ms(fn, device, *, iters: int = 1, repeats: int = 3,
            warmup: int = 1) -> float:
    """Median over ``repeats`` of the milliseconds a call of ``fn`` takes:
    on the card CUDA events around ``iters`` calls after ``warmup`` calls,
    on the host the host clock around them."""
    for _ in range(warmup):
        fn()
    sync(device)
    cuda = torch.device(device).type == "cuda"
    times = []
    for _ in range(repeats):
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / iters)
        else:
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            times.append((time.perf_counter() - t0) * 1e3 / iters)
    return float(statistics.median(times))
