"""What the port's measuring tools (``tools/torch_*.py``) share: the device
a tool runs on, the card's name and power limit, CUDA-event timing, and a
record of the gated pool's and the uint8 stem's kernel launches.

A tool runs on the card unless its caller asks for the CPU; without a card
it exits 1 naming the missing device, and never carries on on the host.
Imports nothing of JAX.
"""

import contextlib
import statistics
import subprocess
import sys
import time

import torch

PORT = "deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch"


def resolve(device, prog: str, cpu_flag: str = "--device cpu") -> torch.device:
    """The device a tool runs on: the card for ``None`` or ``"cuda"``, the
    host for ``"cpu"``. Asking for the card where there is none prints the
    missing device on stderr and exits 1."""
    if device is None or str(device).startswith("cuda"):
        if not torch.cuda.is_available():
            print(f"{prog}: no CUDA device (the card) is available; pass "
                  f"{cpu_flag} to run on the host", file=sys.stderr,
                  flush=True)
            sys.exit(1)
        return torch.device("cuda", torch.cuda.current_device())
    if str(device) == "cpu":
        return torch.device("cpu")
    raise SystemExit(f"{prog}: unsupported device {device!r}")


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
    name, limit = [s.strip() for s in card_line().split(",", 1)]
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


@contextlib.contextmanager
def kernel_record():
    """Count the launches of the gated pool's forward and backward kernels
    and of the uint8 stem kernels while open (``stem_launches``: the stem
    kernel alone, ``u8_stem_kernel``; ``stem_pool_launches``: the one that
    also pools, ``u8_stem_pool_kernel``, which the ResNet's uint8 entry
    takes in bf16), and the tile counts T the pool
    was launched at. Only launches of the CUDA kernels count (the plain
    versions on CPU tensors do not)."""
    from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.ops import (  # noqa: E501
        gated_pool,
        u8_stem,
    )

    rec = {"pool_launches": 0, "pool_T": set(), "pool_bwd_launches": 0,
           "pool_bwd_T": set(), "stem_launches": 0, "stem_pool_launches": 0}
    real_f, real_b = gated_pool._launch, gated_pool._launch_backward
    stem0, pooled0 = u8_stem.LAUNCHES, u8_stem.POOLED_LAUNCHES

    def fwd(a_raw, *rest):
        out = real_f(a_raw, *rest)
        rec["pool_launches"] += 1
        rec["pool_T"].add(int(a_raw.shape[0]))
        return out

    def bwd(a_raw, *rest):
        out = real_b(a_raw, *rest)
        rec["pool_bwd_launches"] += 1
        rec["pool_bwd_T"].add(int(a_raw.shape[0]))
        return out

    gated_pool._launch, gated_pool._launch_backward = fwd, bwd
    try:
        yield rec
    finally:
        gated_pool._launch, gated_pool._launch_backward = real_f, real_b
        rec["stem_launches"] = u8_stem.LAUNCHES - stem0
        rec["stem_pool_launches"] = u8_stem.POOLED_LAUNCHES - pooled0


def launches_json(rec) -> dict:
    """A :func:`kernel_record` as JSON values (the tile counts sorted)."""
    return {k: sorted(v) if isinstance(v, set) else v for k, v in rec.items()}
