"""Bag bucketing and a background prefetcher.

Counterpart of ``data/loader.py`` in the JAX package: ``bucket_for`` /
``pad_bag`` (pad each bag to a size on a fixed ladder, with a mask) and
``prefetch_iter`` (the serving daemon's ``--io_depth`` pipeline); plus
``staged_chunks``, the port's host-to-card path for tile stacks;
``BagPrefetcher`` comes with the training slice. The model threads the
mask through every tile reduction, so padded execution is numerically the
ragged original. The JAX package pads to keep its compiled-program cache
small; PyTorch runs eagerly, so the serving path here runs each bag at its
exact size and does not pad. The ladder stays the JAX one, for the
training slice's bag batching.
"""

import queue
import threading

import numpy as np
import torch

DEFAULT_BUCKETS = (32, 64, 128, 256, 512, 1024, 2048, 2560)


def bucket_for(n: int, buckets=DEFAULT_BUCKETS) -> int:
    """Smallest bucket >= n. Above the top bucket, sizes round up to a
    1024-tile granule instead of the exact count, so bags of any size land
    on few shapes; the waste is bounded at 1023 tiles."""
    for b in buckets:
        if b >= n:
            return b
    return max(buckets[-1], ((n + 1023) // 1024) * 1024)


def pad_bag(tiles, n_tiles: int | None = None, *, buckets=DEFAULT_BUCKETS):
    """Pad a [T, ...] tensor with zeros to its bucket; returns (padded,
    mask [T_b] float32), both on the tiles' device."""
    t = tiles.shape[0]
    target = bucket_for(t, buckets) if n_tiles is None else n_tiles
    if target < t:
        raise ValueError(f"bag of {t} tiles cannot pad to n_tiles={target}")
    mask = torch.zeros(target, dtype=torch.float32, device=tiles.device)
    mask[:t] = 1.0
    if target > t:
        pad = tiles.new_zeros((target - t,) + tuple(tiles.shape[1:]))
        tiles = torch.cat([tiles, pad], dim=0)
    return tiles, mask


def prefetch_iter(iterable, *, depth: int = 2):
    """Iterate ``iterable`` on a background thread, up to ``depth`` items
    ahead, so the producer's host work overlaps the consumer's device work.

    Items arrive in order. A producer exception re-raises in the consumer.
    When the consumer stops early, the producer stops at its next item and
    is joined before control returns, so it never outlives the loop."""
    q: queue.Queue = queue.Queue(maxsize=depth)
    stop = object()
    closed = threading.Event()

    def put(item) -> bool:
        while not closed.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def produce():
        try:
            for item in iterable:
                if not put(item):
                    return
        except Exception as e:  # surfaced in the consumer
            put(e)
            return
        put(stop)

    worker = threading.Thread(target=produce, name="prefetch_iter",
                              daemon=True)
    worker.start()
    try:
        while True:
            item = q.get()
            if item is stop:
                return
            if isinstance(item, Exception):
                raise item
            yield item
    finally:
        closed.set()
        while True:  # unblock a producer waiting on a full queue
            try:
                q.get_nowait()
            except queue.Empty:
                break
        worker.join()


def staged_chunks(raw, chunk: int, device):
    """Yield ``(start, uint8 chunk on device)`` over the host uint8 tile
    stack ``raw`` (an array or a memory map of the tile cache), in order.

    On CUDA each chunk is copied into one of two reused pinned host
    buffers, so that its copy to the card is an asynchronous DMA that
    overlaps the work on the previous chunk; a buffer is refilled only once
    its last copy to the card has finished. A fresh host array per chunk
    would page-fault on every page it fills, which cost more than the copy
    itself on the H100 host (PERF.md). On the CPU each chunk is its
    own copy."""
    if raw.dtype != np.uint8:
        raise TypeError(f"expected a uint8 tile stack, got {raw.dtype}")
    if device.type != "cuda":
        for start in range(0, raw.shape[0], chunk):
            yield start, torch.from_numpy(
                np.array(raw[start:start + chunk])).to(device)
        return
    shape = (min(chunk, raw.shape[0]),) + tuple(raw.shape[1:])
    bufs = [torch.empty(shape, dtype=torch.uint8, pin_memory=True)
            for _ in range(2)]
    copied = [None, None]
    for i, start in enumerate(range(0, raw.shape[0], chunk)):
        k = i % 2
        n = min(chunk, raw.shape[0] - start)
        if copied[k] is not None:
            copied[k].synchronize()
        np.copyto(bufs[k].numpy()[:n], raw[start:start + n])
        part = bufs[k][:n].to(device, non_blocking=True)
        copied[k] = torch.cuda.Event()
        copied[k].record(torch.cuda.current_stream(device))
        yield start, part
