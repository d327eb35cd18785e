"""Bag bucketing, the training bag loader and a background prefetcher.

Counterpart of ``data/loader.py`` in the JAX package: ``bucket_for`` /
``pad_bag`` (pad each bag to a size on a fixed ladder, with a mask),
``prefetch_iter`` (the serving daemon's ``--io_depth`` pipeline),
``BagPrefetcher`` / ``sample_data`` (the trainer's bag loader, with its
stall statistics) and ``epoch_loader_seed``; plus ``staged_chunks``, the
port's host-to-card path for tile stacks, and ``fill``, its copy into a
pinned buffer split across host threads. The model threads the mask
through every tile reduction, so padded execution is numerically the
ragged original. The JAX package pads to keep its compiled-program cache
small; PyTorch runs eagerly, so serving and training here run each bag at
its exact size and do not pad (``BagPrefetcher`` hands out a mask of
ones). The ladder stays the JAX one.
"""

import math
import queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor, wait

import numpy as np
import torch

from ..utils import profiling

DEFAULT_BUCKETS = (32, 64, 128, 256, 512, 1024, 2048, 2560)
# bags the trainer's loader prepares ahead (the JAX package's measured
# depth: 2 stalled its device 21.5 % of a step, 4 measured 0.9 %)
PREFETCH_DEPTH = 4
# a pinned buffer's fill is split into contiguous slices, one a thread of
# torch.get_num_threads(), only where each slice holds at least this many
# bytes: on the H100 hosts slices of 35 MB or more copied faster split,
# those of 4-17 MB as often slower (PERF.md §6: the staging sweep)
FILL_SLICE_MIN_BYTES = 16 << 20

_FILL_POOL = None
_FILL_POOL_LOCK = threading.Lock()


def bucket_for(n: int, buckets=DEFAULT_BUCKETS, multiple_of: int = 1) -> int:
    """Smallest bucket >= n that is a multiple of ``multiple_of`` (the tile
    axis of a mesh, so that a bag splits evenly over its ranks): a ladder
    bucket rounds up to the multiple (32 -> 36 on a tile axis of 6).
    Above the top bucket, sizes round up to a ``lcm(1024, multiple_of)``
    granule instead of the exact count, so bags of any size land on few
    shapes; the waste is bounded at a granule less one tile."""
    for b in buckets:
        if b >= n:
            if b % multiple_of:
                b += multiple_of - b % multiple_of
            return b
    top = buckets[-1]
    if top % multiple_of:
        top += multiple_of - top % multiple_of
    granule = math.lcm(1024, multiple_of)
    return max(top, ((n + granule - 1) // granule) * granule)


def pad_bag(tiles, n_tiles: int | None = None, *, buckets=DEFAULT_BUCKETS,
            multiple_of: int = 1):
    """Pad a [T, ...] tensor with zeros to its bucket (a multiple of
    ``multiple_of``) or to ``n_tiles``; returns (padded, mask [T_b]
    float32), both on the tiles' device."""
    t = tiles.shape[0]
    target = (bucket_for(t, buckets, multiple_of) if n_tiles is None
              else n_tiles)
    if target < t:
        raise ValueError(f"bag of {t} tiles cannot pad to n_tiles={target}")
    mask = torch.zeros(target, dtype=torch.float32, device=tiles.device)
    mask[:t] = 1.0
    if target > t:
        pad = tiles.new_zeros((target - t,) + tuple(tiles.shape[1:]))
        tiles = torch.cat([tiles, pad], dim=0)
    return tiles, mask


def epoch_loader_seed(seed: int, epoch: int) -> int:
    """The bag-order seed of epoch E: a pure function of (seed, E), the JAX
    package's, so a resumed run replays the uninterrupted run's order."""
    return int(np.random.SeedSequence([seed, epoch, 7])
               .generate_state(1)[0] & 0x7FFFFFFF)


def prefetch_iter(iterable, *, depth: int = 2, stats: dict | None = None):
    """Iterate ``iterable`` on a background thread, up to ``depth`` items
    ahead, so the producer's host work overlaps the consumer's device work.

    Items arrive in order. A producer exception re-raises in the consumer.
    When the consumer stops early, the producer stops at its next item,
    closes ``iterable`` and is joined before control returns, so it never
    outlives the loop. ``stats['wait_s']``, when given, adds up the time the
    consumer waited for an item."""
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
        finally:
            close = getattr(iterable, "close", None)
            if close is not None:  # a generator source shuts its pool down
                close()
        put(stop)

    worker = threading.Thread(target=produce, name="prefetch_iter",
                              daemon=True)
    worker.start()
    try:
        while True:
            t0 = time.perf_counter()
            item = q.get()
            if stats is not None:
                stats["wait_s"] += time.perf_counter() - t0
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


class BagPrefetcher:
    """Iterate ``(tiles, mask, label)`` bags with background prefetch.

    ``dataset`` is indexable and returns ``(tiles, label, ...)``; each bag
    keeps its exact tile count with a mask of ones. ``workers > 1`` runs
    that many producer threads (the reference's DataLoader
    ``num_workers``); they deliver out of order, so it requires
    ``shuffle=True``. ``stats`` counts bags, the consumer's waits
    (``wait_s``: the device idle for want of input), the producers' time
    (``produce_s``) and the consumer's wall time (``consume_s``)."""

    def __init__(self, dataset, *, shuffle: bool = False,
                 seed: int | None = None, workers: int = 1):
        if workers > 1 and not shuffle:
            raise ValueError("workers > 1 delivers out of order; eval "
                             "iteration needs order, use shuffle=True")
        self.dataset = dataset
        self.shuffle = shuffle
        self.workers = workers
        self._rng = np.random.default_rng(seed)
        self.stats = {"bags": 0, "wait_s": 0.0, "produce_s": 0.0,
                      "consume_s": 0.0}
        self._iter_t0 = None
        self._stats_lock = threading.Lock()

    def stall_fraction(self) -> float:
        """The share of the consumer's wall time spent waiting for bags;
        valid mid-iteration too."""
        total = self.stats["consume_s"]
        if self._iter_t0 is not None:
            total += time.perf_counter() - self._iter_t0
        return self.stats["wait_s"] / total if total > 0 else 0.0

    def _produce_one(self, idx: int):
        t0 = time.perf_counter()
        item = self.dataset[int(idx)]
        tiles = item[0]
        mask = torch.ones(tiles.shape[0], dtype=torch.float32,
                          device=tiles.device)
        label = int(np.asarray(item[1]).reshape(-1)[0])
        with self._stats_lock:
            self.stats["produce_s"] += time.perf_counter() - t0
        return (tiles, mask, label, *item[2:])

    def __iter__(self):
        order = np.arange(len(self.dataset))
        if self.shuffle:
            self._rng.shuffle(order)
        if self.workers > 1:
            source = _parallel_items(self._produce_one, order, self.workers)
        else:
            source = (self._produce_one(i) for i in order)
        self._iter_t0 = time.perf_counter()
        try:
            for item in prefetch_iter(source, depth=PREFETCH_DEPTH,
                                      stats=self.stats):
                self.stats["bags"] += 1
                yield item
        finally:
            self.stats["consume_s"] += time.perf_counter() - self._iter_t0
            self._iter_t0 = None


def _parallel_items(fn, indices, workers: int):
    """``fn(idx)`` for every index, computed by a pool of ``workers``
    threads and yielded as each finishes (out of order); at most
    ``workers`` are in flight."""
    from concurrent.futures import FIRST_COMPLETED, ThreadPoolExecutor, wait

    with ThreadPoolExecutor(max_workers=workers) as pool:
        pending = set()
        it = iter(indices)
        try:
            while True:
                while len(pending) < workers:
                    try:
                        pending.add(pool.submit(fn, next(it)))
                    except StopIteration:
                        break
                if not pending:
                    return
                done, pending = wait(pending, return_when=FIRST_COMPLETED)
                for fut in done:
                    yield fut.result()
        finally:
            for fut in pending:
                fut.cancel()


def sample_data(dataset, *, image_size: int | None = None,
                shuffle: bool = True, **kwargs):
    """Arm the dataset's transforms at ``image_size`` and return a
    prefetching bag iterator (the reference's
    ``PyTorchHelpers.sample_data``; gbm/classify_combined.py:313,412)."""
    if image_size is not None:
        dataset.NewResolution(image_size)
    return BagPrefetcher(dataset, shuffle=shuffle, **kwargs)


def _fill_pool() -> ThreadPoolExecutor:
    """The module's fill threads, shared by every caller in the process,
    so that concurrent producers do not multiply them: made on first use
    with ``torch.get_num_threads()`` less one (the caller's) threads."""
    global _FILL_POOL
    with _FILL_POOL_LOCK:
        if _FILL_POOL is None:
            _FILL_POOL = ThreadPoolExecutor(
                max_workers=max(1, torch.get_num_threads() - 1),
                thread_name_prefix="stage-fill")
        return _FILL_POOL


def fill_slices(n: int, row_bytes: int) -> list[int]:
    """Row bounds ``[0, ..., n]`` of the contiguous slices a fill of ``n``
    rows of ``row_bytes`` each is split into: one a thread of
    ``torch.get_num_threads()``, as long as each slice holds at least
    ``FILL_SLICE_MIN_BYTES``; ``[0, n]`` (one copy) otherwise."""
    min_rows = max(1, -(-FILL_SLICE_MIN_BYTES // max(1, row_bytes)))
    parts = max(1, min(torch.get_num_threads(), n // min_rows))
    return [n * i // parts for i in range(parts + 1)]


def fill(dst: np.ndarray, src):
    """``np.copyto(dst, src)`` over the first axis, in the slices of
    :func:`fill_slices`: the calling thread copies the first, the fill pool
    the others (``np.copyto`` releases the interpreter lock for uint8
    copies). A split fill adds its rows to the counter
    ``stage.split_tiles``."""
    n = dst.shape[0]
    bounds = fill_slices(n, dst.nbytes // n if n else 0)
    if len(bounds) == 2:
        np.copyto(dst, src)
        return
    pool = _fill_pool()
    futures = [pool.submit(np.copyto, dst[a:b], src[a:b])
               for a, b in zip(bounds[1:-1], bounds[2:])]
    try:
        np.copyto(dst[:bounds[1]], src[:bounds[1]])
    finally:
        wait(futures)
    for f in futures:
        f.result()
    profiling.count("stage.split_tiles", n)


def staged_chunks(raw, chunk: int, device, *, rank: int = 0,
                  ranks: int = 1):
    """Yield ``(start, uint8 chunk on device)`` over the host uint8 tile
    stack ``raw`` (an array or a memory map of the tile cache), in order.

    With ``ranks`` above 1, ``chunk`` (a multiple of ``ranks``) splits into
    ``ranks`` equal shares and only share ``rank`` of each chunk is yielded,
    ``start`` being its first row: rows ``[c + rank * s, c + (rank + 1) *
    s)`` of the chunk at row ``c``, with ``s = chunk // ranks``, cut at the
    end of the stack (a share past it is skipped).

    On CUDA each share is copied into one of two reused pinned host
    buffers (one where there is one share), so that its copy to the card
    is an asynchronous DMA that overlaps the work on the previous one; a
    buffer is refilled only once its last copy to the card has finished. A fresh host array per chunk
    would page-fault on every page it fills, which cost more than the copy
    itself on the H100 host (PERF.md). A buffer's fill is split across
    host threads where the share is large enough (:func:`fill`). On the
    CPU each share is its own copy."""
    if raw.dtype != np.uint8:
        raise TypeError(f"expected a uint8 tile stack, got {raw.dtype}")
    if chunk % ranks:
        raise ValueError(f"a chunk of {chunk} tiles does not split over "
                         f"{ranks} ranks")
    share, T = chunk // ranks, raw.shape[0]
    spans = [(lo, min(T, lo + share))
             for lo in range(rank * share, T, chunk)]
    if device.type != "cuda":
        for lo, hi in spans:
            with profiling.annotate("port.stage.fill"):
                part = torch.from_numpy(np.array(raw[lo:hi])).to(device)
            profiling.count("stage.tiles", hi - lo)
            yield lo, part
        return
    shape = (min(share, T),) + tuple(raw.shape[1:])
    with profiling.annotate("port.stage.pin"):
        bufs = [torch.empty(shape, dtype=torch.uint8, pin_memory=True)
                for _ in range(min(2, len(spans)))]
    copied = [None, None]
    # each span closes before the yield: the caller's work on a chunk is
    # not the staging's
    for i, (lo, hi) in enumerate(spans):
        k, n = i % 2, hi - lo
        if copied[k] is not None:
            with profiling.annotate("port.stage.wait"):
                copied[k].synchronize()
        with profiling.annotate("port.stage.fill"):
            fill(bufs[k].numpy()[:n], raw[lo:hi])
            part = bufs[k][:n].to(device, non_blocking=True)
            copied[k] = torch.cuda.Event()
            copied[k].record(torch.cuda.current_stream(device))
        profiling.count("stage.tiles", n)
        yield lo, part
