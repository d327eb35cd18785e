"""The port's host-to-card staging (``data/loader.fill``, ``staged_chunks``)
and the chunk ``data/transforms.apply_chunked`` takes by default.

This file imports no JAX, so that its ``card`` test runs on the card's
machine alone: ``python -m pytest --noconftest tests/test_torch_staging.py``.
"""

import os
import sys
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.data import loader as tloader  # noqa: E501
from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.data import transforms as ttransforms  # noqa: E501
from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.utils import profiling  # noqa: E501

TILE = (4, 4, 3)            # 48 bytes a row
MIN_ROWS = 5                # the minimum slice of these tests, in rows


@pytest.fixture
def card():
    """The CUDA card, or a skip where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card on this host")
    return torch.device("cuda", 0)


@pytest.fixture
def threads():
    """Sets ``torch.get_num_threads()`` for the test and restores it."""
    before = torch.get_num_threads()
    yield torch.set_num_threads
    torch.set_num_threads(before)


@pytest.fixture
def min_slice(monkeypatch):
    """A minimum slice of ``MIN_ROWS`` rows."""
    monkeypatch.setattr(tloader, "FILL_SLICE_MIN_BYTES",
                        MIN_ROWS * int(np.prod(TILE)))


def _stack(n, seed):
    return np.random.default_rng(seed).integers(0, 256, (n,) + TILE,
                                                dtype=np.uint8)


@pytest.mark.parametrize("n_threads, rows, parts", [
    (4, 1, 1),                          # one tile
    (2, 2 * MIN_ROWS - 1, 1),           # a slice would be one tile short
    (2, 2 * MIN_ROWS, 2),               # each slice exactly the minimum
    (2, 2 * MIN_ROWS + 1, 2),
    (4, 4 * MIN_ROWS + 3, 4),
    (4, 3 * MIN_ROWS + 4, 3),           # fewer slices than threads
    (8, 40 * MIN_ROWS + 1, 8),
    (1, 40 * MIN_ROWS, 1),              # one thread copies alone
])
def test_fill_lands_every_byte_in_order(min_slice, threads, n_threads, rows,
                                        parts):
    """A fill into the head of a larger buffer (a tail chunk's) copies
    every row to its place and nothing past it, split into the expected
    number of contiguous slices of at least the minimum each."""
    threads(n_threads)
    bounds = tloader.fill_slices(rows, int(np.prod(TILE)))
    assert len(bounds) - 1 == parts
    assert bounds[0] == 0 and bounds[-1] == rows
    if parts > 1:
        assert min(np.diff(bounds)) >= MIN_ROWS
    src = _stack(rows, rows)
    buf = np.full((rows + 3,) + TILE, 7, dtype=np.uint8)
    tloader.fill(buf[:rows], src)
    np.testing.assert_array_equal(buf[:rows], src)
    assert (buf[rows:] == 7).all()


def test_fill_from_many_threads_at_once(min_slice, threads):
    """Callers on more threads than the host has cores share the fill
    pool; each lands its own stack whole, many times over."""
    threads(4)
    callers = max(4, (os.cpu_count() or 1) + 1)
    bad, switch = [], sys.getswitchinterval()

    def caller(i):
        src = _stack(9 * MIN_ROWS + i, 100 + i)
        for _ in range(50):
            dst = np.zeros_like(src)
            tloader.fill(dst, src)
            if not np.array_equal(dst, src):
                bad.append(i)

    sys.setswitchinterval(1e-6)
    try:
        ts = [threading.Thread(target=caller, args=(i,))
              for i in range(callers)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in ts)
    assert bad == []


def test_split_tiles_counts_only_split_fills(min_slice, threads):
    threads(4)
    profiling.reset_counters()
    with profile(activities=[ProfilerActivity.CPU]):
        for rows in (3, 4 * MIN_ROWS, 2 * MIN_ROWS - 1, 2 * MIN_ROWS + 1):
            tloader.fill(np.empty((rows,) + TILE, np.uint8), _stack(rows, 1))
    assert profiling.counters().get("stage.split_tiles") \
        == 4 * MIN_ROWS + 2 * MIN_ROWS + 1
    profiling.reset_counters()


def _train(tiles, seed):
    rng = np.random.default_rng(seed)
    n = tiles.shape[0]
    noise = (torch.from_numpy(rng.integers(0, 9, (n, 2))),
             torch.from_numpy(rng.random(n) < 0.5),
             torch.from_numpy(rng.random(n) < 0.5))
    return dict(fn=ttransforms.train_transform, per_tile=noise,
                roi_size=tiles.shape[1], resolution=12, pad=4)


def _eval(tiles, seed):
    return dict(fn=ttransforms.eval_transform, resolution=12)


@pytest.mark.parametrize("budget_tiles", [None, 150])
@pytest.mark.parametrize("make", [_train, _eval], ids=["train", "eval"])
def test_default_chunk_equals_chunks_of_64(monkeypatch, make, budget_tiles):
    """The transform acts on each tile alone: the default chunk (the whole
    stack here, or 150 tiles under a smaller budget) gives the bits that
    chunks of 64 give."""
    tiles = np.random.default_rng(5).integers(0, 256, (333, 16, 16, 3),
                                              dtype=np.uint8)
    if budget_tiles is not None:
        monkeypatch.setattr(ttransforms, "CHUNK_BYTES",
                            budget_tiles * tiles[0].nbytes)
    assert ttransforms.default_chunk(tiles) == (budget_tiles or 333)
    kw = make(tiles, 6)
    fn = kw.pop("fn")
    got = ttransforms.apply_chunked(fn, tiles, device="cpu", **kw)
    want = ttransforms.apply_chunked(fn, tiles, device="cpu", chunk=64, **kw)
    assert got.shape == (333, 12, 12, 3)
    assert torch.equal(got, want)


def _view(n, px):
    """``n`` tiles of ``px`` pixels, all one tile's memory."""
    return np.broadcast_to(np.zeros((1, px, px, 3), np.uint8),
                           (n, px, px, 3))


@pytest.mark.parametrize("n, px, chunk", [
    (2500, 300, 994),       # 256 MiB of 270,000-byte tiles
    (8192, 128, 5461),      # of 49,152-byte tiles
    (50000, 1200, 64),      # 62 tiles of 4.32 MB: held at the minimum
    (700, 300, 700),        # the whole stack, under the budget
    (40, 1200, 40),         # under the minimum: the whole stack
    (1, 300, 1),
])
def test_default_chunk_follows_the_byte_budget(n, px, chunk):
    assert ttransforms.default_chunk(_view(n, px)) == chunk
    assert chunk == min(n, max(ttransforms.MIN_CHUNK,
                               ttransforms.CHUNK_BYTES // (px * px * 3)))


@pytest.mark.card
@pytest.mark.parametrize("chunks", [3.5, 1], ids=["chunks_and_tail", "one"])
def test_staged_chunks_on_the_card_equal_the_stack(card, chunks):
    """Over a stack of 300 px tiles in several chunks and a tail, or in
    one chunk (one pinned buffer), each large enough to be split over four
    threads, every chunk on the card equals its rows of the stack, and
    every fill was split."""
    before = torch.get_num_threads()
    torch.set_num_threads(4)
    tile = (300, 300, 3)
    rows = 4 * -(-tloader.FILL_SLICE_MIN_BYTES // int(np.prod(tile)))
    raw = np.random.default_rng(3).integers(
        0, 256, (int(chunks * rows),) + tile, dtype=np.uint8)
    profiling.reset_counters()
    seen = 0
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            for start, part in tloader.staged_chunks(raw, rows, card):
                assert part.device.type == "cuda"
                np.testing.assert_array_equal(
                    part.cpu().numpy(), raw[start:start + part.shape[0]])
                seen += part.shape[0]
        counts = profiling.counters()
    finally:
        torch.set_num_threads(before)
        profiling.reset_counters()
    assert seen == raw.shape[0]
    assert counts["stage.tiles"] == raw.shape[0]
    assert counts["stage.split_tiles"] == raw.shape[0]
