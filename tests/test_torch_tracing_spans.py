"""The port's spans and counters (``utils/profiling.py``) on the CPU, at
tiny sizes: where the hot paths mark their layers under
``profiling.trace``, what the counters count, the counters file beside the
trace, and that with no profiler recording a span or a count does no more
than one check."""

import json
import os
import sys
import threading

import numpy as np
import pytest
import torch

import conftest  # noqa: F401

from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.models import (
    attention_mil as amil,
)
from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.parallel import (
    inference,
    steps,
)
from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.utils import (
    profiling,
)

CFG = amil.MILConfig(widths=(8, 8, 8, 8), blocks=(1, 1, 1, 1))
PX = 32


class _Cache:
    """A tile cache stand-in: the slide's uint8 tiles and coordinates, as
    ``RoiBuilder`` hands its memory map to the streaming loop."""

    def __init__(self, raw):
        self.raw, self.device = raw, torch.device("cpu")
        self.coords = np.stack([np.arange(len(raw)), np.zeros(len(raw),
                                                              np.int64)], 1)
        self.params = {"resolution": PX}

    def update_resolution_and_buffer(self, resolution):
        self.params["resolution"] = resolution

    def _load_cache(self, with_coords=False, mmap=False):
        return (self.raw, self.coords) if with_coords else self.raw


def _model():
    return amil.init_attention_mil(torch.Generator().manual_seed(0), CFG,
                                   device="cpu")


def _tiles(n, seed=0):
    return np.random.default_rng(seed).integers(
        0, 256, (n, PX, PX, 3), dtype=np.uint8)


def _stream(model, n=12, chunk=4):
    return inference.classify_slide_streaming(
        model, CFG, _Cache(_tiles(n)), resolution=PX, chunk=chunk,
        compute_dtype=None)


def _window(model, bags=2, tiles=10):
    step = steps.make_train_step(CFG)
    opt = steps.make_optimizer(model.train())
    gens = [torch.Generator().manual_seed(b) for b in range(bags)]
    x = [torch.rand(tiles, PX, PX, 3) for _ in range(bags)]
    return step(model, opt, x, [torch.ones(tiles)] * bags, [1] * bags, 1e-3,
                generators=gens)


def _traced(tmp_path, fn):
    """``fn()`` under ``profiling.trace``: its ``port.*`` spans ``(start,
    end, name)`` in start order, and the counters file's contents."""
    with profiling.trace(str(tmp_path)):
        fn()
    files = sorted(os.listdir(tmp_path))
    assert [f.split("_")[0] for f in files] == ["counters", "trace"]
    assert files[0][len("counters"):] == files[1][len("trace"):]
    with open(tmp_path / files[1]) as f:
        events = json.load(f)["traceEvents"]
    with open(tmp_path / files[0]) as f:
        counts = json.load(f)
    spans = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                   if e.get("cat") == "user_annotation"
                   and e["name"].startswith("port."))
    return spans, counts


def _inside(span, outer):
    return outer[0] <= span[0] and span[1] <= outer[1]


def _named(spans, name):
    return [s for s in spans if s[2] == name]


@pytest.fixture(autouse=True)
def _fresh_counters():
    profiling.reset_counters()
    yield
    profiling.reset_counters()


def test_streaming_slide_spans_nest_and_count(tmp_path):
    model = _model()
    spans, counts = _traced(tmp_path, lambda: _stream(model, n=12, chunk=4))
    (slide,) = _named(spans, "port.slide")
    extracts = _named(spans, "port.extract")
    fills = _named(spans, "port.stage.fill")
    assert len(extracts) == len(fills) == 3
    for s in spans:
        assert _inside(s, slide), s
    (pool,), (home,) = _named(spans, "port.pool"), _named(spans, "port.home")
    last = max(e[1] for e in extracts)
    assert last <= pool[0] and pool[1] <= home[0]
    # each chunk is staged before it is extracted, never inside it
    for f, e in zip(fills, extracts):
        assert f[1] <= e[0]
    assert counts == {"stage.tiles": 12, "stream.slides": 1}
    assert profiling.counters() == counts


def test_window_step_spans_nest(tmp_path):
    model = _model()
    spans, _ = _traced(tmp_path, lambda: _window(model, bags=2))
    (window,) = _named(spans, "port.window_step")
    bags = _named(spans, "port.bag")
    backs = _named(spans, "port.backward")
    assert len(bags) == len(backs) == 2
    (adam,), (home,) = _named(spans, "port.adam"), _named(spans, "port.home")
    for s in spans:
        assert _inside(s, window), s
    for bag, back in zip(bags, backs):
        assert bag[1] <= back[0]
        for name in ("port.extract", "port.pool"):
            assert sum(_inside(s, bag) for s in _named(spans, name)) == 1
    assert max(b[1] for b in backs) <= adam[0] and adam[1] <= home[0]


def test_no_profiler_no_span_no_count(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) with no profiler")

    monkeypatch.setattr(profiling, "record_function", refuse)
    assert not torch.autograd._profiler_enabled()
    first = profiling.annotate("port.slide")
    assert profiling.annotate("port.pool") is first
    with first:
        with profiling.annotate("port.extract"):
            pass
    profiling.count("stage.tiles", 5)
    model = _model()
    _stream(model)
    _window(model)
    assert profiling.counters() == {}


def test_counts_from_threads_are_not_lost(monkeypatch):
    """``count`` under a profiler from more threads than cores, with the
    interpreter switching threads as often as it can."""
    monkeypatch.setattr(torch.autograd, "_profiler_enabled", lambda: True)
    threads, each = 2 * (os.cpu_count() or 1) + 2, 2000

    def work():
        for _ in range(each):
            profiling.count("stage.tiles", 3)

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        pool = [threading.Thread(target=work) for _ in range(threads)]
        for t in pool:
            t.start()
        for t in pool:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in pool)
    assert profiling.counters() == {"stage.tiles": 3 * each * threads}


def test_counters_are_a_copy_and_reset():
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        profiling.count("stream.slides")
        profiling.count("stream.slides", 2)
    got = profiling.counters()
    assert got == {"stream.slides": 3}
    got["stream.slides"] = 0
    assert profiling.counters() == {"stream.slides": 3}
    profiling.reset_counters()
    assert profiling.counters() == {}
