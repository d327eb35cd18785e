"""The readers of the port's spans and counters (``benchmark/spans.py``) on
hand-built traces whose idle time, spans and counters are known; and, on
the card, that the spans share the device records' clock."""

import json
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from benchmark import harness, readers, spans
from benchmark.tracing import DeviceTrace
from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.models import attention_mil as amil  # noqa: E501
from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.parallel import inference  # noqa: E501
from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.utils import profiling  # noqa: E501

TID = 7


def _x(name, a, b, cat="user_annotation", tid=TID):
    return {"ph": "X", "name": name, "cat": cat, "ts": a, "dur": b - a,
            "tid": tid}


def _trace(busy, host):
    """A window of 0-1000 us: device kernels over ``busy``, the main
    thread's spans ``host`` ``(name, start, end)``."""
    events = [_x("bench.window", 0, 1000)]
    events += [_x("k", a, b, cat="kernel", tid=99) for a, b in busy]
    events += [_x(n, a, b) for n, a, b in host]
    return SimpleNamespace(trace=DeviceTrace(events))


# idle 100-300 and 400-700 (500 us of 1000); the spans cover all of it but
# 680-685 and 695-700, and the copy home at 685-695 is no streamed slide's
SERVE = _trace([(0, 100), (300, 400), (700, 1000)], [
    ("bench.slide", 40, 990), ("port.slide", 50, 680),
    ("port.stage.pin", 60, 100), ("port.stage.fill", 120, 200),
    ("port.extract", 200, 350), ("aten::conv2d", 210, 260),
    ("port.stage.fill", 350, 380), ("port.pool", 420, 500),
    ("port.home", 500, 650), ("port.home", 685, 695)])
# idle 100-600 (500 us): staging 100-200, the step's bag 200-300 (its
# extract 220-260, and a fill of its own 270-290 that counts as staging),
# backward 300-350, Adam 350-400, copy home 400-450; the step's own time
# 450-500 and 500-600 under no span
TRAIN = _trace([(0, 100), (600, 1000)], [
    ("bench.window_step", 20, 980), ("port.stage.fill", 100, 200),
    ("port.window_step", 200, 500), ("port.bag", 200, 300),
    ("port.extract", 220, 260), ("port.stage.fill", 270, 290),
    ("port.backward", 300, 350), ("port.adam", 350, 400),
    ("port.home", 400, 450)])


@pytest.fixture
def counted():
    """The port's counters as a traced window leaves them: 2000 tiles
    staged, 2 slides streamed."""
    profiling.reset_counters()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        profiling.count("stage.tiles", 2000)
        profiling.count("stream.slides", 2)
    yield
    profiling.reset_counters()


def test_idle_goes_to_the_innermost_span():
    by = spans.idle_by_chain(SERVE.trace)
    want = {("port.slide",): 70e-6, ("port.slide", "port.stage.fill"): 80e-6,
            ("port.slide", "port.extract"): 100e-6,
            ("port.slide", "port.pool"): 80e-6,
            ("port.slide", "port.home"): 150e-6, ("port.home",): 10e-6,
            (): 10e-6}
    assert by.keys() == want.keys()
    for k, v in want.items():
        assert by[k] == pytest.approx(v, abs=1e-12), k
    idle_s = (1.0 - SERVE.trace.busy_s / SERVE.trace.window_s) * 1e-3
    assert sum(by.values()) == pytest.approx(idle_s)


def test_serving_readers(counted):
    assert spans.stage_idle_percent(SERVE) == pytest.approx(8.0)
    assert spans.tail_idle_ms_per_slide(SERVE) == pytest.approx(0.23 / 2)
    # 80 + 30 us of fills over 2000 tiles
    assert spans.stage_fill_ms_per_ktile(SERVE) == pytest.approx(0.11 / 2)


def test_training_readers_partition_the_idle_time(counted):
    stage = spans.stage_idle_percent(TRAIN)
    step = spans.step_idle_percent(TRAIN)
    assert stage == pytest.approx(12.0)
    assert step == pytest.approx(23.0)
    assert stage + step <= readers.idle_percent(TRAIN) == pytest.approx(50.0)


def test_every_reader_is_none_without_port_spans(counted):
    bare = _trace([(0, 100)], [("bench.slide", 0, 900),
                               ("aten::copy_", 100, 200)])
    for read in (spans.stage_idle_percent, spans.step_idle_percent,
                 spans.tail_idle_ms_per_slide, spans.stage_fill_ms_per_ktile):
        assert read(bare) is None


def test_readers_are_none_without_counters_or_device_records(monkeypatch):
    profiling.reset_counters()
    assert spans.tail_idle_ms_per_slide(SERVE) is None
    assert spans.stage_fill_ms_per_ktile(SERVE) is None
    # a port without counters at all, as the parent of the spans has
    monkeypatch.delattr(profiling, "counters")
    assert spans.port_counters() == {}
    idle_only = _trace([], [("port.stage.fill", 0, 500)])
    assert spans.stage_idle_percent(idle_only) is None


@pytest.mark.parametrize("name", ["stage_fill_ms_per_ktile.serve",
                                  "stage_fill_ms_per_ktile.train",
                                  "stage_idle_share.serve",
                                  "stage_idle_share.train",
                                  "tail_idle_ms_per_slide.serve",
                                  "step_idle_share.train"])
def test_metric_files_read_the_spans(name):
    read = harness.metric_reader(name)
    assert read.__module__ == "benchmark.spans"


class _Cache:
    def __init__(self, raw, device):
        self.raw, self.device = raw, device
        self.coords = np.zeros((len(raw), 2), np.int64)
        self.params = {"resolution": raw.shape[1]}

    def update_resolution_and_buffer(self, resolution):
        self.params["resolution"] = resolution

    def _load_cache(self, with_coords=False, mmap=False):
        return (self.raw, self.coords) if with_coords else self.raw


@pytest.mark.card
def test_spans_share_the_device_clock(card, tmp_path):
    """A streaming slide of 3 chunks under ``profiling.trace``: every kernel
    launched inside a ``port.extract`` span (linked to its launch by the
    trace's correlation ids, which its launch flows carry) starts on the
    card after the span starts, and every ``port.stage.fill`` starts before
    the host-to-device copy it enqueued."""
    cfg = amil.MILConfig(widths=(8, 8, 8, 8), blocks=(1, 1, 1, 1))
    model = amil.init_attention_mil(torch.Generator().manual_seed(0), cfg,
                                    device=card)
    raw = np.random.default_rng(0).integers(0, 256, (300, 64, 64, 3),
                                            dtype=np.uint8)

    def slide():
        return inference.classify_slide_streaming(
            model, cfg, _Cache(raw, card), resolution=64, chunk=128)

    slide()
    torch.cuda.synchronize(card)
    with profiling.trace(str(tmp_path), device=card):
        slide()
        torch.cuda.synchronize(card)
    (path,) = [p for p in os.listdir(tmp_path) if p.startswith("trace_")]
    with open(tmp_path / path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X"]
    ann = [e for e in events if e.get("cat") == "user_annotation"]
    device = {e["args"]["correlation"]: e for e in events
              if e.get("cat") in ("kernel", "gpu_memcpy")
              and "correlation" in e.get("args", {})}
    calls = [e for e in events if e.get("cat") in ("cuda_runtime",
                                                   "cuda_driver")]

    def linked(span, what):
        a, b = span["ts"], span["ts"] + span["dur"]
        return [device[c["args"]["correlation"]] for c in calls
                if what in c["name"] and a <= c["ts"] <= b
                and c.get("args", {}).get("correlation") in device]

    extracts = [e for e in ann if e["name"] == "port.extract"]
    fills = [e for e in ann if e["name"] == "port.stage.fill"]
    assert len(extracts) == len(fills) == 3
    launched = 0
    for span in extracts:
        for k in linked(span, "Launch"):
            assert k["ts"] >= span["ts"], (span, k)
            launched += 1
    for span in fills:
        copies = [c for c in linked(span, "Memcpy") if "HtoD" in c["name"]]
        assert len(copies) == 1
        assert copies[0]["ts"] >= span["ts"]
    assert launched > 0
    print(f"linked launches inside port.extract: {launched}")
