"""The port's profiling and TensorBoard utilities and the trainer's
``--profile`` / ``--tensorboard`` flags, on the CPU.

``StepTimer`` against the JAX package's on one patched clock; the trainer
CLI's ``--profile`` (a trace, with the port's window spans, and its
counters file under ``<run>/profile/``, and ``step_times``
of at least one step in the epoch's summary, as
``test_train_stack.py::test_classify_cli_profile_flag`` asks of the JAX
CLI); ``EpochWriter``'s flattening against JAX's, its event files, and the
no-op it becomes when tensorboard cannot be imported."""

import builtins
import json
import os
import time

import pytest
import torch

import conftest  # noqa: F401
from test_torch_train_cli import _run, tree  # noqa: F401

from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu.utils import (
    profiling as jprofiling,
    tb as jtb,
)
from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.utils import (
    profiling,
    tb,
)

STATS = {"train_loss": 1.25, "valid_eval_mode": False, "epoch": 3,
         "train_acc": {"A": {"precision": 0.5, "support": 2},
                       "accuracy": 0.25},
         "args": {"tag": "X"}, "step_times": {"steps": 4, "mean_s": 0.1}}


def _timed(timer_cls, ticks, monkeypatch, steps):
    clock = iter(ticks)
    monkeypatch.setattr(time, "perf_counter", lambda: next(clock))
    timer = timer_cls(warmup=1)
    for _ in range(steps):
        with timer.step():
            pass
    return timer.summary()


@pytest.mark.parametrize("steps", [0, 1, 2, 7])
def test_step_timer_summary_matches_jax(monkeypatch, steps):
    ticks = [0.0]
    for i in range(steps):
        ticks += [ticks[-1] + 0.5, ticks[-1] + 0.5 + 0.01 * (i + 1) ** 2]
    ticks = ticks[1:]
    want = _timed(jprofiling.StepTimer, ticks, monkeypatch, steps)
    assert _timed(profiling.StepTimer, ticks, monkeypatch, steps) == want
    assert want["steps"] == max(steps - 1, 0)


def test_trace_writes_a_chrome_trace_with_spans(tmp_path):
    with profiling.trace(str(tmp_path / "p"), device="cpu"):
        with profiling.annotate("my_span"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    files = sorted(os.listdir(tmp_path / "p"))
    assert len(files) == 2 and files[1].startswith("trace_")
    assert all(f.endswith(".json") for f in files)
    with open(tmp_path / "p" / files[1]) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "my_span" for e in events)


def test_cli_profile_flag_traces_the_first_epoch(tree):  # noqa: F811
    assert _run(tree, "PROF", "--epoch_start", "0", "--epoch_end", "0",
                "--profile") == 0
    run = tree / "runs" / "run_PROF"
    prof = run / "profile"
    assert prof.is_dir() and any(prof.rglob("*.json"))
    (trace,) = prof.glob("trace_*.json")
    assert (prof / trace.name.replace("trace_", "counters_", 1)).is_file()
    with open(trace) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "port.window_step" for e in events)
    with open(run / "0000summary.json") as f:
        stats = json.load(f)
    assert stats["step_times"]["steps"] >= 1
    assert set(stats["step_times"]) == {"steps", "mean_s", "p50_s", "p90_s",
                                        "total_s"}


def test_cli_tensorboard_flag_logs_epochs(tree):  # noqa: F811
    pytest.importorskip("tensorboard")
    assert _run(tree, "TB", "--epoch_start", "0", "--epoch_end", "0",
                "--tensorboard") == 0
    logdir = tree / "runs" / "runs" / "TAG_TB"
    assert any(f.startswith("events.out.tfevents")
               for f in os.listdir(logdir))


def test_epoch_writer_flattening_matches_jax():
    assert list(tb._flatten_scalars(STATS)) == \
        list(jtb._flatten_scalars(STATS))
    assert ("train_acc/A/precision", 0.5) in tb._flatten_scalars(STATS)


def test_epoch_writer_is_a_noop_without_tensorboard(tmp_path, monkeypatch):
    real = builtins.__import__

    def no_tensorboard(name, *args, **kwargs):
        if name.startswith("torch.utils.tensorboard"):
            raise ImportError("no tensorboard")
        return real(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_tensorboard)
    writer = tb.EpochWriter(str(tmp_path / "tb"))
    assert not writer.active
    writer.log_epoch(0, STATS)
    writer.close()
    assert not (tmp_path / "tb").exists()
