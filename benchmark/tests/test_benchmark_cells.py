"""``BENCHMARK.json`` against the benchmark's contract, every file it names
found by name, and the result line's keys."""

import json
import math
import os
import re

import pytest
import torch

from benchmark import harness
from benchmark.tests import tiny

ROOT = harness.ROOT
with open(os.path.join(ROOT, "BENCHMARK.json")) as _f:
    BENCH = json.load(_f)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CPU = torch.device("cpu")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert BENCH["command"][1] == "benchmark/run.py"
    assert 1 <= BENCH["run_seconds"] <= 51
    cells = len(BENCH["workloads"])
    # a full check with 24 cells must fit into 43,200 s
    full = (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200
    assert full <= 43200 and 1 <= cells <= 24
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 65536


def test_names_units_and_keys():
    names = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("benchmark/")
        assert os.path.isfile(os.path.join(ROOT, c["file"]))
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert NAME.match(w["traffic"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["name"] not in names
        names.add(m["name"])
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]
        assert os.path.isfile(os.path.join(harness.HERE, "metrics",
                                           m["name"] + ".py"))


@pytest.mark.parametrize("name", tiny.CELLS)
def test_cell_files_are_found_by_name(name):
    cell = harness.load_cell(name)
    assert cell["mix"]["mode"] in harness.MODES
    harness.program_module(cell["config"])
    harness.reference_module(cell["config"])
    assert cell["limits"], "the cell has no limits"
    e2e = [m["name"] for m in cell["end_to_end"]]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell["per_layer"]
    for m in cell["per_layer"]:
        assert callable(harness.metric_reader(m["name"]))
        # each per-layer metric moves an end-to-end metric of its cells
        assert m["moves"] in e2e


@pytest.mark.parametrize("name", tiny.CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_result_line_keys(name, trace):
    cell = tiny.cell(name)
    result, lines, _ = harness.run_cell(
        cell, seed=2 ** 31 + 9, seconds=0.2, trace=bool(trace),
        device=CPU, t_start=0.0)
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    keys += ["breakdown"] if trace else []
    assert list(result) == keys + ["checks"]
    assert set(result["device"]) >= {"platform", "kind", "count",
                                     "memory_peak_bytes"}
    if trace:
        assert {"busy_s", "window_s"} <= set(result["device"])
    else:
        assert set(result["metrics"]) == {m["name"]
                                          for m in cell["end_to_end"]}
        assert all(math.isfinite(v["value"]) and v["value"] > 0
                   for v in result["metrics"].values())
    assert result["attempted"] > 0
    assert len(lines) == 2 + trace + len(result["checks"])
    json.dumps(result)
