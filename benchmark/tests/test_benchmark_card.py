"""A whole run of each cell through ``run.py`` on the card, briefly; skips
on a host without one."""

import json
import subprocess
import sys

import pytest

from benchmark import harness
from benchmark.tests import tiny


@pytest.mark.card
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("name", tiny.CELLS)
def test_run_py_on_the_card(card, name, trace):
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", name, "--seed",
         str(2 ** 31 + 101), "--seconds", "3", "--trace", str(trace)],
        cwd=harness.ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    assert result["device"]["platform"] == "gpu"
    cell = harness.load_cell(name)
    want = cell["per_layer"] if trace else cell["end_to_end"]
    assert set(result["metrics"]) == {m["name"] for m in want}
