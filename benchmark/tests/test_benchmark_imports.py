"""Nothing the benchmark loads is JAX or the JAX package, by whole
top-level name; the plain references load nothing of the port."""

import ast
import os
import subprocess
import sys

import pytest

from benchmark import harness

PORT = "deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch"
HERE = harness.HERE


def _tree_files(sub):
    root = os.path.join(HERE, sub)
    return sorted(os.path.join(root, f) for f in os.listdir(root)
                  if f.endswith(".py"))


def _roots(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def _run(code):
    return subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT,
                          capture_output=True, text=True, timeout=600)


def test_a_run_loads_no_jax():
    """A whole tiny run of every cell, then the loaded modules by top-level
    name (the port's name begins with the JAX package's: a prefix test
    would take one for the other)."""
    code = (
        "import sys, torch\n"
        "from benchmark import harness\n"
        "from benchmark.tests import tiny\n"
        "for n in tiny.CELLS:\n"
        "    harness.run_cell(tiny.cell(n), seed=5, seconds=0.1, trace=False,"
        " device=torch.device('cpu'), t_start=0.0)\n"
        f"assert {PORT!r} in sys.modules\n"
        "print(harness.forbidden_modules())\n")
    out = _run(code)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_forbidden_modules_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, harness.JAX_PACKAGE + "_x", sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, harness.JAX_PACKAGE + ".models", sys)
    assert harness.forbidden_modules() == [harness.JAX_PACKAGE]


@pytest.mark.parametrize("path", _tree_files("reference"),
                         ids=os.path.basename)
def test_reference_imports_nothing_of_the_port(path):
    roots = set(_roots(path))
    assert not roots & {PORT, "jax", "jaxlib", "flax", harness.JAX_PACKAGE}
    assert roots <= {"contextlib", "math", "torch"}


def test_reference_loads_nothing_of_the_port():
    code = ("import sys\n"
            "from benchmark.reference import resnet26_mil, critic_mil\n"
            "import benchmark.flops\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}"
            f" & {{{PORT!r}, 'jax', {harness.JAX_PACKAGE!r}}}))\n")
    out = _run(code)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip() == "[]"


@pytest.mark.parametrize("sub", ["programs", "metrics", "reference", ""])
def test_no_file_imports_jax(sub):
    for path in _tree_files(sub) if sub else [
            os.path.join(HERE, f) for f in os.listdir(HERE)
            if f.endswith(".py")]:
        assert not set(_roots(path)) & {"jax", "jaxlib", "flax",
                                        harness.JAX_PACKAGE}, path
