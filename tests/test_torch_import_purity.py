"""The port imports no JAX and touches no device at import.

An AST scan of every module of the port refuses ``jax``, ``jaxlib`` and
the JAX package, and scikit-learn, pandas and matplotlib, which the
machine with the card does not have; a fresh interpreter that imports the
whole port must leave all of them out of ``sys.modules``, and tensorboard
too (``utils/tb.py`` imports it only inside its guarded constructor), CUDA
uninitialised, Triton unloaded and no kernel or native library built
(registering the pool's ``torch.library`` op builds nothing)."""

import ast
import os
import subprocess
import sys

import pytest

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = "deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch"
JAX_PKG = "deep_convolutional_neural_network_resnet_26_and_attention_network_tpu"
FORBIDDEN = ("jax", "jaxlib", JAX_PKG, "gbmnet")
NOT_ON_THE_CARD = ("sklearn", "pandas", "matplotlib")


def _port_files():
    root = os.path.join(_REPO, PORT)
    out = []
    for d, _, files in os.walk(root):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _imported_roots(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_port_has_modules_to_scan():
    names = {os.path.relpath(p, os.path.join(_REPO, PORT))
             for p in _port_files()}
    for must in ("ops/gated_pool.py", "parallel/inference.py",
                 "models/attention_mil.py", "data/roibuilder.py",
                 "ops/u8_stem.py", "data/native.py", "train/serve.py",
                 "train/checkpoint.py", "train/classify.py",
                 "utils/helpers.py", "parallel/steps.py",
                 "train/schedule.py", "data/dataset.py", "data/accessors.py",
                 "utils/plots.py", "ops/quant.py", "utils/profiling.py",
                 "utils/tb.py", "data/build_caches.py", "deploy.py",
                 "utils/torch_interop.py", "parallel/mesh.py",
                 "parallel/shard_pool.py", "ops/collectives.py",
                 "graft_entry.py"):
        assert must in names


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, _REPO))
def test_module_imports_no_jax(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path} imports {bad}"


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, _REPO))
def test_module_imports_nothing_the_card_machine_lacks(path):
    bad = sorted(set(_imported_roots(path)) & set(NOT_ON_THE_CARD))
    assert not bad, f"{path} imports {bad}"


_PROBE = f"""
import os, sys
import {PORT} as port
from {PORT} import data, models, ops, parallel, train, utils
from {PORT}.ops import _build
from {PORT}.data import native
from {PORT}.train import classify, schedule, serve
from {PORT}.parallel import steps
from {PORT}.data import accessors, dataset
from {PORT}.utils import plots, profiling, tb
from {PORT}.ops import quant
from {PORT}.data import build_caches
from {PORT} import deploy
from {PORT}.utils import torch_interop
import torch
assert "jax" not in sys.modules and "jaxlib" not in sys.modules
assert "{JAX_PKG}" not in sys.modules
for name in {NOT_ON_THE_CARD!r} + ("tensorboard",):
    assert name not in sys.modules, name
assert not torch.cuda.is_initialized()
assert "triton" not in sys.modules
assert not _build._LIBS and native._LIB is None and not native._TRIED
print("PORT_IMPORT_PURE")
"""


def test_import_is_pure_in_fresh_interpreter():
    env = dict(os.environ)
    env["PYTHONPATH"] = _REPO + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, "-c", _PROBE], capture_output=True,
                          text=True, env=env, cwd=_REPO, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "PORT_IMPORT_PURE" in proc.stdout
