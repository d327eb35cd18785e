"""The port imports no JAX and touches no device at import.

An AST scan of every module of the port refuses ``jax``, ``jaxlib`` and
the JAX package, and scikit-learn, pandas and cv2, which the machine with
the card does not have; matplotlib and Pillow, which it need not have, only
inside a function body and a ``try`` that catches their absence (as
``utils/tb.py`` imports tensorboard). A fresh interpreter that imports the
whole port must leave all of them out of ``sys.modules``, and tensorboard
too, CUDA uninitialised, Triton unloaded and no kernel or native library
built (registering the pool's ``torch.library`` op builds nothing)."""

import ast
import os
import subprocess
import sys

import pytest

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = "deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch"
JAX_PKG = "deep_convolutional_neural_network_resnet_26_and_attention_network_tpu"
FORBIDDEN = ("jax", "jaxlib", JAX_PKG, "gbmnet")
NOT_ON_THE_CARD = ("sklearn", "pandas", "cv2", "matplotlib", "PIL")
# imported only inside a function, in a try that catches their absence
GUARDED = ("matplotlib", "PIL")


def _port_files():
    root = os.path.join(_REPO, PORT)
    out = []
    for d, _, files in os.walk(root):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _roots(node):
    if isinstance(node, ast.Import):
        return [alias.name.split(".")[0] for alias in node.names]
    if isinstance(node, ast.ImportFrom) and node.level == 0:
        return [node.module.split(".")[0]]
    return []


def _imported_roots(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        yield from _roots(node)


def _catches_absence(handler):
    names = ([handler.type] if not isinstance(handler.type, ast.Tuple)
             else handler.type.elts) if handler.type is not None else []
    return handler.type is None or any(
        isinstance(n, ast.Name) and n.id in ("ImportError", "Exception",
                                             "ModuleNotFoundError")
        for n in names)


def _unguarded_roots(path):
    """The roots imported outside a function body, or outside the body of
    a ``try`` that catches their absence, in that function."""
    out = []

    def visit(node, in_fn, guarded):
        for child in ast.iter_child_nodes(node):
            fn = in_fn or isinstance(child, (ast.FunctionDef,
                                             ast.AsyncFunctionDef))
            g = guarded and not isinstance(child, (ast.FunctionDef,
                                                   ast.AsyncFunctionDef))
            if (isinstance(node, ast.Try) and child in node.body
                    and any(_catches_absence(h) for h in node.handlers)):
                g = in_fn
            if not (fn and g):
                out.extend(_roots(child))
            visit(child, fn, g)

    visit(ast.parse(open(path).read(), path), False, False)
    return out


def test_port_has_modules_to_scan():
    names = {os.path.relpath(p, os.path.join(_REPO, PORT))
             for p in _port_files()}
    for must in ("models/stylegan.py", "train/gan.py",
                 "data/gan_dataset.py", "train/gan_generate.py",
                 "models/disc_extractor.py", "models/blocks.py",
                 "train/classify_legacy.py", "train/heatmap.py",
                 "ops/gated_pool.py", "parallel/inference.py",
                 "models/attention_mil.py", "data/roibuilder.py",
                 "ops/u8_stem.py", "data/native.py", "train/serve.py",
                 "train/checkpoint.py", "train/classify.py",
                 "utils/helpers.py", "parallel/steps.py",
                 "train/schedule.py", "data/dataset.py", "data/accessors.py",
                 "utils/plots.py", "ops/quant.py", "utils/profiling.py",
                 "utils/tb.py", "data/build_caches.py", "deploy.py",
                 "utils/torch_interop.py", "parallel/mesh.py",
                 "parallel/shard_pool.py", "ops/collectives.py",
                 "graft_entry.py", "models/alt_resnet.py", "models/wae.py",
                 "models/unet.py", "data/stain.py", "data/cell_datasets.py",
                 "interpret/__init__.py", "interpret/gradcam.py",
                 "interpret/guided.py", "interpret/misc.py",
                 "interpret/optimize.py", "interpret/saliency.py"):
        assert must in names


# the JAX package's modules whose counterparts carry other names: the
# Pallas kernels (ops/gated_pool.py and ops/u8_stem.py over csrc/) and the
# XLA compilation cache (the port's kernels build into _build/)
COUNTERPART_ELSEWHERE = ("ops/pallas_pool.py", "ops/pallas_stem.py",
                         "utils/compcache.py")


def test_every_jax_module_has_a_counterpart():
    root = os.path.join(_REPO, JAX_PKG)
    jax_modules = {os.path.relpath(os.path.join(d, f), root)
                   for d, _, files in os.walk(root)
                   for f in files if f.endswith(".py")}
    ours = {os.path.relpath(p, os.path.join(_REPO, PORT))
            for p in _port_files()}
    assert sorted(jax_modules - ours) == sorted(COUNTERPART_ELSEWHERE)


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, _REPO))
def test_module_imports_no_jax(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path} imports {bad}"


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, _REPO))
def test_module_imports_nothing_the_card_machine_lacks(path):
    never = set(NOT_ON_THE_CARD) - set(GUARDED)
    bad = sorted(set(_imported_roots(path)) & never)
    bad += sorted(set(_unguarded_roots(path)) & set(GUARDED))
    assert not bad, f"{path} imports {bad}"


def test_the_guard_rule_sees_an_unguarded_import(tmp_path):
    src = tmp_path / "m.py"
    src.write_text("import matplotlib\n"
                   "def f():\n    from PIL import Image\n"
                   "def g():\n    try:\n        import PIL\n"
                   "    except ImportError:\n        return None\n"
                   "try:\n    import matplotlib.pyplot\n"
                   "except ImportError:\n    pass\n")
    assert _unguarded_roots(str(src)) == ["matplotlib", "PIL", "matplotlib"]


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
from {PORT}.models import blocks, disc_extractor, stylegan
from {PORT}.data import gan_dataset
from {PORT}.train import classify_legacy, gan, gan_generate, heatmap
from {PORT}.utils import helpers
from {PORT} import interpret
from {PORT}.interpret import gradcam, guided, misc, optimize, saliency
from {PORT}.models import alt_resnet, unet, wae
from {PORT}.data import cell_datasets, stain
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


# the port's convergence tools run on the card's machine, which has no JAX:
# they may import the numpy-only helpers of the JAX tools, whose modules
# import JAX only inside the functions the port's tools never call
TOOLS = ("tools/torch_convergence_run.py",
         "tools/torch_gan_convergence_run.py",
         "tools/torch_comm_audit.py",
         "examples/torch_synthetic_demo.py",
         "examples/torch_full_pipeline_demo.py",
         # the measuring tools' twins and what they share
         "tools/torch_chip_health.py",
         "tools/torch_profile_stages.py",
         "tools/torch_profile_gan.py",
         "tools/torch_exp_gan512.py",
         "tools/torch_exp_serve.py",
         "tools/torch_measure.py",
         "tools/torch_tools_runs.py",
         "tools/torch_pool_bwd_seeds.py",
         # the last experiment tools' twins (the seed spread, a comparison
         # tool, imports JAX in its JAX runs and is not listed)
         "tools/torch_exp_megabatch.py",
         "tools/torch_exp_serve_io.py",
         "tools/torch_exp_serve_hetero.py",
         "tools/torch_gan_convergence_r05.py")


@pytest.mark.parametrize("tool", TOOLS)
def test_tool_imports_no_jax(tool):
    bad = sorted(set(_imported_roots(os.path.join(_REPO, tool)))
                 & set(FORBIDDEN))
    assert not bad, f"{tool} imports {bad}"


_TOOLS_PROBE = f"""
import sys, tempfile
for name in ("jax", "jaxlib", "{JAX_PKG}"):
    sys.modules[name] = None  # any import of it raises ImportError
from tools import torch_convergence_run as conv, torch_gan_convergence_run as gconv
conv.build_argparser().parse_args(["--tiny", "--device", "cpu"])
gconv.build_argparser().parse_args(["--tiny", "--device", "cpu"])
work = tempfile.mkdtemp()
conv.build_tree(work + "/tree", n_slides=3, tiles_per_slide=4, roi=8)
gconv.make_dataset(work + "/imgs", 2, 8)
import numpy as np
assert gconv.band_stats(np.zeros((2, 8, 8, 3))).shape == (6,)
from tools import (torch_chip_health, torch_exp_gan512, torch_exp_serve,
                   torch_profile_gan, torch_profile_stages, torch_tools_runs)
torch_chip_health.build_argparser().parse_args(["--device", "cpu"])
torch_profile_stages.build_argparser().parse_args(
    ["--stem", "kernel", "--json", "--device", "cpu"])
torch_profile_stages.build_argparser().parse_args(
    ["--train", "--tiles-per-bag", "2500"])
torch_profile_gan.build_argparser().parse_args(["--dtype", "ab"])
torch_exp_gan512.build_argparser().parse_args(
    ["--probe", "--res", "1024", "--remat", "--grad_accum", "2"])
torch_exp_serve.build_argparser().parse_args(["--cpu", "--bundle"])
torch_tools_runs.build_argparser().parse_args(["--out", "o", "--only", "health"])
from tools import torch_pool_bwd_seeds
torch_pool_bwd_seeds.build_argparser().parse_args(["--seeds", "300:310"])
from tools import (torch_exp_megabatch, torch_exp_serve_hetero,
                   torch_exp_serve_io, torch_gan_convergence_r05)
torch_exp_megabatch.build_argparser().parse_args(["--stem", "kernel"])
torch_exp_serve_io.build_argparser().parse_args(["--roi", "300"])
torch_exp_serve_hetero.build_argparser().parse_args(["--max_tiles", "31"])
gconv.build_argparser().parse_args(["--max_res", "32", "--ema_warmup"])
assert len(torch_gan_convergence_r05.CONFIGS) == 3
assert all(sys.modules.get(n) is None for n in ("jax", "jaxlib", "{JAX_PKG}"))
print("TOOLS_IMPORT_PURE")
"""


def test_tools_import_with_jax_blocked():
    env = dict(os.environ)
    env["PYTHONPATH"] = _REPO + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, "-c", _TOOLS_PROBE],
                          capture_output=True, text=True, env=env, cwd=_REPO,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "TOOLS_IMPORT_PURE" in proc.stdout


# the collective audit and the walkthroughs run on the card's machine too
_AUDIT_PROBE = f"""
import sys
for name in ("jax", "jaxlib", "{JAX_PKG}"):
    sys.modules[name] = None  # any import of it raises ImportError
from tools import torch_comm_audit as audit
from examples import torch_full_pipeline_demo as full
from examples import torch_synthetic_demo as synth
assert set(audit.expected_rows(2, full_width=False)) == set(audit.jax_rows())
assert [s.name for s in full.walkthrough("/w")] == [
    "2", "3", "4", "5", "6", "6i", "6b", "7"]
assert len(synth.walkthrough("/w")) == 2
assert all(sys.modules.get(n) is None for n in ("jax", "jaxlib", "{JAX_PKG}"))
print("AUDIT_DEMOS_IMPORT_PURE")
"""


def test_audit_and_demos_import_with_jax_blocked():
    env = dict(os.environ)
    env["PYTHONPATH"] = _REPO + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, "-c", _AUDIT_PROBE],
                          capture_output=True, text=True, env=env, cwd=_REPO,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "AUDIT_DEMOS_IMPORT_PURE" in proc.stdout
