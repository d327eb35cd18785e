"""The port's native (C++) tissue filter against its torch filter and the
JAX package's native filter, and the RoiBuilder paths that use them.

All three implement one rule, so keep flags and gathered tiles are equal,
not close. The port builds its own copy of the source into its own
``_build/`` directory, never beside the JAX package's library; the JAX
package's library is built for this module in a directory of its own
(``torch_jax_native``), since other pytest workers may be writing the one
beside its source."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import conftest  # noqa: F401
from torch_jax_native import private_jax_native

from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.data import (
    native as tnative,
    roibuilder as troi,
    slide_io as tslide_io,
    tissue as ttissue,
)
from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.ops import (
    _build,
)


def _slide(seed, size):
    """H&E-like purple noise with a white band and a flat block, so the
    filter keeps some tiles and drops others."""
    rng = np.random.default_rng(seed)
    img = np.clip(np.array([140, 60, 170], np.int16)
                  + rng.integers(-40, 40, (size, size, 3)), 0,
                  255).astype(np.uint8)
    img[:, : size // 4] = 245
    img[size // 2:, size // 2:] = (150, 70, 170)
    return img


@pytest.fixture(scope="module")
def built():
    if not tnative.available():
        pytest.fail("g++ could not build the port's tissue filter")
    return tnative


@pytest.fixture(scope="module")
def jnative(tmp_path_factory):
    """The JAX package's loader with its library built in a directory of
    this module's own, its per-process state reset while the module runs
    and restored after."""
    with private_jax_native(tmp_path_factory.mktemp("jax_native"),
                            build=True) as loader:
        yield loader


def test_library_builds_into_the_ports_own_build_dir(built, jnative):
    lib = built._get_lib()
    path = os.path.realpath(lib._name)
    assert os.path.dirname(path) == os.path.realpath(_build.BUILD_DIR)
    assert os.path.basename(path).startswith("libtissue_filter_")
    assert "_tpu_torch" in path
    port_src = open(built._SRC).read()
    jax_src = open(os.path.abspath(jnative._SRC)).read()
    # the same extern "C" functions as the JAX package's source
    for fn in ("void tissue_mask(", "void gather_tiles("):
        assert fn in port_src and fn in jax_src


def test_jax_library_is_built_outside_the_jax_package(jnative, tmp_path):
    """The comparison's JAX library lies in this module's directory; the
    one beside the JAX package's source is neither written nor read."""
    lib = os.path.realpath(jnative._get_lib()._name)
    src_dir = os.path.dirname(os.path.realpath(jnative._SRC))
    assert os.path.dirname(lib) == os.path.realpath(
        os.environ["GBMNET_NATIVE_DIR"])
    assert os.path.dirname(lib) != src_dir


@pytest.mark.parametrize("roi,size,seed", [(64, 400, 0), (32, 200, 1),
                                           (50, 333, 2)])
def test_keep_flags_and_tiles_match_torch_and_jax(built, jnative, roi, size,
                                                 seed):
    img = _slide(seed, size)
    raster = np.asarray(ttissue.sliding_window(img.shape, roi), np.int64)
    keep = built.tissue_mask_native(img, raster, roi)
    stack = np.stack([img[x:x + roi, y:y + roi] for x, y in raster])
    keep_torch = ttissue.tissue_mask_batch(torch.from_numpy(stack)).numpy()
    keep_jax = jnative.tissue_mask_native(img, raster, roi)
    assert keep.any() and not keep.all()
    np.testing.assert_array_equal(keep, keep_torch)
    np.testing.assert_array_equal(keep, keep_jax)

    tiles, coords = built.extract_tissue_tiles_native(img, roi)
    t_tiles, t_coords = ttissue.extract_tissue_tiles(img, roi, device="cpu")
    j_tiles, j_coords = jnative.extract_tissue_tiles_native(img, roi)
    np.testing.assert_array_equal(coords, raster[keep])
    for other_tiles, other_coords in ((t_tiles, t_coords),
                                      (j_tiles, j_coords)):
        np.testing.assert_array_equal(coords, other_coords)
        np.testing.assert_array_equal(tiles, other_tiles)


_THREAD_PROBE = """
import os, sys, time
import numpy as np
sys.path.insert(0, {repo!r})
from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.data import native
native._get_lib()
img = np.random.default_rng(0).integers(0, 256, (400, 400, 3), dtype=np.uint8)
raster = np.array([[r, c] for r in range(0, 368, 32) for c in range(0, 368, 32)])


def tasks():
    # each OS thread of this process: its name and state, or "exited"
    # when it left between the listing and the read
    out = {{}}
    for tid in os.listdir("/proc/self/task"):
        try:
            with open(f"/proc/self/task/{{tid}}/comm") as f:
                comm = f.read().strip()
            with open(f"/proc/self/task/{{tid}}/stat") as f:
                state = f.read().rsplit(")", 1)[1].split()[0]
        except OSError:
            comm, state = "?", "exited"
        out[tid] = f"{{comm}}:{{state}}"
    return out


before = tasks()
for _ in range(3):
    native.tissue_mask_native(img, raster, 32)
    native.gather_tiles_native(img, raster, 32)
# std::thread::join returns once the kernel has cleared the worker's tid,
# before it unhashes the task from the thread group, so a joined worker
# can stay listed for a moment; a worker that outlives the call never
# leaves, and the wait ends at its bound
deadline = time.monotonic() + 5
after = tasks()
while len(after) != len(before) and time.monotonic() < deadline:
    time.sleep(0.01)
    after = tasks()
extra = sorted(v for tid, v in after.items() if tid not in before)
print(len(before), len(after), *extra)
"""


def test_calls_leave_no_threads_behind(built):
    """The filter's workers are joined inside each call: a fresh process
    that runs it has as many threads after as before (an OpenMP runtime
    keeps its pool alive after the first parallel loop). ``before`` is
    read ahead of the first call, so a pool that the first call starts
    would show."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c",
                           _THREAD_PROBE.format(repo=repo)],
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    before, after, *extra = proc.stdout.split()
    assert after == before, f"threads left after the calls: {extra}"


def test_border_coords_are_safe(built):
    img = _slide(3, 100)
    coords = np.array([[90, 90], [-5, 0], [100, 0], [0, 40]], np.int64)
    keep = built.tissue_mask_native(img, coords, 32)
    assert not keep[1] and not keep[2]
    tiles = built.gather_tiles_native(img, coords, 32)
    np.testing.assert_array_equal(tiles[0, :10, :10], img[90:, 90:])
    assert not tiles[0, 10:].any() and not tiles[1].any()
    np.testing.assert_array_equal(tiles[3], img[0:32, 40:72])


def test_empty_raster(built):
    tiles, coords = built.extract_tissue_tiles_native(_slide(4, 40), 64)
    assert tiles.shape == (0, 64, 64, 3) and coords.shape == (0, 2)


@pytest.mark.parametrize("use_native", [True, False])
def test_roibuilder_caches_equal_on_native_and_torch_paths(
        built, tmp_path, monkeypatch, use_native):
    """RoiBuilder.build takes the native filter when it is available and
    the torch filter on its device otherwise; the caches are the same."""
    img = _slide(5, 400)
    monkeypatch.setenv("CACHE_DIR", str(tmp_path))
    monkeypatch.setattr(troi.native, "available", lambda: use_native)
    calls = []
    real = ttissue.extract_tissue_tiles
    monkeypatch.setattr(troi.tissue, "extract_tissue_tiles",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    path = tslide_io.write_synthetic_slide(str(tmp_path / "n_H&E.npy"), img)
    builder = troi.RoiBuilder(path, {"roi_size": 64}, device="cpu")
    assert builder.build() and builder.params["status"] == "VALID"
    assert bool(calls) != use_native
    tiles, coords = real(img, 64, device="cpu")
    np.testing.assert_array_equal(np.load(builder.params["data_cache"]),
                                  tiles)
    np.testing.assert_array_equal(np.load(builder.params["coor_cache"]),
                                  coords)


def test_readahead_is_best_effort(tmp_path, monkeypatch):
    monkeypatch.setenv("CACHE_DIR", str(tmp_path))
    path = tslide_io.write_synthetic_slide(str(tmp_path / "r_H&E.npy"),
                                           _slide(6, 200))
    builder = troi.RoiBuilder(path, {"roi_size": 64}, device="cpu")
    builder.readahead()  # no cache yet: a no-op, not an error
    builder.build()
    builder.readahead()
    assert builder.getsize() == len(np.load(builder.params["coor_cache"]))
