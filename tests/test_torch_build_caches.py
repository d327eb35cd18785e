"""The port's offline tile-cache builder (``data/build_caches.py``).

Mirrors ``tests/test_data.py::test_build_caches_cli`` and
``::test_build_caches_cli_parallel_matches_serial`` on the port, and holds
the caches it writes, serial and with ``--workers 2``, byte for byte to
those the JAX package's ``build_caches`` writes for the same slides."""

import os

import numpy as np
import pytest

import conftest  # noqa: F401
from torch_jax_native import private_jax_native

from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu.data import (
    build_caches as jbuild_caches,
)
from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.data import (
    build_caches,
    slide_io,
)


@pytest.fixture(scope="module", autouse=True)
def _jax_native_of_its_own(tmp_path_factory):
    """The JAX package's cache builds load its native filter from a
    directory of this module's own (``torch_jax_native``), never the one
    beside its source, which other pytest workers may be writing."""
    with private_jax_native(tmp_path_factory.mktemp("jax_native")):
        yield


def _slides(tmp_path, names, seed):
    """Purple-noise slides of 200 x 200 px (a 3 x 3 raster at roi 64),
    written as ``.npy`` (no tifffile here), and the CLI's arguments."""
    slides = tmp_path / "imgs"
    slides.mkdir()
    rng = np.random.default_rng(seed)
    base = np.array([140, 60, 170], np.int16)
    for name in names:
        img = np.clip(base + rng.integers(-40, 40, (200, 200, 3)), 0,
                      255).astype(np.uint8)
        img[:64, :64] = 245  # one white (background) tile
        slide_io.write_synthetic_slide(str(slides / name), img)
    return ["--data_root", str(tmp_path), "--image_dir", "imgs",
            "--roi_size", "64", "--glob", "*H&E.npy"]


def _cache_files(d):
    return {f: (d / f).read_bytes() for f in sorted(os.listdir(d))}


def test_build_caches_cli(tmp_path, monkeypatch, capsys):
    """The CLI scans a slide directory and persists the standard caches; a
    second run reports them as cached."""
    cache = tmp_path / "cache"
    cache.mkdir()
    monkeypatch.setenv("CACHE_DIR", str(cache))
    argv = _slides(tmp_path, ("GHP_1_A_H&E.scn", "GHP_2_B_H&E.scn"), 0)
    assert build_caches.main(argv) == 0
    built = sorted(os.listdir(cache))
    assert sum(f.startswith("data_") for f in built) == 2
    assert sum(f.startswith("coor_") for f in built) == 2
    assert np.load(cache / "data_GHP_1_A_H&E_rois_size64_hsvcut_v3.npy"
                   ).shape == (8, 64, 64, 3)
    assert "done: 2 built, 0 already cached, 0 failed" in \
        capsys.readouterr().out
    assert build_caches.main(argv) == 0  # idempotent: all cached
    assert "done: 0 built, 2 already cached, 0 failed" in \
        capsys.readouterr().out


def test_build_caches_cli_parallel_matches_serial_and_jax(tmp_path,
                                                          monkeypatch):
    """``--workers 2`` builds in spawned processes; its caches, the serial
    build's and the JAX package's builder's are byte-identical, and a
    prebuilt cache is reported, not rebuilt, under --workers too."""
    argv = _slides(tmp_path, ("GHP_1_A_H&E.scn", "GHP_2_B_H&E.scn",
                              "GHP_3_C_H&E.scn"), 3)
    dirs = {k: tmp_path / f"cache_{k}" for k in ("serial", "parallel",
                                                  "jax")}
    for kind, d in dirs.items():
        d.mkdir()
        monkeypatch.setenv("CACHE_DIR", str(d))
        if kind == "jax":
            assert jbuild_caches.main(argv) == 0
        else:
            extra = ["--workers", "2"] if kind == "parallel" else []
            assert build_caches.main(argv + extra) == 0
    files = {k: _cache_files(d) for k, d in dirs.items()}
    assert len(files["serial"]) == 6  # data_ + coor_ x 3
    assert files["parallel"] == files["serial"] == files["jax"]

    monkeypatch.setenv("CACHE_DIR", str(dirs["parallel"]))
    assert build_caches.main(argv + ["--workers", "2"]) == 0
    assert _cache_files(dirs["parallel"]) == files["serial"]


def test_build_caches_reports_failures_and_bad_arguments(tmp_path,
                                                         monkeypatch):
    """A slide that cannot be read fails alone (exit 1, the others built);
    no matching slide exits 2; ``--workers 0`` is an argument error."""
    cache = tmp_path / "cache"
    cache.mkdir()
    monkeypatch.setenv("CACHE_DIR", str(cache))
    argv = _slides(tmp_path, ("GHP_1_A_H&E.scn",), 1)
    (tmp_path / "imgs" / "GHP_9_Z_H&E.npy").write_bytes(b"not a slide")
    assert build_caches.main(argv) == 1
    assert (cache / "data_GHP_1_A_H&E_rois_size64_hsvcut_v3.npy").is_file()
    assert not any("GHP_9_Z" in f for f in os.listdir(cache))
    assert build_caches.main(argv[:-1] + ["*.svs"]) == 2
    with pytest.raises(SystemExit):
        build_caches.main(argv + ["--workers", "0"])
