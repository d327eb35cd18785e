"""The port's serving daemon (train/serve.py), held to the JAX package's.

Mirrors the service-semantics tests of tests/test_serve.py (artifacts,
durability, no double processing, batching, the I/O pipeline, the graceful
stop, prewarm) on the port with ``device="cpu"``, and runs both daemons on
one synthetic slide tree with one JAX-written checkpoint: in float32 at the
tiny arch their ``results.csv`` probabilities and every ``.dla`` value
agree within 1e-5 (the serving paths' f32 bound), with equal predictions
and tile counts; and so with ``--int8`` (both daemons calibrate on the
first slide with tiles, deferring past a tile-less one). Also the ``.dla``
writer and the classifier CLI's config against the JAX package's."""

import io
import os
import threading

import numpy as np
import pytest
import torch

import conftest  # noqa: F401
import jax

from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu.models import (
    attention_mil as jamil,
)
from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu.train import (
    checkpoint as jckpt,
    classify as jclassify,
    serve as jserve,
)
from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu.utils import (
    helpers as jhelpers,
)
from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch import (
    deploy,
)
from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.data.roibuilder import (
    RoiBuilder,
)
from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.ops import (
    gated_pool,
)
from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.train import (
    classify as tclassify,
    serve,
)
from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.utils import (
    helpers as thelpers,
)

COMMON = ["--arch", "tiny", "--resolution", "16", "--roi_size", "32",
          "--f32", "--once", "--settle_secs", "0", "--chunk", "16"]


@pytest.fixture
def slide_tree(tmp_path, monkeypatch):
    """Fake slide files with prebuilt roi-32 tile caches (serving needs no
    labels)."""
    cache = tmp_path / "cache"
    cache.mkdir()
    monkeypatch.setenv("CACHE_DIR", str(cache))
    slides = tmp_path / "slides"
    slides.mkdir()
    rng = np.random.default_rng(3)

    def add_slide(name, ntiles=24):
        path = slides / name
        path.write_bytes(b"fake")
        base = name.split(".")[0]
        tiles = np.clip(np.array([140, 60, 170], np.int16)
                        + rng.integers(-40, 40, (ntiles, 32, 32, 3)),
                        0, 255).astype(np.uint8)
        coords = np.stack([[i * 32, (i % 5) * 32] for i in range(ntiles)])
        np.save(cache / f"data_{base}_rois_size32_hsvcut_v3.npy", tiles)
        np.save(cache / f"coor_{base}_rois_size32_hsvcut_v3.npy", coords)
        return path

    for i in range(1, 4):
        add_slide(f"GHP_{i}_A_H&E.scn")
    return tmp_path, add_slide


def _run(argv):
    return serve.main(argv, device="cpu")


def _rows(out_root):
    with open(os.path.join(out_root, "results.csv")) as f:
        return [ln for ln in f.read().splitlines()[1:] if ln]


def _parse(out_root):
    return {ln.split(",")[0]: ln.split(",") for ln in _rows(out_root)}


def _probs(out_root):
    return {k: [float(p) for p in v[1:4]] for k, v in _parse(out_root).items()}


def test_watch_dir_idempotent_and_incremental(slide_tree, tmp_path):
    tree, add_slide = slide_tree
    out = str(tmp_path / "serve_out")
    argv = ["--watch_dir", str(tree / "slides"), "--out_root", out] + COMMON
    n = gated_pool.LAUNCHES
    assert _run(argv) == 0
    assert gated_pool.LAUNCHES == n  # the CPU path launches no kernel
    rows = _rows(out)
    assert len(rows) == 3
    for ln in rows:
        parts = ln.split(",")
        assert abs(sum(float(p) for p in parts[1:4]) - 1.0) < 1e-4
        assert int(parts[6]) == 24
    dlas = [f for f in os.listdir(out) if f.endswith(".dla")]
    assert len(dlas) == 3 * 4  # ATTN + ACTF1..3 per slide
    with open(os.path.join(out, dlas[0])) as f:
        lines = f.read().splitlines()
    assert len(lines) == 24 and len(lines[0].split()) == 3

    # restart with the same backlog: nothing runs again
    assert _run(argv) == 0
    assert len(_rows(out)) == 3
    # a new slide is picked up incrementally
    add_slide("GHP_9_B_H&E.scn", ntiles=40)
    assert _run(argv) == 0
    rows = _rows(out)
    assert len(rows) == 4
    assert any(ln.startswith("GHP_9_B_H&E,") and ln.split(",")[6] == "40"
               for ln in rows)


def test_reconciles_missing_marker(slide_tree, tmp_path):
    """A crash between the results.csv append and the processed.txt marker:
    the restart adopts the row instead of classifying the slide again."""
    tree, _ = slide_tree
    out = str(tmp_path / "serve_out")
    argv = ["--watch_dir", str(tree / "slides"), "--out_root", out] + COMMON
    assert _run(argv) == 0
    marker = os.path.join(out, "processed.txt")
    names = open(marker).read().splitlines()
    with open(marker, "w") as f:
        f.write("\n".join(names[1:]) + "\n")
    assert _run(argv) == 0
    rows = _rows(out)
    assert len(rows) == 3 and len({ln.split(",")[0] for ln in rows}) == 3
    assert set(open(marker).read().split()) == set(names)


def test_crash_mid_slide_retries_cleanly(slide_tree, tmp_path, monkeypatch):
    """A failure after classification but before the results row leaves
    no bookkeeping: the next run redoes exactly that slide."""
    tree, _ = slide_tree
    out = str(tmp_path / "serve_out")
    argv = ["--watch_dir", str(tree / "slides"), "--out_root", out] + COMMON
    victim = sorted(os.listdir(tree / "slides"))[1].split(".")[0]
    real = thelpers.write_map

    def dying_write_map(meta, *a, **k):
        if meta["basename"] == victim:
            raise OSError("disk died mid-.dla")
        return real(meta, *a, **k)

    monkeypatch.setattr(serve.helpers, "write_map", dying_write_map)
    assert _run(argv) == 1
    assert victim not in {ln.split(",")[0] for ln in _rows(out)}
    assert len(_rows(out)) == 2
    monkeypatch.setattr(serve.helpers, "write_map", real)
    assert _run(argv) == 0
    names = [ln.split(",")[0] for ln in _rows(out)]
    assert len(names) == 3 and sorted(names) == sorted(set(names))


def test_batched_matches_serial(slide_tree, tmp_path):
    """--batch groups small slides into one extractor call (one pool per
    slide); an over-cap slide still streams. The same probabilities as the
    serial daemon (f32: 1e-5) and the same .dla files."""
    tree, add_slide = slide_tree
    add_slide("GHP_9_D_H&E.scn", ntiles=40)  # > cap below: streams
    src = ["--watch_dir", str(tree / "slides")]
    out_s, out_b = str(tmp_path / "serial"), str(tmp_path / "batched")
    assert _run(src + ["--out_root", out_s] + COMMON) == 0
    assert _run(src + ["--out_root", out_b, "--batch", "2",
                       "--batch_tile_cap", "30"] + COMMON) == 0
    rs, rb = _probs(out_s), _probs(out_b)
    assert rs.keys() == rb.keys() and len(rs) == 4
    for name in rs:
        np.testing.assert_allclose(rb[name], rs[name], atol=1e-5)
    ds = {f for f in os.listdir(out_s) if f.endswith(".dla")}
    assert ds == {f for f in os.listdir(out_b) if f.endswith(".dla")}
    for f in ds:
        a = np.loadtxt(os.path.join(out_s, f))
        b = np.loadtxt(os.path.join(out_b, f))
        np.testing.assert_allclose(b, a, atol=1e-5, err_msg=f)


def test_io_pipeline_matches_serial(slide_tree, tmp_path):
    """--io_depth N prepares slides on a background thread: the same rows,
    order and probabilities as --io_depth 0, and a poison slide whose cache
    build fails gets the same failure accounting."""
    tree, _ = slide_tree
    (tree / "slides" / "GHP_0_bad_H&E.scn").write_bytes(b"not a slide")
    src = ["--watch_dir", str(tree / "slides")]
    out0, out3 = str(tmp_path / "depth0"), str(tmp_path / "depth3")
    assert _run(src + ["--out_root", out0, "--io_depth", "0"] + COMMON) == 1
    assert _run(src + ["--out_root", out3, "--io_depth", "3"] + COMMON) == 1
    r0, r3 = _rows(out0), _rows(out3)
    assert len(r0) == len(r3) == 3
    assert [ln.split(",")[0] for ln in r0] == [ln.split(",")[0] for ln in r3]
    for a, b in zip(r0, r3):
        np.testing.assert_allclose([float(p) for p in a.split(",")[1:4]],
                                   [float(p) for p in b.split(",")[1:4]],
                                   atol=1e-6)
    out_b = str(tmp_path / "depth2_batched")
    assert _run(src + ["--out_root", out_b, "--io_depth", "2", "--batch",
                       "2", "--batch_tile_cap", "30"] + COMMON) == 1
    assert {ln.split(",")[0] for ln in _rows(out_b)} == \
        {ln.split(",")[0] for ln in r0}


def test_graceful_stop_finishes_inflight_slide(slide_tree, tmp_path,
                                              monkeypatch):
    """A stop request (what SIGTERM does) finishes and records the slide
    in flight, exits 0, and leaves the rest of the backlog to the next
    start."""
    tree, _ = slide_tree
    out = str(tmp_path / "serve_out")
    orig = serve.SlideServer.process

    def stop_after_first(self, path, builder=None):
        ok = orig(self, path, builder=builder)
        self.request_stop()
        return ok

    monkeypatch.setattr(serve.SlideServer, "process", stop_after_first)
    argv = ["--watch_dir", str(tree / "slides"), "--out_root", out] + [
        a for a in COMMON if a != "--once"]
    server = serve.SlideServer(serve.build_argparser().parse_args(argv),
                               device="cpu")
    backstop = threading.Timer(120, server.request_stop)
    backstop.start()
    try:
        rc = server.run()
    finally:
        backstop.cancel()
    assert rc == 0
    assert len(_rows(out)) == 1
    with open(os.path.join(out, "processed.txt")) as f:
        assert len(f.read().split()) == 1
    monkeypatch.setattr(serve.SlideServer, "process", orig)
    assert _run(argv + ["--once"]) == 0
    assert len(_rows(out)) == 3


def test_prewarm_runs_before_the_first_slide(slide_tree, tmp_path, capsys):
    """--prewarm TILES runs one zero chunk of min(--chunk, TILES) tiles
    through the extractor and the pool before any slide."""
    tree, _ = slide_tree
    out = str(tmp_path / "serve_out")
    assert _run(["--watch_dir", str(tree / "slides"), "--out_root", out,
                 "--prewarm", "64"] + COMMON) == 0
    text = capsys.readouterr().out
    assert text.count("prewarm done") == 1
    assert "prewarm done (chunk=16," in text  # --chunk 16 < TILES
    assert text.index("prewarm done") < text.index("probs=")
    assert len(_rows(out)) == 3
    assert _run(["--watch_dir", str(tree / "slides"), "--out_root",
                 str(tmp_path / "o2"), "--prewarm", "20"]
                + COMMON[:-2] + ["--chunk", "64"]) == 0
    text = capsys.readouterr().out
    assert "prewarm done (chunk=20," in text  # TILES < --chunk


@pytest.mark.parametrize("flag,item", [(["--mesh", "4"], "A.10")])
def test_unported_options_refuse_to_start(slide_tree, tmp_path, monkeypatch,
                                          flag, item):
    """``--mesh`` (ROADMAP ``item``) is ported: its help no longer names
    the item, and on the card (the default device) it refuses to start
    only when the host has fewer cards than ranks, naming the count,
    before anything is written (tests/test_torch_mesh_serve.py serves
    with it)."""
    tree, _ = slide_tree
    assert item not in serve.build_argparser().format_help()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(ValueError, match="--mesh 4 but only 2 CUDA"):
        serve.main(["--watch_dir", str(tree / "slides"), "--out_root",
                    str(tmp_path / "x")] + flag + COMMON)
    assert not os.path.exists(tmp_path / "x")


def _bundle(tmp_path):
    """A float32 bundle of the tiny arch, exported by the port's CLI."""
    out = str(tmp_path / "bundle")
    assert deploy.main(["export", "--out", out, "--arch", "tiny", "--seed",
                        "5", "--resolution", "16", "--roi_size", "32",
                        "--chunk", "16", "--tiles", "64", "--f32"],
                       device="cpu") == 0
    return out


def test_daemon_serves_a_bundle(slide_tree, tmp_path, capsys):
    """``--bundle``: each row equals a direct ``DeployedClassifier`` call
    (within the CSV's rounding), with its .dla maps; the resolution and roi
    size follow the manifest whatever the flags say, ``--ckpt`` is
    ignored, ``--prewarm`` runs both programs first, and a tile-less slide
    fails (a bundle has no zero-bag program) and is not recorded."""
    tree, add_slide = slide_tree
    add_slide("GHP_7_C_H&E.scn", ntiles=40)  # three chunks of 16
    out_b = _bundle(tmp_path)
    manifest = _int8_manifest(tree, tmp_path, with_empty=True)
    out = str(tmp_path / "serve_bundle")
    argv = ["--manifest", str(manifest), "--out_root", out, "--bundle",
            out_b, "--ckpt", "ignored.model", "--prewarm", "64"] + COMMON + [
                "--resolution", "24", "--roi_size", "48"]
    capsys.readouterr()
    n = gated_pool.LAUNCHES
    assert _run(argv) == 1  # the tile-less slide failed
    assert gated_pool.LAUNCHES == n  # the CPU op takes the plain version
    text = capsys.readouterr()
    assert "--ckpt ignored" in text.out
    assert "prewarm done (bundle" in text.out
    assert text.out.index("prewarm done") < text.out.index("probs=")
    assert "AOT bundles serve tiled slides only" in text.err
    rows = _parse(out)
    assert "AAA_empty_H&E" not in rows and len(rows) == 4
    clf = deploy.DeployedClassifier(out_b, device="cpu")
    for name, row in rows.items():
        b = RoiBuilder(str(tree / "slides" / f"{name}.scn"),
                       {"roi_size": 32}, device="cpu")
        probs, outs, _ = clf.classify_builder(b)
        np.testing.assert_allclose([float(p) for p in row[1:4]], probs,
                                   atol=1e-6, err_msg=name)
        assert int(row[4]) == int(outs["y_pred_hat"])
        assert int(row[6]) == b.getsize()
        attn = np.loadtxt(os.path.join(out,
                                       f"prediction-AGMIL-ACTF1.{name}.dla"))
        np.testing.assert_allclose(attn[:, 2], outs["Aterm"][0], atol=1e-5)
    # a second --once retries only the tile-less slide, which fails again
    assert _run(argv) == 1
    assert len(_rows(out)) == 4


@pytest.mark.parametrize("flag", [["--int8"], ["--batch", "2"],
                                  ["--mesh", "2"]])
def test_bundle_refuses_live_program_variants(slide_tree, tmp_path, flag):
    tree, _ = slide_tree
    with pytest.raises(SystemExit, match="recompose the live program"):
        _run(["--watch_dir", str(tree / "slides"), "--out_root",
              str(tmp_path / "x"), "--bundle", str(tmp_path / "b")]
             + flag + COMMON)
    assert not os.path.exists(tmp_path / "x")


def test_daemon_defaults_to_the_card(slide_tree, tmp_path, monkeypatch):
    """With no device argument the daemon runs on the card; a host with no
    card refuses instead of falling back to the CPU."""
    monkeypatch.setattr(serve.torch.cuda, "is_available", lambda: False)
    tree, _ = slide_tree
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--watch_dir", str(tree / "slides"), "--out_root",
                    str(tmp_path / "y")] + COMMON)


def test_port_daemon_matches_jax_daemon(slide_tree, tmp_path):
    """Both daemons, tiny arch in f32, one JAX-written checkpoint, one
    slide tree (a manifest, with a slide of 40 tiles that streams in three
    chunks): equal predictions and tile counts, probabilities and every
    .dla value within 1e-5."""
    tree, add_slide = slide_tree
    add_slide("GHP_7_C_H&E.scn", ntiles=40)
    jp = jax.jit(jamil.init_attention_mil, static_argnums=1)(
        jax.random.PRNGKey(21), jamil.MILConfig(widths=(8, 8, 8, 8),
                                                blocks=(1, 1, 1, 1)))
    ckpt = jckpt.save(str(tmp_path / "train_step-001.model"), jp)
    manifest = tmp_path / "slides.txt"
    manifest.write_text("\n".join(
        str(tree / "slides" / n)
        for n in sorted(os.listdir(tree / "slides"))) + "\n")
    common = ["--manifest", str(manifest), "--ckpt", ckpt] + COMMON
    out_j, out_t = str(tmp_path / "jax"), str(tmp_path / "port")
    assert jserve.main(common + ["--out_root", out_j]) == 0
    assert _run(common + ["--out_root", out_t]) == 0
    rj, rt = _parse(out_j), _parse(out_t)
    assert rj.keys() == rt.keys() and len(rj) == 4
    for name in rj:
        np.testing.assert_allclose([float(p) for p in rt[name][1:4]],
                                   [float(p) for p in rj[name][1:4]],
                                   atol=1e-5, err_msg=name)
        assert rt[name][4] == rj[name][4]  # pred
        assert rt[name][6] == rj[name][6]  # ntiles
        np.testing.assert_allclose(float(rt[name][5]), float(rj[name][5]),
                                   atol=1e-5)  # Aterm_var
    dj = sorted(f for f in os.listdir(out_j) if f.endswith(".dla"))
    assert dj == sorted(f for f in os.listdir(out_t) if f.endswith(".dla"))
    assert len(dj) == 16
    for f in dj:
        a = np.loadtxt(os.path.join(out_j, f))
        b = np.loadtxt(os.path.join(out_t, f))
        np.testing.assert_array_equal(b[:, :2], a[:, :2])
        np.testing.assert_allclose(b[:, 2], a[:, 2], atol=1e-5, err_msg=f)


def _int8_manifest(tree, tmp_path, with_empty):
    """A manifest of the tree's slides, behind a tile-less slide when
    ``with_empty`` (the oldest file, so the daemon takes it first)."""
    names = sorted(os.listdir(tree / "slides"))
    if with_empty:
        empty = tree / "slides" / "AAA_empty_H&E.scn"
        empty.write_bytes(b"fake")
        os.utime(empty, (1, 1))
        for kind, shape in (("data", (0, 32, 32, 3)), ("coor", (0, 2))):
            np.save(tree / "cache"
                    / f"{kind}_AAA_empty_H&E_rois_size32_hsvcut_v3.npy",
                    np.zeros(shape, np.uint8 if kind == "data" else np.int64))
        names = ["AAA_empty_H&E.scn"] + names
    manifest = tmp_path / "int8.txt"
    manifest.write_text("".join(str(tree / "slides" / n) + "\n"
                                for n in names))
    return manifest


def test_port_daemon_int8_matches_jax_daemon_int8(slide_tree, tmp_path):
    """Both daemons with ``--int8`` on one JAX-written checkpoint and one
    manifest (a 40-tile slide streams in three chunks): both calibrate on
    the first slide's 16 tiles and quantize the same weights bit for bit,
    so their rows agree within 1e-5 with equal predictions, and every .dla
    value within 1e-5."""
    tree, add_slide = slide_tree
    add_slide("GHP_7_C_H&E.scn", ntiles=40)
    jp = jax.jit(jamil.init_attention_mil, static_argnums=1)(
        jax.random.PRNGKey(21), jamil.MILConfig(widths=(8, 8, 8, 8),
                                                blocks=(1, 1, 1, 1)))
    ckpt = jckpt.save(str(tmp_path / "train_step-001.model"), jp)
    common = ["--manifest", str(_int8_manifest(tree, tmp_path, False)),
              "--ckpt", ckpt, "--int8", "--int8_calib", "16"] + COMMON
    out_j, out_t = str(tmp_path / "jax"), str(tmp_path / "port")
    assert jserve.main(common + ["--out_root", out_j]) == 0
    assert _run(common + ["--out_root", out_t]) == 0
    rj, rt = _parse(out_j), _parse(out_t)
    assert rj.keys() == rt.keys() and len(rj) == 4
    for name in rj:
        np.testing.assert_allclose([float(p) for p in rt[name][1:4]],
                                   [float(p) for p in rj[name][1:4]],
                                   atol=1e-5, err_msg=name)
        assert rt[name][4] == rj[name][4] and rt[name][6] == rj[name][6]
    for f in (f for f in os.listdir(out_j) if f.endswith(".dla")):
        np.testing.assert_allclose(np.loadtxt(os.path.join(out_t, f)),
                                   np.loadtxt(os.path.join(out_j, f)),
                                   atol=1e-5, err_msg=f)
    # and it is the quantized path: the float daemon's rows differ
    out_f = str(tmp_path / "f32")
    assert _run([a for a in common if a != "--int8"]
                + ["--out_root", out_f]) == 0
    assert any(_probs(out_f)[n] != _probs(out_t)[n] for n in rt)


def test_int8_calibration_deferred_past_an_empty_slide(slide_tree, tmp_path,
                                                       capsys):
    """A tile-less first slide must not calibrate the scales on the zeros
    fallback (every scale would floor to 1e-8); calibration waits for the
    next slide, and the rows equal a run whose manifest has no empty
    slide (tests/test_serve.py:136)."""
    tree, _ = slide_tree
    out_a, out_b = str(tmp_path / "plain"), str(tmp_path / "empty_first")
    argv = ["--int8", "--int8_calib", "16"] + COMMON
    assert _run(["--manifest", str(_int8_manifest(tree, tmp_path, False)),
                 "--out_root", out_a] + argv) == 0
    capsys.readouterr()
    assert _run(["--manifest", str(_int8_manifest(tree, tmp_path, True)),
                 "--out_root", out_b] + argv) == 0
    text = capsys.readouterr().out
    assert "int8 calibration deferred: AAA_empty_H&E has no tiles" in text
    assert "calibration tiles from GHP_1_A_H&E)" in text
    a, b = _probs(out_a), _probs(out_b)
    assert set(b) == set(a) | {"AAA_empty_H&E"}
    for name in a:
        assert b[name] == a[name], name
        assert max(a[name]) < 0.999  # floored scales would saturate


def test_int8_batched_matches_serial(slide_tree, tmp_path):
    """``--batch`` groups run through the int8 extractor: the rows equal
    the serial int8 run's within 1e-5 (calibrated on the same first
    slide)."""
    tree, _ = slide_tree
    m = str(_int8_manifest(tree, tmp_path, False))
    argv = ["--manifest", m, "--int8", "--int8_calib", "16"] + COMMON
    out_s, out_b = str(tmp_path / "serial"), str(tmp_path / "batched")
    assert _run(argv + ["--out_root", out_s]) == 0
    assert _run(argv + ["--out_root", out_b, "--batch", "3"]) == 0
    s, b = _probs(out_s), _probs(out_b)
    assert s.keys() == b.keys() and len(s) == 3
    for name in s:
        np.testing.assert_allclose(b[name], s[name], atol=1e-5)


def test_prewarm_skips_the_extractor_under_int8(slide_tree, tmp_path,
                                                capsys):
    tree, _ = slide_tree
    out = str(tmp_path / "serve_out")
    assert _run(["--watch_dir", str(tree / "slides"), "--out_root", out,
                 "--prewarm", "64", "--int8", "--int8_calib", "16"]
                + COMMON) == 0
    text = capsys.readouterr().out
    assert "prewarm skips the extractor under --int8" in text
    assert text.index("prewarm done") < text.index("extractor armed")
    assert len(_rows(out)) == 3


def test_write_map_matches_jax(tmp_path):
    rng = np.random.default_rng(4)
    raster = rng.integers(0, 5000, (17, 2))
    attn = rng.random((3, 17)).astype(np.float32)
    meta = {"basename": "GHP_5_X_H&E", "caMIC_study": "study7",
            "caMIC_id_name": "slide-5"}
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    mj, mt = io.StringIO(), io.StringIO()
    fj = jhelpers.write_map(meta, 0, raster, attn, manifest=mj,
                            output_dir=str(tmp_path / "jax"))
    ft = thelpers.write_map(meta, 0, raster, attn, manifest=mt,
                            output_dir=str(tmp_path / "port"))
    assert [os.path.basename(f) for f in ft] == \
        [os.path.basename(f) for f in fj]
    for a, b in zip(fj, ft):
        assert open(b).read() == open(a).read()
    row_t, row_j = mt.getvalue().split(","), mj.getvalue().split(",")
    assert os.path.basename(row_t[0]) == os.path.basename(row_j[0])
    assert row_t[1:] == row_j[1:] == ["study7", "slide-5", "slide-5\n"]
    # a tile-less slide writes empty maps, a 1-D map is map 0
    assert thelpers.write_map(meta, 0, np.zeros((0, 2)), np.zeros((3, 0)),
                              output_dir=str(tmp_path / "port"))
    ft = thelpers.write_map(meta, 0, raster, attn[0],
                            output_dir=str(tmp_path / "port"))
    assert len(ft) == 2


@pytest.mark.parametrize("arch,stem,cw", [("full", "conv7", None),
                                          ("tiny", "s2d", (1.0, 2.0, 0.5))])
def test_make_config_matches_jax(arch, stem, cw):
    class Args:
        pass

    args = Args()
    args.arch, args.stem, args.remat = arch, stem, True
    jc = jclassify.make_config(args, cw)
    tc = tclassify.make_config(args, cw)
    for field in ("L", "D", "K", "O", "n_classes", "smoothing", "dropout",
                  "train_tile_fraction", "stem", "class_weights", "widths",
                  "blocks"):
        assert getattr(tc, field) == getattr(jc, field), field
