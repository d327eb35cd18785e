"""The port's AOT serving bundles (deploy.py), held to its live streaming
path and to the JAX package's bundles.

Mirrors every case of tests/test_deploy.py on the port with
``device="cpu"``: a bundle of a tiny model classifies like
``classify_slide_streaming`` (float32: probabilities within 1e-5,
``Aterm`` within 1e-4, the JAX test's bounds) at T = 1, 5, 41 and
``max_tiles``; it loads and serves with every model builder of the port
poisoned; the guards, the platform gate, ``swap_weights`` and the CLI.
Then against JAX on carried-over weights (``utils/interop.py``): the
port's bundle equals JAX's ``DeployedClassifier`` and JAX's
``classify_slide_streaming`` within the same bounds, each package refuses
the other's bundle with a clear message, and JAX reads the port's
``weights.model`` exactly. JAX exports and serves once per module."""

import json
import os
import shutil

import numpy as np
import pytest
import torch

import conftest  # noqa: F401
import jax
import jax.numpy as jnp

from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu import (
    deploy as jdeploy,
)
from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu.data import (
    roibuilder as jroibuilder,
)
from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu.models import (
    attention_mil as jamil,
)
from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu.parallel import (
    inference as jinference,
)
from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu.train import (
    checkpoint as jckpt,
)
from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch import (
    deploy,
)
from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.data import (
    loader,
    roibuilder,
)
from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.models import (
    attention_mil as amil,
    resnet,
)
from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.ops import (
    gated_pool,
)
from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.parallel import (
    inference,
)
from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.utils import (
    interop,
)

TINY = dict(widths=(8, 8, 8, 8), blocks=(1, 1, 1, 1))
CFG = amil.MILConfig(**TINY)
JCFG = jamil.MILConfig(**TINY)
EXPORT = dict(resolution=16, roi_size=32, chunk=16, tiles=64)
MAX_TILES = EXPORT["tiles"]
PARITY_T = (5, 41)


def _tiles(n, roi=32, seed=0):
    rng = np.random.default_rng(seed)
    return np.clip(np.array([140, 60, 170], np.int16)
                   + rng.integers(-40, 40, (n, roi, roi, 3)),
                   0, 255).astype(np.uint8)


def _cache_slide(cache, name, tiles):
    for kind, arr in (("data", tiles),
                      ("coor", np.zeros((len(tiles), 2), np.int64))):
        np.save(os.path.join(cache, f"{kind}_{name}_rois_size32_hsvcut_v3.npy"),
                arr)


@pytest.fixture(scope="module")
def jax_params():
    p = jax.jit(jamil.init_attention_mil, static_argnums=1)(
        jax.random.PRNGKey(0), JCFG)
    return jax.tree_util.tree_map(np.asarray, p)


@pytest.fixture(scope="module")
def model(jax_params):
    """The port's model with the JAX weights carried over."""
    m = amil.AttentionMIL(CFG, device="cpu")
    interop.load_jax_params(m, jax_params)
    return m.eval()


@pytest.fixture(scope="module")
def bundle_dir(model, tmp_path_factory):
    """One float32 bundle of the module, exported once; tests that edit it
    take a copy (``bundle``)."""
    out = str(tmp_path_factory.mktemp("port") / "bundle")
    deploy.export_serving_bundle(model, CFG, out, compute_dtype=torch.float32,
                                 **EXPORT)
    return out


@pytest.fixture
def bundle(bundle_dir, tmp_path):
    out = str(tmp_path / "bundle")
    shutil.copytree(bundle_dir, out)
    return out


@pytest.fixture(scope="module")
def slides(tmp_path_factory):
    """A slide cache directory: T tiles each at T = 1, 5, 41 and 64."""
    cache = str(tmp_path_factory.mktemp("cache"))
    sizes = sorted({1, *PARITY_T, MAX_TILES})
    for T in sizes:
        _cache_slide(cache, f"GHP_{T}_A_H&E", _tiles(T, seed=T))
    return cache, sizes


def _builder(cache, T, monkeypatch, pkg=roibuilder, **kw):
    monkeypatch.setenv("CACHE_DIR", cache)
    b = pkg.RoiBuilder(os.path.join(cache, f"GHP_{T}_A_H&E.npy"),
                       {"roi_size": 32}, **kw)
    b.update_resolution_and_buffer(EXPORT["resolution"])
    return b


def _manifest(out, **changes):
    path = os.path.join(out, deploy.MANIFEST)
    with open(path) as f:
        m = json.load(f)
    m.update(changes)
    with open(path, "w") as f:
        json.dump(m, f)
    return m


def test_manifest_and_files(bundle_dir):
    """JAX's manifest keys where they mean the same, a version the JAX
    loader refuses, programs that carry no weights."""
    with open(os.path.join(bundle_dir, deploy.MANIFEST)) as f:
        m = json.load(f)
    assert m["bundle_version"] == "torch-1"
    assert m["torch_version"] == torch.__version__
    assert m["platforms"] == ["cpu"]
    assert m["compute_dtype"] == "float32"
    assert (m["resolution"], m["roi_size"], m["chunk"], m["max_tiles"]) == (
        16, 32, 16, 64)
    assert (m["feature_dim"], m["n_classes"]) == (CFG.L, CFG.n_classes)
    assert m["config"]["widths"] == list(CFG.widths)
    assert m["programs"] == {"extract": "extract.pt2", "pool": "pool.pt2"}
    assert sorted(os.listdir(bundle_dir)) == sorted(
        [deploy.MANIFEST, deploy.WEIGHTS, "extract.pt2", "pool.pt2"])
    for name in m["programs"].values():
        prog = torch.export.load(os.path.join(bundle_dir, name))
        assert not prog.state_dict and not prog.constants
        assert prog.example_inputs is None


@pytest.mark.parametrize("T", sorted({1, *PARITY_T, MAX_TILES}))
def test_bundle_matches_live_streaming(bundle_dir, model, slides, T,
                                       monkeypatch):
    """The exported programs == the live classify_slide_streaming, at one
    tile, below one chunk, across three chunks and at max_tiles."""
    cache, _ = slides
    clf = deploy.DeployedClassifier(bundle_dir, device="cpu")
    b = _builder(cache, T, monkeypatch, device="cpu")
    probs_live, outs_live, _ = inference.classify_slide_streaming(
        model, CFG, b, resolution=16, chunk=16, compute_dtype=None)
    n = gated_pool.LAUNCHES
    probs_dep, outs_dep, coords = clf.classify_builder(b)
    assert gated_pool.LAUNCHES == n  # the CPU op takes the plain version
    np.testing.assert_allclose(probs_dep, probs_live, atol=1e-5)
    np.testing.assert_allclose(outs_dep["Aterm"], outs_live["Aterm"],
                               atol=1e-4)
    assert sorted(outs_dep) == sorted(outs_live)
    assert outs_dep["Aterm"].shape == (CFG.K, T) and coords.shape == (T, 2)
    assert outs_dep["Fterm"].shape == (T, CFG.L)
    assert int(outs_dep["y_pred_hat"]) == int(outs_live["y_pred_hat"])


def test_bundle_is_model_code_free(bundle_dir, monkeypatch):
    """Loading and classifying must not reach the port's model code: its
    builders and module entry points are poisoned."""
    def boom(*a, **k):
        raise AssertionError("model code called on the deploy path")

    for obj, name in ((resnet, "init_resnet26"), (resnet, "apply_resnet26"),
                      (resnet.ResNet26, "forward"),
                      (amil, "init_attention_mil"),
                      (amil.AttentionMIL, "__init__"),
                      (amil, "attention_pool"),
                      (amil, "apply_attention_mil"),
                      (inference, "make_transform_extract")):
        monkeypatch.setattr(obj, name, boom)
    clf = deploy.DeployedClassifier(bundle_dir, device="cpu")
    probs, outs = clf.classify(_tiles(7))
    assert abs(probs.sum() - 1.0) < 1e-5
    assert outs["Fterm"].shape == (7, CFG.L)


def test_bundle_guards(bundle):
    clf = deploy.DeployedClassifier(bundle, device="cpu")
    with pytest.raises(ValueError, match="max_tiles"):
        clf.classify(_tiles(MAX_TILES + 1))
    with pytest.raises(ValueError, match="tile-less"):
        clf.classify(_tiles(0))
    with pytest.raises(ValueError, match="the bundle takes"):
        clf.classify(_tiles(3, roi=16))
    # the version gate
    _manifest(bundle, bundle_version="torch-999")
    with pytest.raises(ValueError, match="bundle version torch-999"):
        deploy.DeployedClassifier(bundle, device="cpu")


def test_bundle_needs_no_ladder(bundle_dir, monkeypatch):
    """One program with a dynamic tile dimension serves every size: no
    bucket ladder is consulted, and the outputs have exactly T rows."""
    def poisoned(*a, **k):
        raise AssertionError("bundle classify consulted a bucket ladder")

    monkeypatch.setattr(loader, "bucket_for", poisoned)
    monkeypatch.setattr(loader, "pad_bag", poisoned)
    clf = deploy.DeployedClassifier(bundle_dir, device="cpu")
    for T in (5, 17, 41, 64):  # below chunk, off-ladder, multi-chunk, max
        probs, outs = clf.classify(_tiles(T, seed=T))
        assert abs(probs.sum() - 1.0) < 1e-5
        assert outs["Aterm"].shape[1] == T
        assert outs["wROIs"].shape[1] == T
        assert outs["Bterm"].shape[0] == T


def test_bundle_platform_gate(bundle):
    """A platform-mismatched bundle fails at load, not per slide in the
    daemon's drain loop."""
    _manifest(bundle, platforms=["nonexistent_backend"])
    with pytest.raises(ValueError, match="exported for platforms"):
        deploy.DeployedClassifier(bundle, device="cpu")


def test_bundle_platform_gate_gpu_canonicalization(bundle, monkeypatch):
    """The gate tells the two GPU stacks apart (a cuda bundle does not
    load on a rocm host), matches a legacy 'gpu' entry on a GPU host, and
    names only canonical platforms."""
    _manifest(bundle, platforms=["cuda"])
    monkeypatch.setattr(deploy, "_canonical_backend", lambda device: "rocm")
    with pytest.raises(ValueError) as e:
        deploy.DeployedClassifier(bundle, device="cpu")
    assert "['cuda']" in str(e.value) and "--platforms rocm" in str(e.value)
    assert "'gpu'" not in str(e.value)

    monkeypatch.setattr(deploy, "_canonical_backend", lambda device: "cuda")
    deploy.DeployedClassifier(bundle, device="cpu")

    # a legacy 'gpu' entry loads on a GPU host of either stack
    _manifest(bundle, platforms=["gpu"])
    deploy.DeployedClassifier(bundle, device="cpu")
    monkeypatch.setattr(deploy, "_canonical_backend", lambda device: "rocm")
    deploy.DeployedClassifier(bundle, device="cpu")

    # but not on a cpu host, and the message reads 'gpu' as 'cuda'
    monkeypatch.setattr(deploy, "_canonical_backend", lambda device: "cpu")
    with pytest.raises(ValueError) as e:
        deploy.DeployedClassifier(bundle, device="cpu")
    assert "['cuda']" in str(e.value) and "--platforms cpu" in str(e.value)
    assert "'gpu'" not in str(e.value)


def test_canonical_backend():
    assert deploy._canonical_backend(torch.device("cpu")) == "cpu"
    want = "rocm" if torch.version.hip else "cuda"
    assert deploy._canonical_backend(torch.device("cuda", 0)) == want


def test_swap_weights(bundle_dir, model):
    """Re-trained weights of the same shapes reuse the programs; other
    shapes and other dtypes are refused."""
    clf = deploy.DeployedClassifier(bundle_dir, device="cpu")
    tiles = _tiles(9)
    p0 = clf.classify(tiles)[0]
    state = {k: v.detach() * 1.5 for k, v in model.state_dict().items()}
    clf.swap_weights(state)
    p1 = clf.classify(tiles)[0]
    assert not np.allclose(p0, p1)
    # equal to the live path on the bumped weights
    bumped = amil.AttentionMIL(CFG, device="cpu")
    bumped.load_state_dict(state)
    live = inference.make_transform_extract(CFG, resolution=16,
                                            compute_dtype=None)
    with torch.no_grad():
        H = live(bumped.cnn, torch.from_numpy(tiles))
        logits = amil.attention_pool(bumped, H, CFG)["logits"]
    np.testing.assert_allclose(p1, torch.softmax(logits, 1).numpy().ravel(),
                               atol=1e-5)
    wrong = amil.init_attention_mil(
        torch.Generator().manual_seed(1),
        amil.MILConfig(widths=(4, 4, 4, 4), blocks=(1, 1, 1, 1)),
        device="cpu")
    with pytest.raises(ValueError, match="does not match bundle"):
        clf.swap_weights(wrong.state_dict())
    with pytest.raises(ValueError, match="do not match bundle"):
        clf.swap_weights({k: v for k, v in state.items()
                          if not k.startswith("cnn.fc")})
    with pytest.raises(ValueError, match="does not match bundle"):
        clf.swap_weights({k: v.to(torch.bfloat16) for k, v in state.items()})


def test_deploy_cli_roundtrip(tmp_path, monkeypatch, capsys):
    cache = tmp_path / "cache"
    cache.mkdir()
    monkeypatch.setenv("CACHE_DIR", str(cache))
    base = "GHP_7_B_H&E"
    _cache_slide(str(cache), base, _tiles(12))
    slide = tmp_path / f"{base}.npy"
    slide.write_bytes(b"fake")  # a cache hit: the file is never read

    out = str(tmp_path / "bundle")
    flags = ["--out", out, "--arch", "tiny", "--resolution", "16",
             "--roi_size", "32", "--chunk", "16", "--tiles", "64", "--f32"]
    assert deploy.main(["export", *flags], device="cpu") == 0
    assert os.path.isfile(os.path.join(out, deploy.MANIFEST))
    capsys.readouterr()
    assert deploy.main(["run", "--bundle", out, "--slide", str(slide)],
                       device="cpu") == 0
    row = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert row["name"] == base and row["ntiles"] == 12
    assert abs(sum(row["probs"]) - 1.0) < 1e-5
    # a bundle serves on its export device only
    with pytest.raises(SystemExit, match="export device only"):
        deploy.main(["export", *flags, "--platforms", "cpu,cuda"],
                    device="cpu")


def test_export_refuses_bounds_it_cannot_trace(model, tmp_path):
    with pytest.raises(ValueError, match="chunk >= 2"):
        deploy.export_serving_bundle(model, CFG, str(tmp_path), chunk=1,
                                     **{k: v for k, v in EXPORT.items()
                                        if k != "chunk"})
    with pytest.raises(ValueError, match="32-bit"):
        deploy.export_serving_bundle(model, CFG, str(tmp_path),
                                     tiles=2**31 // CFG.K, resolution=16,
                                     roi_size=32, chunk=16)


def test_classifier_defaults_to_the_card(bundle_dir, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        deploy.DeployedClassifier(bundle_dir)


# ---------------------------------------------------------------- vs JAX
@pytest.fixture(scope="module")
def jax_bundle(jax_params, tmp_path_factory):
    out = str(tmp_path_factory.mktemp("jax") / "bundle")
    jdeploy.export_serving_bundle(jax_params, JCFG, out,
                                  compute_dtype=jnp.float32, **EXPORT)
    return out


@pytest.fixture(scope="module")
def jax_results(jax_params, jax_bundle, slides):
    """JAX's bundle and JAX's live streaming on the parity slides, once."""
    cache, _ = slides
    mp = pytest.MonkeyPatch()
    clf = jdeploy.DeployedClassifier(jax_bundle)
    out = {}
    try:
        for T in PARITY_T:
            b = _builder(cache, T, mp, pkg=jroibuilder)
            live = jinference.classify_slide_streaming(
                jax_params, JCFG, b, resolution=16, chunk=16,
                compute_dtype=jnp.float32)
            out[T] = {"live": live, "bundle": clf.classify_builder(b)}
    finally:
        mp.undo()
    return out


@pytest.mark.parametrize("T", PARITY_T)
def test_bundle_matches_jax(bundle_dir, slides, jax_results, T, monkeypatch):
    """The port's bundle against JAX's bundle and JAX's live streaming, on
    the same weights: probabilities within 1e-5, Aterm within 1e-4."""
    cache, _ = slides
    clf = deploy.DeployedClassifier(bundle_dir, device="cpu")
    probs, outs, _ = clf.classify_builder(
        _builder(cache, T, monkeypatch, device="cpu"))
    for key in ("bundle", "live"):
        j_probs, j_outs, _ = jax_results[T][key]
        np.testing.assert_allclose(probs, np.asarray(j_probs), atol=1e-5,
                                   err_msg=key)
        np.testing.assert_allclose(outs["Aterm"],
                                   np.asarray(j_outs["Aterm"])[:, :T],
                                   atol=1e-4, err_msg=key)
        assert int(outs["y_pred_hat"]) == int(j_outs["y_pred_hat"])


def test_each_package_refuses_the_others_bundle(bundle_dir, jax_bundle):
    with pytest.raises(ValueError, match="JAX-package bundle"):
        deploy.DeployedClassifier(jax_bundle, device="cpu")
    with pytest.raises(ValueError, match="bundle version torch-1 != "
                                         "supported 1"):
        jdeploy.DeployedClassifier(bundle_dir)


def test_jax_reads_the_port_weights(bundle_dir, jax_params):
    """JAX's checkpoint reader restores the bundle's weights.model to the
    carried-over parameters exactly."""
    path = os.path.join(bundle_dir, deploy.WEIGHTS)
    blob = jckpt.load_raw(path)
    assert all(k.startswith("classifier/") for k in blob)
    template = jax.tree_util.tree_map(np.zeros_like, jax_params)
    restored, loaded, skipped = jckpt.restore_params(template, path,
                                                     strict=True)
    assert not skipped
    flat_a = jax.tree_util.tree_leaves_with_path(restored)
    flat_b = jax.tree_util.tree_leaves_with_path(jax_params)
    assert len(flat_a) == len(flat_b) == len(loaded)
    for (pa, a), (pb, b) in zip(flat_a, flat_b):
        assert pa == pb
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
