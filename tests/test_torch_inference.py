"""The port's serving path against the JAX package: transforms, bucketing,
the RoiBuilder cache, and one-pass / streaming slide classification (the
port at the slide's exact size, JAX padded to its bucket and trimmed).

Tolerances: eval_transform 1e-6 (torch's and JAX's anti-aliased bilinear
agree to ~2e-7 when downsampling), slide outputs in f32 1e-5 (the JAX
package's own streaming-vs-one-pass bound)."""

import os

import numpy as np
import pytest
import torch

import conftest  # noqa: F401
import jax
import jax.numpy as jnp
from torch_jax_native import private_jax_native

from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu.data import (
    loader as jloader,
    roibuilder as jroi,
    slide_io as jslide_io,
    transforms as jtransforms,
)
from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu.models import (
    attention_mil as jamil,
)
from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu.parallel import (
    inference as jinf,
)
from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.data import (
    loader as tloader,
    roibuilder as troi,
    slide_io as tslide_io,
    tissue as ttissue,
    transforms as ttransforms,
)
from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.models import (
    attention_mil as tamil,
)
from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.parallel import (
    inference as tinf,
)
from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.utils import (
    interop,
)

JCFG = jamil.MILConfig(widths=(8, 8, 8, 8), blocks=(1, 1, 1, 1))
TCFG = tamil.MILConfig(widths=(8, 8, 8, 8), blocks=(1, 1, 1, 1))


@pytest.fixture(scope="module", autouse=True)
def _jax_native_of_its_own(tmp_path_factory):
    """The JAX package's cache builds load its native filter from a
    directory of this module's own (``torch_jax_native``), never the one
    beside its source, which other pytest workers may be writing."""
    with private_jax_native(tmp_path_factory.mktemp("jax_native")):
        yield


@pytest.fixture(scope="module")
def models():
    jp = jax.jit(jamil.init_attention_mil, static_argnums=1)(
        jax.random.PRNGKey(0), JCFG)
    model = interop.load_jax_params(tamil.AttentionMIL(TCFG, device="cpu"),
                                    jp).eval()
    return jp, model


def _tissue_slide(seed, size):
    """Purple H&E-like noise with a white (background) band and a flat
    (low-contrast) block, so the filter keeps some tiles and drops others."""
    rng = np.random.default_rng(seed)
    base = np.array([140, 60, 170], np.int16)
    img = np.clip(base + rng.integers(-40, 40, (size, size, 3)), 0,
                  255).astype(np.uint8)
    img[:, : size // 4] = 245
    img[size // 2:, size // 2:] = (150, 70, 170)
    return img


@pytest.mark.parametrize("src,res", [(64, 32), (400, 300), (32, 32)])
def test_eval_transform_matches_jax(src, res):
    x = np.random.default_rng(0).integers(0, 256, (3, src, src, 3),
                                          dtype=np.uint8)
    want = np.asarray(jtransforms.eval_transform(jnp.asarray(x),
                                                 resolution=res))
    got = ttransforms.eval_transform(torch.from_numpy(x), resolution=res)
    assert tuple(got.shape) == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)


def test_normalize_and_resize_u8_match_jax():
    x = np.random.default_rng(1).integers(0, 256, (2, 64, 64, 3),
                                          dtype=np.uint8)
    np.testing.assert_allclose(
        ttransforms.normalize_u8(torch.from_numpy(x)).numpy(),
        np.asarray(jtransforms.normalize_u8(jnp.asarray(x))), atol=1e-7)
    got = ttransforms.resize_u8(torch.from_numpy(x), resolution=32).numpy()
    want = np.asarray(jtransforms.resize_u8(jnp.asarray(x), resolution=32))
    assert got.dtype == np.uint8
    # rounding of values within ~1e-5 of k + 0.5 may go either way
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_apply_chunked_matches_single_call():
    x = np.random.default_rng(2).integers(0, 256, (11, 40, 40, 3),
                                          dtype=np.uint8)
    got = ttransforms.apply_chunked(ttransforms.eval_transform, x,
                                    device="cpu", chunk=4, resolution=32)
    want = ttransforms.eval_transform(torch.from_numpy(x), resolution=32)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    with pytest.raises(ValueError):
        ttransforms.apply_chunked(ttransforms.eval_transform, x[:0],
                                  device="cpu", resolution=32)


def test_bucketing_and_chunks_match_jax(tmp_path, monkeypatch, models):
    """The port's bucket ladder is JAX's. JAX streams in chunks clamped to
    that ladder; the port streams in the user's chunk as given, and the
    result does not depend on the chunk (a tail chunk, one tile at a time,
    a chunk longer than the slide)."""
    assert tloader.DEFAULT_BUCKETS == jloader.DEFAULT_BUCKETS
    for n in [1, 5, 31, 32, 33, 100, 2047, 2048, 2049, 2560, 2561, 3000,
              5000, 50_000]:
        assert tloader.bucket_for(n) == jloader.bucket_for(n), n
    jp, model = models
    jb, tb = _builders(tmp_path, monkeypatch, _tissue_slide(8, 300),
                       "k_H&E", 64)
    jb.build()
    tb.build()
    jprobs, jouts, _ = jinf.classify_slide_streaming(
        jp, JCFG, jb, resolution=32, chunk=8, compute_dtype=None)
    for chunk in (1, 5, 1024):
        probs, outs, _ = tinf.classify_slide_streaming(
            model, TCFG, tb, resolution=32, chunk=chunk, compute_dtype=None)
        np.testing.assert_allclose(probs, jprobs, atol=1e-5, err_msg=chunk)
        np.testing.assert_allclose(outs["Fterm"], jouts["Fterm"], atol=1e-5,
                                   err_msg=chunk)


@pytest.mark.parametrize("t,n_tiles", [(13, None), (32, None), (5, 8)])
def test_pad_bag_matches_jax(t, n_tiles):
    x = np.random.default_rng(3).standard_normal((t, 2, 2, 3)).astype(
        np.float32)
    jt, jm = jloader.pad_bag(jnp.asarray(x), n_tiles)
    tt, tm = tloader.pad_bag(torch.from_numpy(x), n_tiles)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    with pytest.raises(ValueError):
        tloader.pad_bag(torch.from_numpy(x), t - 1)


def test_tissue_filters_agree():
    """The torch batch filter and the numpy one keep the same tiles."""
    img = _tissue_slide(4, 400)
    raster = ttissue.sliding_window(img.shape, 64)
    stack = np.stack([img[x:x + 64, y:y + 64] for x, y in raster])
    keep = ttissue.tissue_mask_batch(torch.from_numpy(stack)).numpy()
    assert keep.any() and not keep.all()
    assert list(keep) == [ttissue.is_tissue(t) for t in stack]


def _builders(tmp_path, monkeypatch, img, name, roi):
    """A JAX and a port RoiBuilder of one slide, each with its own cache
    directory (the cache filenames are the same)."""
    out = []
    for tag, roi_mod, io in (("jax", jroi, jslide_io),
                             ("port", troi, tslide_io)):
        d = tmp_path / tag
        d.mkdir(exist_ok=True)
        monkeypatch.setenv("CACHE_DIR", str(d))
        path = io.write_synthetic_slide(str(d / f"{name}.npy"), img)
        kw = {} if tag == "jax" else {"device": "cpu"}
        out.append(roi_mod.RoiBuilder(path, {"roi_size": roi}, **kw))
    return out


def test_roibuilder_cache_identical_to_jax(tmp_path, monkeypatch):
    jb, tb = _builders(tmp_path, monkeypatch, _tissue_slide(5, 400),
                       "s_H&E", 64)
    assert jb.params["status"] == tb.params["status"] == "CACHE MISSING"
    assert jb.build() and tb.build()
    assert tb.params["status"] == "VALID" and tb.getsize() == jb.getsize()
    assert os.path.basename(tb.params["data_cache"]) == \
        os.path.basename(jb.params["data_cache"])
    np.testing.assert_array_equal(np.load(tb.params["data_cache"]),
                                  np.load(jb.params["data_cache"]))
    np.testing.assert_array_equal(np.load(tb.params["coor_cache"]),
                                  np.load(jb.params["coor_cache"]))
    with pytest.raises(RuntimeError, match="not armed"):
        tb.get_inference_data()
    # roi 64 > resolution 32: the f32 eval cache, under the JAX filename
    jb.update_resolution_and_buffer(32)
    tb.update_resolution_and_buffer(32)
    jt, jc, _ = jb.get_inference_data()
    tt, tc, _ = tb.get_inference_data()
    assert os.path.basename(tb._eval_cache_path()) == \
        os.path.basename(jb._eval_cache_path())
    assert os.path.isfile(tb._eval_cache_path())
    np.testing.assert_array_equal(tc, jc)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), atol=1e-6)
    # a second read comes from the eval cache and is the same tensor
    np.testing.assert_array_equal(tb.get_validation_data().numpy(),
                                  tt.numpy())


@pytest.mark.parametrize("size", [300, 400])
def test_classify_slide_paths_match_jax(tmp_path, monkeypatch, models, size):
    jp, model = models
    jb, tb = _builders(tmp_path, monkeypatch, _tissue_slide(6, size),
                       "c_H&E", 64)
    jb.build()
    tb.build()
    jprobs, jouts, jcoords = jinf.classify_slide(
        jp, JCFG, jb, resolution=32, compute_dtype=None,
        use_pallas_pool=True)
    probs, outs, coords = tinf.classify_slide(model, TCFG, tb, resolution=32,
                                              compute_dtype=None)
    sprobs, souts, scoords = tinf.classify_slide_streaming(
        model, TCFG, tb, resolution=32, chunk=7, compute_dtype=None)
    T = tb.getsize()
    np.testing.assert_array_equal(coords, jcoords)
    np.testing.assert_array_equal(scoords, jcoords)
    assert probs.shape == sprobs.shape == (3,)
    np.testing.assert_allclose(probs.sum(), 1.0, atol=1e-6)
    for k in ("Aterm", "wROIs", "Fterm", "Bterm"):
        assert outs[k].shape == souts[k].shape == np.asarray(jouts[k]).shape
    np.testing.assert_allclose(probs, jprobs, atol=1e-5)
    np.testing.assert_allclose(outs["Aterm"], jouts["Aterm"], atol=1e-5)
    np.testing.assert_allclose(outs["Fterm"], jouts["Fterm"], atol=1e-5)
    # streaming equals one-pass
    assert outs["Aterm"].shape == (3, T)
    np.testing.assert_allclose(sprobs, probs, atol=1e-5)
    for k in ("Aterm", "wROIs", "Fterm", "Bterm", "Mterm"):
        np.testing.assert_allclose(souts[k], outs[k], atol=1e-5, err_msg=k)
    assert int(souts["y_pred_hat"]) == int(outs["y_pred_hat"])


def test_streaming_eval_outputs_match_jax(tmp_path, monkeypatch, models):
    jp, model = models
    jb, tb = _builders(tmp_path, monkeypatch, _tissue_slide(7, 300),
                       "e_H&E", 64)
    jb.build()
    tb.build()
    _, jouts, _ = jinf.classify_slide_streaming(jp, JCFG, jb, resolution=32,
                                                chunk=8, compute_dtype=None)
    _, touts, _ = tinf.classify_slide_streaming(model, TCFG, tb,
                                                resolution=32, chunk=8,
                                                compute_dtype=None)
    want = jinf.streaming_eval_outputs(jouts, 2, JCFG)
    got = tinf.streaming_eval_outputs(touts, 2, TCFG)
    for k in ("loss", "error", "KLD"):
        np.testing.assert_allclose(got[k], np.asarray(want[k]), atol=1e-5,
                                   err_msg=k)


@pytest.mark.parametrize("path", ["classify_slide",
                                  "classify_slide_streaming"])
def test_serving_refuses_model_and_builder_on_different_devices(
        tmp_path, monkeypatch, path):
    """A bag is never moved between devices behind the caller's back: a
    model on one device and a RoiBuilder on another raise before any work."""
    monkeypatch.setenv("CACHE_DIR", str(tmp_path))
    builder = troi.RoiBuilder(str(tmp_path / "m_H&E.npy"), {"roi_size": 64},
                              device="cpu")
    model = tamil.AttentionMIL(TCFG, device="meta")
    with pytest.raises(ValueError, match="RoiBuilder builds bags on cpu"):
        getattr(tinf, path)(model, TCFG, builder, resolution=32,
                            compute_dtype=None)
    assert builder.params["status"] == "CACHE MISSING"


def test_empty_slide_same_on_both_paths(tmp_path, monkeypatch, models):
    """A tile-less slide classifies identically on the streaming and the
    one-pass path (both feed the f32 zero bag), and as the JAX package."""
    jp, model = models
    monkeypatch.setenv("CACHE_DIR", str(tmp_path))
    (tmp_path / "empty_H&E.npy").write_bytes(b"fake")
    np.save(tmp_path / "data_empty_H&E_rois_size64_hsvcut_v3.npy",
            np.zeros((0, 64, 64, 3), np.uint8))
    np.save(tmp_path / "coor_empty_H&E_rois_size64_hsvcut_v3.npy",
            np.zeros((0, 2), np.int64))
    builder = troi.RoiBuilder(str(tmp_path / "empty_H&E.npy"),
                              {"roi_size": 64}, device="cpu")
    assert builder.params["status"] == "VALID"
    p_stream, _, coords_s = tinf.classify_slide_streaming(
        model, TCFG, builder, resolution=32, chunk=8, compute_dtype=None)
    p_once, _, coords_o = tinf.classify_slide(
        model, TCFG, builder, resolution=32, compute_dtype=None)
    assert coords_s.shape[0] == coords_o.shape[0] == 0
    np.testing.assert_array_equal(p_stream, p_once)
    jb = jroi.RoiBuilder(str(tmp_path / "empty_H&E.npy"), {"roi_size": 64})
    p_jax, _, _ = jinf.classify_slide(jp, JCFG, jb, resolution=32,
                                      compute_dtype=None)
    np.testing.assert_allclose(p_once, p_jax, atol=1e-5)


def test_transform_extract_default_passed_explicitly_is_the_default(
        tmp_path, monkeypatch, models):
    """The hook: passing the default per-chunk program explicitly gives
    the outputs of passing none, and any (cnn, raw uint8 chunk) -> [N, L]
    function replaces it."""
    _, model = models
    jb, tb = _builders(tmp_path, monkeypatch, _tissue_slide(9, 300),
                       "h_H&E", 64)
    tb.build()
    probs, outs, _ = tinf.classify_slide_streaming(
        model, TCFG, tb, resolution=32, chunk=5, compute_dtype=None)
    default = tinf.make_transform_extract(TCFG, resolution=32,
                                          compute_dtype=None)
    seen = []

    def spy(cnn, raw_u8):
        assert cnn is model.cnn and raw_u8.dtype == torch.uint8
        seen.append(raw_u8.shape[0])
        return default(cnn, raw_u8)

    probs2, outs2, _ = tinf.classify_slide_streaming(
        model, TCFG, tb, resolution=32, chunk=5, compute_dtype=None,
        transform_extract=spy)
    assert sum(seen) == tb.getsize() and max(seen) == 5
    np.testing.assert_array_equal(probs2, probs)
    for k in ("Aterm", "Fterm", "Mterm"):
        np.testing.assert_array_equal(outs2[k], outs[k])


def _small_bags(seed, sizes, res=32):
    rng = np.random.default_rng(seed)
    return [np.clip(np.array([140, 60, 170], np.int16)
                    + rng.integers(-40, 40, (t, res, res, 3)), 0,
                    255).astype(np.uint8) for t in sizes]


def test_classify_slides_batched_matches_jax_and_serial(models):
    """One extractor call over the group, one pool per slide: the same
    outputs as JAX's padded batched forward (trimmed) and as the port's
    one-pass forward of each slide alone."""
    jp, model = models
    raw = _small_bags(10, (5, 13, 1))
    bags = [jtransforms.eval_transform(jnp.asarray(b), resolution=32)
            for b in raw]
    jprobs, jouts = jinf.classify_slides_batched(jp, JCFG, bags,
                                                 compute_dtype=None)
    probs, outs = tinf.classify_slides_batched(
        model, TCFG, [np.asarray(b) for b in bags], compute_dtype=None)
    assert probs.shape == (3, 3)
    np.testing.assert_allclose(probs, jprobs, atol=1e-5)
    np.testing.assert_allclose(outs["Aterm_var"],
                               np.asarray(jouts["Aterm_var"]), atol=1e-5)
    np.testing.assert_array_equal(outs["y_pred_hat"],
                                  np.asarray(jouts["y_pred_hat"]).ravel())
    for i, b in enumerate(bags):
        T = b.shape[0]
        np.testing.assert_allclose(outs["Aterm"][i],
                                   np.asarray(jouts["Aterm"])[i][:, :T],
                                   atol=1e-5)
        one = tamil.apply_attention_mil(model, torch.from_numpy(
            np.array(b)), 0, TCFG)
        np.testing.assert_allclose(probs[i], one["y_pred"].numpy().ravel(),
                                   atol=1e-5)
        np.testing.assert_allclose(outs["Aterm"][i], one["Aterm"].numpy(),
                                   atol=1e-5)
        np.testing.assert_allclose(outs["Mterm"][i], one["Mterm"].numpy(),
                                   atol=1e-5)

    # raw uint8 bags with the transform on the device: the same result
    infer = tinf.make_batched_infer(TCFG, compute_dtype=None,
                                    transform_resolution=32)
    probs_u8, _ = tinf.classify_slides_batched(model, TCFG, raw,
                                               infer_fn=infer)
    np.testing.assert_allclose(probs_u8, probs, atol=1e-6)
    with pytest.raises(ValueError, match="no tiles"):
        tinf.classify_slides_batched(model, TCFG, [raw[0], raw[0][:0]],
                                     compute_dtype=None)


def test_prefetch_iter_keeps_order_and_raises_producer_errors():
    assert list(tloader.prefetch_iter(iter(range(50)), depth=3)) == \
        list(range(50))

    def bad():
        yield 1
        raise OSError("disk gone")

    got = []
    with pytest.raises(OSError, match="disk gone"):
        for x in tloader.prefetch_iter(bad(), depth=2):
            got.append(x)
    assert got == [1]
    # an early stop joins the producer before control returns
    it = tloader.prefetch_iter(iter(range(1000)), depth=2)
    assert next(it) == 0
    it.close()


def test_staged_chunks_cover_the_stack_in_order():
    """The streaming loop's host staging: every chunk equals its slice of
    the stack, including the tail, whatever the chunk size; a stack that
    is not uint8 is refused rather than cast."""
    raw = np.random.default_rng(11).integers(0, 256, (11, 4, 4, 3),
                                             dtype=np.uint8)
    for chunk in (1, 4, 11, 64):
        seen = []
        for start, part in tloader.staged_chunks(raw, chunk,
                                                 torch.device("cpu")):
            np.testing.assert_array_equal(
                part.numpy(), raw[start:start + part.shape[0]])
            seen.append((start, part.shape[0]))
        assert seen[0][0] == 0 and sum(n for _, n in seen) == 11
        assert all(n == min(chunk, 11 - s) for s, n in seen)
    with pytest.raises(TypeError):
        next(tloader.staged_chunks(raw.astype(np.float32), 4,
                                   torch.device("cpu")))
