"""The port's eval paths on a mesh of 2 gloo ranks (slides 1 x tiles 2),
spawned once for the module: the explicit sharded pool against the JAX
package's ``make_sharded_pool`` on a ``make_mesh(2, slides=1)`` (to 1e-5),
and ``classify_slides_batched(mesh=)`` / ``classify_slide_streaming(mesh=)``
against the single-rank port (to 1e-6). The ranks run
``tests/torch_mesh_workers.py``, which imports no JAX."""

import numpy as np
import pytest

import conftest  # noqa: F401
import jax
import jax.numpy as jnp
import torch_mesh_workers as W

from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu.models import (
    attention_mil as jamil,
)
from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu.parallel import (
    mesh as JM,
    shard_pool as jshard,
)
from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.data import (
    roibuilder as troi,
    slide_io as tslide_io,
)
from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.models import (
    attention_mil as tamil,
)
from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.parallel import (
    inference as tinf,
)
from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.parallel import (
    mesh as TM,
)
from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.utils import (
    interop,
)

TINY = dict(widths=(8, 8, 8, 8), blocks=(1, 1, 1, 1), L=16, D=8)
ROI, CHUNK = 32, 7
# whole-bag (T, padded rows) cases of the pool: T even, and T odd, which
# the port pads to the tile axis with a zero-mask row
POOL_T = (20, 21)


def _bags(seed, sizes):
    rng = np.random.default_rng(seed)
    return [np.clip(np.array([140, 60, 170], np.int16)
                    + rng.integers(-40, 40, (t, ROI, ROI, 3)), 0,
                    255).astype(np.uint8) for t in sizes]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    jcfg = jamil.MILConfig(**TINY)
    jp = jax.jit(jamil.init_attention_mil, static_argnums=1)(
        jax.random.PRNGKey(3), jcfg)
    model = interop.load_jax_params(
        tamil.AttentionMIL(tamil.MILConfig(**TINY), device="cpu"), jp).eval()
    state = {k: v.numpy() for k, v in model.state_dict().items()}
    rng = np.random.default_rng(0)
    cases = []
    for t in POOL_T:
        H = rng.normal(size=(t, TINY["L"])).astype(np.float32)
        mask = np.ones(t, np.float32)
        mask[-3:] = 0.0
        cases.append((H, mask))
    bags = _bags(1, (5, 13, 1))
    # a slide of 7 x 7 tiles, its cache built by the port's RoiBuilder
    d = tmp_path_factory.mktemp("mesh_slide")
    img = np.concatenate([np.concatenate(list(b), axis=1)
                          for b in _bags(2, (7,) * 7)], axis=0)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("CACHE_DIR", str(d))
        path = tslide_io.write_synthetic_slide(str(d / "m_H&E.npy"), img)
        builder = troi.RoiBuilder(path, {"roi_size": ROI}, device="cpu")
        assert builder.build() and builder.getsize() > CHUNK
        out = TM.launch(W.eval_session, 2, slides=1, devices=["cpu"] * 2,
                        args=(TINY, state, cases, bags,
                              (str(d), path, ROI, CHUNK)))
    return jcfg, jp, model, cases, bags, builder, out


def test_sharded_pool_matches_jax(world):
    jcfg, jp, _, cases, _, _, out = world
    mesh = JM.make_mesh(2, slides=1)
    pool = jshard.make_sharded_pool(jcfg, mesh)
    for (H, mask), got in zip(cases, out[0]["pooled"]):
        T = H.shape[0]
        pad = -T % 2  # JAX's tile axis must divide T: pad as the port does
        Hp = np.concatenate([H, np.zeros((pad, H.shape[1]), H.dtype)])
        mp = np.concatenate([mask, np.zeros(pad, mask.dtype)])
        Hs, ms = jshard.shard_features(mesh, jnp.asarray(Hp), jnp.asarray(mp))
        want = pool(jp, Hs, ms)
        np.testing.assert_allclose(got["logits"], np.asarray(want["logits"]),
                                   atol=1e-5)
        np.testing.assert_allclose(got["Mterm"], np.asarray(want["Mterm"]),
                                   atol=1e-5)
        np.testing.assert_allclose(got["Aterm"], np.asarray(want["Aterm"]),
                                   atol=1e-5)
        assert got["Aterm"].shape == (3, T + pad)


def test_every_rank_returns_the_whole_bag(world):
    out = world[-1]
    for key in ("logits", "Mterm", "Aterm"):
        for case in range(len(POOL_T)):
            np.testing.assert_array_equal(out[1]["pooled"][case][key],
                                          out[0]["pooled"][case][key])
    np.testing.assert_array_equal(out[1]["batched"][0], out[0]["batched"][0])
    np.testing.assert_array_equal(out[1]["streaming"][0],
                                  out[0]["streaming"][0])


def test_batched_infer_on_the_mesh_matches_one_rank(world):
    _, _, model, _, bags, _, out = world
    cfg = model.cfg
    infer = tinf.make_batched_infer(cfg, compute_dtype=None,
                                    transform_resolution=32)
    probs, outs = tinf.classify_slides_batched(model, cfg, bags,
                                               infer_fn=infer)
    mprobs, mouts = out[0]["batched"]
    np.testing.assert_allclose(mprobs, probs, atol=1e-6)
    for key in ("Mterm", "Aterm_var"):
        np.testing.assert_allclose(mouts[key], outs[key], atol=1e-6)
    np.testing.assert_array_equal(mouts["y_pred_hat"], outs["y_pred_hat"])
    for got, want in zip(mouts["Aterm"], outs["Aterm"]):
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=1e-6)


def test_streaming_on_the_mesh_matches_one_rank(world):
    _, _, model, _, _, builder, out = world
    probs, outs, coords = tinf.classify_slide_streaming(
        model, model.cfg, builder, resolution=32, chunk=CHUNK,
        compute_dtype=None)
    mprobs, mouts, mcoords = out[0]["streaming"]
    np.testing.assert_array_equal(mcoords, coords)
    np.testing.assert_allclose(mprobs, probs, atol=1e-6)
    for key in ("Aterm", "Fterm", "Mterm", "Bterm", "wROIs"):
        assert mouts[key].shape == outs[key].shape, key
        np.testing.assert_allclose(mouts[key], outs[key], atol=1e-6,
                                   err_msg=key)
    assert int(mouts["y_pred_hat"]) == int(outs["y_pred_hat"])


def test_streaming_chunk_rounds_to_the_ranks():
    assert tinf.streaming_chunk_for(5000, 1024, 1) == 1024
    assert tinf.streaming_chunk_for(100, 1024, 1) == 100
    assert tinf.streaming_chunk_for(5000, 1024, 3) == 1026
    assert tinf.streaming_chunk_for(10, 1024, 4) == 12
    assert tinf.streaming_chunk_for(1, 7, 2) == 2
