"""UNI's ViT-L/16 tile encoder (``models/vit.py``) under the gated head, on
the CPU at a tiny size (width 64, 2 layers of 2 heads, MLP 256, tiles of
32 px in 16 px patches), held to the benchmark's plain reference
(``benchmark/reference/vit_mil.py``) on seeded weights: the features, and
a slide's probabilities, M and attention maps through the streaming entry
and through the one-pass bag forward; faults planted in the encoder fail
the same comparison; the default configuration still builds the
ResNet-26; and the encoder's span and counters."""

import json
import os

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import conftest  # noqa: F401

from benchmark import compare
from benchmark.reference import resnet26_mil as resnet_ref
from benchmark.reference import vit_mil as ref
from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.data import (
    transforms,
)
from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.models import (
    attention_mil as amil,
    resnet,
    vit,
)
from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.parallel import (
    inference,
)
from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.utils import (
    profiling,
)

PX = 32
# gamma 0.3, not UNI's 1e-5: under 1e-5 every tile's feature is nearly the
# same, and the head's batch norm over the bag would divide round-off
VIT = vit.ViTConfig(depth=2, heads=2, mlp=256, patch=16, image=PX,
                    init_values=0.3)
CFG = amil.MILConfig(L=64, D=16, extractor="vit", vit=VIT,
                     class_weights=None)
REF = {"tile_px": PX, "resolution": PX, "patch": 16, "dim": 64, "depth": 2,
       "heads": 2, "mlp_dim": 256, "width_mult": 1.0, "D": 16, "K": 3,
       "O": 1, "n_classes": 3}
# float32 on both sides: they differ in the order of their sums alone (the
# port's patch embedding is one matrix product, the reference's a
# convolution; the port's attention fused, the reference's written out),
# a few float32 epsilons of the values compared
TOL = 1e-5


class _Cache:
    """A tile cache stand-in: the slide's uint8 tiles and coordinates."""

    def __init__(self, raw):
        self.raw, self.device = raw, torch.device("cpu")
        self.coords = np.zeros((len(raw), 2), np.int64)
        self.params = {"resolution": raw.shape[1]}

    def update_resolution_and_buffer(self, resolution):
        self.params["resolution"] = resolution

    def _load_cache(self, with_coords=False, mmap=False):
        return (self.raw, self.coords) if with_coords else self.raw

    def get_inference_data(self):
        """The one-pass path's bag: the tiles at the builder's resolution."""
        tiles = transforms.eval_transform(
            torch.from_numpy(self.raw), resolution=self.params["resolution"])
        return tiles, self.coords, self.raw


@pytest.fixture(scope="module")
def model():
    return amil.init_attention_mil(torch.Generator().manual_seed(0), CFG,
                                   device="cpu")


def _weights(model):
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def _tiles(n, px=PX, seed=0):
    """Tiles that differ from one another: a colour and a contrast each
    over pixel noise."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(20, 220, (n, 1, 1, 3))
    noise = rng.normal(0, 1, (n, px, px, 3)) * rng.uniform(5, 60, (n, 1, 1, 1))
    return np.clip(base + noise, 0, 255).round().astype(np.uint8)


def _stream(model, raw, chunk=16):
    probs, outs, _ = inference.classify_slide_streaming(
        model, CFG, _Cache(raw), resolution=raw.shape[1], chunk=chunk,
        compute_dtype=None)
    return {"probs": probs, "Mterm": outs["Mterm"], "Aterm": outs["Aterm"]}


def _feature_gap(model, raw, cfg=REF):
    extract = inference.make_transform_extract(CFG, resolution=raw.shape[1],
                                               compute_dtype=None)
    with torch.no_grad():
        H = extract(model.cnn, torch.from_numpy(raw))
    Hr = ref.features(_weights(model), raw, cfg)
    return float((H - Hr).abs().max() / Hr.abs().max())


@pytest.mark.parametrize("px", [PX, 48])
def test_features_match_the_reference(model, px):
    """At the encoder's resolution and from 48 px tiles, which the eval
    transform resizes to it first (as 256 px tiles to UNI's 224)."""
    raw = _tiles(12, px=px)
    assert _feature_gap(model, raw, dict(REF, tile_px=px)) < TOL


def test_streaming_slide_matches_the_reference(model):
    """40 tiles in chunks of 16: two whole chunks and a tail of 8."""
    raw = _tiles(40, seed=1)
    out = _stream(model, raw, chunk=16)
    gaps = compare.serve_numbers([(out, ref.slide(_weights(model), raw,
                                                  REF))])
    assert out["Aterm"].shape == (3, 40)
    assert gaps["prob_gap"] < 1e-6
    assert gaps["aterm_gap"] < TOL and gaps["mterm_gap"] < TOL


def test_bag_forward_matches_the_reference(model):
    raw = _tiles(24, seed=2)
    tiles = transforms.eval_transform(torch.from_numpy(raw), resolution=PX)
    outs = amil.apply_attention_mil(model, tiles, 0, CFG)
    out = {"probs": outs["y_pred"].numpy().ravel(),
           "Mterm": outs["Mterm"].numpy(), "Aterm": outs["Aterm"].numpy()}
    gaps = compare.serve_numbers([(out, ref.slide(_weights(model), raw,
                                                  REF))])
    assert gaps["prob_gap"] < 1e-6
    assert gaps["aterm_gap"] < TOL and gaps["mterm_gap"] < TOL


def test_one_pass_slide_resizes_to_the_encoder(model):
    """``classify_slide`` asks the builder for the encoder's 32 px from a
    cache of 48 px tiles."""
    raw = _tiles(16, px=48, seed=7)
    probs, outs, _ = inference.classify_slide(model, CFG, _Cache(raw),
                                              resolution=48,
                                              compute_dtype=None)
    out = {"probs": probs, "Mterm": outs["Mterm"], "Aterm": outs["Aterm"]}
    gaps = compare.serve_numbers([(out, ref.slide(_weights(model), raw,
                                                  dict(REF, tile_px=48)))])
    assert gaps["prob_gap"] < 1e-6
    assert gaps["aterm_gap"] < TOL and gaps["mterm_gap"] < TOL


def _wrong_scale(q, k, v, **kw):
    return _SDPA(q, k, v, scale=1.0 / q.shape[-1], **kw)


_SDPA = F.scaled_dot_product_attention


@pytest.mark.parametrize("fault", ["gamma_dropped", "attention_scale"])
def test_planted_faults_fail(model, fault, monkeypatch):
    raw = _tiles(12, seed=3)
    if fault == "gamma_dropped":
        broken = amil.init_attention_mil(torch.Generator().manual_seed(0),
                                         CFG, device="cpu")
        with torch.no_grad():
            for block in broken.cnn.blocks:
                block.ls1.gamma.fill_(1.0)
                block.ls2.gamma.fill_(1.0)
        extract = inference.make_transform_extract(CFG, resolution=PX,
                                                   compute_dtype=None)
        with torch.no_grad():
            H = extract(broken.cnn, torch.from_numpy(raw))
        Hr = ref.features(_weights(model), raw, REF)
        gap = float((H - Hr).abs().max() / Hr.abs().max())
    else:
        # 1 / hd in place of 1 / sqrt(hd)
        monkeypatch.setattr(F, "scaled_dot_product_attention", _wrong_scale)
        gap = _feature_gap(model, raw)
    assert gap > 100 * TOL


def test_bf16_products_stay_near_float32(model):
    raw = _tiles(8, seed=4)
    extract = inference.make_transform_extract(CFG, resolution=PX,
                                               compute_dtype=torch.bfloat16)
    with torch.no_grad():
        H = extract(model.cnn, torch.from_numpy(raw))
    Hr = ref.features(_weights(model), raw, REF)
    assert H.dtype == torch.float32
    gap = float((H - Hr).abs().max() / Hr.abs().max())
    assert TOL < gap < 0.05


def test_training_forward_with_remat_gives_the_same_gradient(model):
    """The encoder's backward, with and without recomputing each block."""
    tiles = transforms.eval_transform(torch.from_numpy(_tiles(10, seed=5)),
                                      resolution=PX)
    grads = []
    for remat in (False, True):
        cfg = amil.MILConfig(**{**vars(CFG), "remat": remat})
        m = amil.init_attention_mil(torch.Generator().manual_seed(0), cfg,
                                    device="cpu").train()
        outs = amil.apply_attention_mil(
            m, tiles, 1, cfg, train=True,
            generator=torch.Generator().manual_seed(1))
        outs["loss"].backward()
        grads.append({k: p.grad for k, p in m.named_parameters()
                      if k.startswith("cnn.")})
    assert grads[0].keys() == grads[1].keys()
    assert any(float(g.abs().max()) > 0 for g in grads[0].values())
    for k, g in grads[0].items():
        torch.testing.assert_close(g, grads[1][k], rtol=1e-5, atol=1e-7)


def test_default_config_still_builds_the_resnet26():
    model = amil.AttentionMIL(amil.MILConfig(), device="meta")
    assert isinstance(model.cnn, resnet.ResNet26)
    cfg = {"widths": list(resnet.WIDTHS), "blocks": list(resnet.BLOCKS_PER_STAGE),
           "L": 80, "D": 40, "K": 3, "O": 1}
    assert set(model.state_dict()) == set(resnet_ref.param_shapes(cfg))


def test_vit_state_dict_is_the_references():
    """timm's parameter names under ``cnn.``, as the reference lists them,
    so a UNI checkpoint loads with ``strict=True``."""
    model = amil.AttentionMIL(CFG, device="meta")
    shapes = ref.param_shapes(dict(REF, gamma_weights=1.0))
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == \
        {k: tuple(s) for k, (s, _) in shapes.items()}


def test_unknown_extractor_is_refused():
    with pytest.raises(ValueError, match="unknown extractor"):
        amil.AttentionMIL(amil.MILConfig(extractor="vit_h"), device="meta")


def test_encoder_span_and_counters(model, tmp_path):
    """Under a profiler a streamed slide of 40 tiles in chunks of 16 marks
    ``port.vit`` once a chunk, each inside the chunk's ``port.extract``,
    and counts its tiles and their tokens; without one it counts
    nothing."""
    raw = _tiles(40, seed=6)
    profiling.reset_counters()
    _stream(model, raw)
    assert profiling.counters() == {}
    with profiling.trace(str(tmp_path)):
        _stream(model, raw)
    counts = profiling.counters()
    profiling.reset_counters()
    (path,) = [p for p in os.listdir(tmp_path) if p.startswith("trace_")]
    with open(tmp_path / path) as f:
        events = json.load(f)["traceEvents"]
    spans = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                   if e.get("cat") == "user_annotation"
                   and e["name"].startswith("port."))
    encoders = [s for s in spans if s[2] == "port.vit"]
    extracts = [s for s in spans if s[2] == "port.extract"]
    assert len(encoders) == len(extracts) == 3
    for (a, b, _), (c, d, _) in zip(encoders, extracts):
        assert c <= a and b <= d
    assert counts["vit.tiles"] == 40
    assert counts["vit.tokens"] == 40 * (1 + (PX // 16) ** 2)
