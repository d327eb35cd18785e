"""The port's bf16 serving gap against the 1e-3 probability contract: the
twin of ``tests/test_bf16_serving_contract.py``.

The daemon serves in bf16 unless ``--f32``; the parity tests hold f32.
These tests bound the bf16-against-f32 gap itself, through the paths the
port's daemon runs: ``parallel/inference.classify_slide_streaming`` and
the bag forward through the gated pool's op (its plain version on these
CPU tensors). The slide, the weights and the confidence-scaled head are
the JAX test's: one 1100 px synthetic-tissue slide cached at roi 100 (at
least 50 tiles), full-width ``MILConfig(class_weights=(1, 1, 1))`` weights
of JAX's ``PRNGKey(0)`` init carried across by ``utils/interop.py``, and
the instance-code classifier at 1x and 20x its scale (``_confidence_scaled``).
On the card, ``chip_smoke.py``'s ``learn`` phase adds the gap on the
classifier it has just trained."""

import contextlib

import numpy as np
import pytest
import torch

import conftest  # noqa: F401
import jax

from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu.models import (
    attention_mil as jamil,
)
from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.data import (
    roibuilder,
    slide_io,
)
from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.models import (
    attention_mil as amil,
)
from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.parallel import (
    inference,
)
from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.utils import (
    interop,
)

CONTRACT = 1e-3  # BASELINE.md: slide probabilities within 1e-3


@pytest.fixture(scope="module")
def full_width_builder(tmp_path_factory):
    """The JAX test's slide at roi 100 and the port's full-width model
    holding JAX's ``PRNGKey(0)`` init."""
    tmp = tmp_path_factory.mktemp("torch_bf16_contract")
    mp = pytest.MonkeyPatch()
    mp.setenv("CACHE_DIR", str(tmp))
    rng = np.random.default_rng(0)
    base = np.array([150, 60, 170], np.int16)
    img = np.clip(base + rng.integers(-50, 50, (1100, 1100, 3)), 0,
                  255).astype(np.uint8)
    path = slide_io.write_synthetic_slide(str(tmp / "s_H&E.npy"), img)
    builder = roibuilder.RoiBuilder(path, {"roi_size": 100}, device="cpu")
    builder.build()
    assert builder.getsize() >= 50
    jcfg = jamil.MILConfig(class_weights=(1.0, 1.0, 1.0))
    cfg = amil.MILConfig(class_weights=(1.0, 1.0, 1.0))
    model = amil.AttentionMIL(cfg, device="cpu")
    # jitted, JAX's init draws eager init's parameters to ~6e-8 in a third
    # of the time
    interop.load_jax_params(model, jax.jit(
        jamil.init_attention_mil, static_argnums=1)(jax.random.PRNGKey(0),
                                                    jcfg))
    yield builder, cfg, model.eval()
    mp.undo()


@contextlib.contextmanager
def _confidence_scaled(model, scale: float):
    """The model with its instance-code classifier's weight times
    ``scale`` (the JAX test's ``_confidence_scaled``), restored on exit."""
    w = model.buffer["classifier"].weight
    saved = w.detach().clone()
    with torch.no_grad():
        w.mul_(scale)
    try:
        yield model
    finally:
        with torch.no_grad():
            w.copy_(saved)


@pytest.mark.parametrize("scale", [1.0, 20.0])
def test_streaming_bf16_probabilities_within_contract(full_width_builder,
                                                      scale):
    builder, cfg, model = full_width_builder
    with _confidence_scaled(model, scale) as m:
        p32, _, _ = inference.classify_slide_streaming(
            m, cfg, builder, resolution=64, chunk=64, compute_dtype=None)
        p16, _, _ = inference.classify_slide_streaming(
            m, cfg, builder, resolution=64, chunk=64,
            compute_dtype=torch.bfloat16)
    drift = float(np.abs(np.asarray(p32) - np.asarray(p16)).max())
    assert drift < CONTRACT, (scale, drift, p32, p16)


def test_bag_forward_pool_op_bf16_within_contract(full_width_builder):
    """The bag forward, whose pool is the gated pool's op, at bf16 compute
    stays inside the contract too."""
    builder, cfg, model = full_width_builder
    builder.update_resolution_and_buffer(64)
    tiles = builder.get_validation_data()
    with torch.no_grad():
        out32 = amil.apply_attention_mil(model, tiles, 1, cfg, train=False)
        out16 = amil.apply_attention_mil(model, tiles, 1, cfg, train=False,
                                         compute_dtype=torch.bfloat16)
    drift = float((out32["y_pred"] - out16["y_pred"]).abs().max())
    assert drift < CONTRACT, drift
