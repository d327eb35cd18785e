"""Slide serving: one-pass and streaming whole-slide classification.

Counterpart of the single-device serving half of ``parallel/inference.py``
in the JAX package (what ``train/serve.py`` and the interface mode of
``train/classify.py`` call). A slide goes RoiBuilder cache -> on-device
transforms -> ResNet-26 features -> gated attention pool. On CUDA both
paths pool through the hand-written kernel (``ops/gated_pool.py``).

The JAX package pads every bag to a bucket so that its compiled programs
are few. PyTorch runs eagerly and compiles nothing, so both paths here run
at the slide's exact tile count: no padded tiles go through the extractor
and the pool covers exactly T rows. The outputs equal the JAX package's
once it has trimmed its padded outputs to T.
"""

import numpy as np
import torch

from .._device import module_device
from ..data import transforms
from ..models import attention_mil as amil
from ..models import resnet
from ..ops import loss as L


def _host(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x


def _serving_device(model, builder) -> torch.device:
    """The model's device, which must be the builder's: a bag is never moved
    between the host and the card behind the caller's back."""
    device = module_device(model)
    if builder.device != device:
        raise ValueError(
            f"the model lies on {device} but the RoiBuilder builds bags on "
            f"{builder.device}; create both for the same device")
    return device


@torch.no_grad()
def classify_slide(model, cfg: amil.MILConfig, builder, *,
                   resolution: int = 300, compute_dtype=torch.bfloat16):
    """Full-slide pipeline in one bag forward: tile cache -> transforms ->
    features -> pooled prediction, on the model's device (which must be
    the builder's). Returns (probs [n_classes], outputs dict of numpy
    arrays, coords)."""
    _serving_device(model, builder)
    if builder.params.get("resolution") != resolution:
        builder.update_resolution_and_buffer(resolution)
    tiles, coords, _ = builder.get_inference_data()
    outs = amil.apply_attention_mil(model, tiles, 0, cfg,
                                    compute_dtype=compute_dtype)
    outs = {k: _host(v) for k, v in outs.items()}
    return outs["y_pred"].ravel(), outs, coords


@torch.no_grad()
def classify_slide_streaming(model, cfg: amil.MILConfig, builder, *,
                             resolution: int = 300, chunk: int = 1024,
                             compute_dtype=torch.bfloat16):
    """Unbounded-slide inference: stream tile chunks through transform +
    extractor, then pool once over the small [T, L] feature matrix.

    Only one chunk of tiles plus the features are resident on the device,
    so slides of 50k+ tiles classify on one card. Exact, not approximate:
    the pool is linear over tiles and the per-bag batch-norm takes its
    statistics over the whole feature matrix. Returns (probs, outputs
    dict, coords), as :func:`classify_slide`."""
    device = _serving_device(model, builder)
    if builder.params.get("resolution") != resolution:
        builder.update_resolution_and_buffer(resolution)
    # mmap: a 50k-tile 1200 px cache is ~200 GB; the loop copies one
    # chunk at a time off the map
    raw, coords = builder._load_cache(with_coords=True, mmap=True)
    if raw.shape[0] == 0:
        # a tile-less slide goes through the one-pass forward, whose
        # fallback is the post-transform f32 zero bag (RoiBuilder._empty_bag)
        # that validation feeds too
        return classify_slide(model, cfg, builder, resolution=resolution,
                              compute_dtype=compute_dtype)

    T = raw.shape[0]
    H = torch.empty((T, cfg.L), dtype=torch.float32, device=device)
    for start in range(0, T, chunk):
        # np.array copies the chunk off the (read-only) map
        part = torch.from_numpy(np.array(raw[start:start + chunk])).to(device)
        tiles = transforms.eval_transform(part, resolution=resolution)
        H[start:start + part.shape[0]] = resnet.apply_resnet26(
            model.cnn, tiles, compute_dtype=compute_dtype, stem=cfg.stem)

    pooled = {k: _host(v)
              for k, v in amil.attention_pool(model, H, cfg).items()}
    z = pooled["logits"].astype(np.float32)
    z = np.exp(z - z.max(axis=1, keepdims=True))
    probs = z / z.sum(axis=1, keepdims=True)
    outs = {**pooled, "y_pred": probs, "y_pred_hat": np.argmax(probs),
            "Fterm": _host(H)}
    return probs.ravel(), outs, coords


def streaming_eval_outputs(outs, label, cfg: amil.MILConfig):
    """Attach the eval-metric keys of the bag forward (loss / error / KLD)
    to a streaming pass's outputs, from its pooled logits and features."""
    H = np.asarray(outs["Fterm"], np.float32)
    KLD = np.float32(0.5 * np.mean(np.mean(H ** 2, axis=1)))
    weight = (torch.tensor(cfg.class_weights, dtype=torch.float32)
              if cfg.class_weights is not None else None)
    label = int(label)
    loss = L.smoothed_ce_loss(torch.from_numpy(np.asarray(outs["logits"])),
                              torch.tensor([label]),
                              num_classes=cfg.n_classes,
                              smoothing=cfg.smoothing, weight=weight)
    error = 1.0 - (np.asarray(outs["y_pred_hat"]) == label).astype(np.float32)
    return {**outs, "loss": loss.numpy(), "error": error, "KLD": KLD}
