"""Slide serving: one-pass, streaming and batched slide classification.

Counterpart of the single-device serving half of ``parallel/inference.py``
in the JAX package (what ``train/serve.py`` and the interface mode of
``train/classify.py`` call). A slide goes RoiBuilder cache -> on-device
transforms -> ResNet-26 features -> gated attention pool. On CUDA every
path pools through the hand-written kernel (``ops/gated_pool.py``), one
launch per slide.

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
from ..data.loader import staged_chunks
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


def make_transform_extract(cfg: amil.MILConfig, *, resolution: int = 300,
                           compute_dtype=torch.bfloat16):
    """The default per-chunk program of the streaming path:
    ``(cnn, raw uint8 [N, H, W, 3]) -> float32 features [N, L]``, the eval
    transform then the ResNet-26 (with ``cfg.stem``) on the chunk's
    device."""
    def extract(cnn, raw_u8):
        tiles = transforms.eval_transform(raw_u8, resolution=resolution)
        return resnet.apply_resnet26(cnn, tiles, compute_dtype=compute_dtype,
                                     stem=cfg.stem).float()
    return extract


@torch.no_grad()
def classify_slide_streaming(model, cfg: amil.MILConfig, builder, *,
                             resolution: int = 300, chunk: int = 1024,
                             compute_dtype=torch.bfloat16,
                             transform_extract=None):
    """Unbounded-slide inference: stream tile chunks through transform +
    extractor, then pool once over the small [T, L] feature matrix.

    Only one chunk of tiles plus the features are resident on the device,
    so slides of 50k+ tiles classify on one card. Exact, not approximate:
    the pool is linear over tiles and the per-bag batch-norm takes its
    statistics over the whole feature matrix. ``transform_extract``, the
    JAX package's hook, replaces the default per-chunk program
    (:func:`make_transform_extract`) with any ``(cnn, raw uint8 chunk on
    the device) -> [N, L]`` function, such as the uint8-stem extractor
    ``ops.u8_stem.u8_stem_extract`` with its keywords bound. Returns
    (probs, outputs dict, coords), as :func:`classify_slide`."""
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

    extract = (transform_extract if transform_extract is not None
               else make_transform_extract(cfg, resolution=resolution,
                                           compute_dtype=compute_dtype))
    T = raw.shape[0]
    H = torch.empty((T, cfg.L), dtype=torch.float32, device=device)
    for start, part in staged_chunks(raw, chunk, device):
        H[start:start + part.shape[0]] = extract(model.cnn, part)
    probs, outs = _pool_outputs(model, H, cfg)
    return probs.ravel(), outs, coords


def _pool_outputs(model, H, cfg):
    """Pool the [T, L] features of one slide: (probs [1, C], host outputs
    with ``y_pred``, ``y_pred_hat`` and ``Fterm``)."""
    pooled = {k: _host(v)
              for k, v in amil.attention_pool(model, H, cfg).items()}
    z = pooled["logits"].astype(np.float32)
    z = np.exp(z - z.max(axis=1, keepdims=True))
    probs = z / z.sum(axis=1, keepdims=True)
    return probs, {**pooled, "y_pred": probs, "y_pred_hat": np.argmax(probs),
                   "Fterm": _host(H)}


def make_batched_infer(cfg: amil.MILConfig, *, compute_dtype=torch.bfloat16,
                       extractor=None,
                       transform_resolution: int | None = None):
    """Batched inference for one card: ``fn(model, bags)`` with ``bags`` a
    list of ``[T_i, H, W, 3]`` tensors on the model's device. All the
    group's tiles go through ONE extractor call (concatenated), then each
    slide pools on its own rows: one pool-kernel launch per slide. No
    bucket padding: eager PyTorch compiles nothing per shape, so the
    outputs are the JAX package's once it has trimmed its padded ones.
    ``extractor``, a ``(cnn, tiles) -> [N, L]`` function, replaces the
    ResNet-26 (the W8A8 int8 serving path). With ``transform_resolution``
    the bags are raw uint8 and the eval transform runs on the card, as in
    the JAX package. Returns a dict of
    host arrays: ``y_pred`` [B, 1, C], ``y_pred_hat`` [B], ``Mterm``
    [B, K, O], ``Aterm_var`` [B] and ``Aterm``, a list of [K, T_i]."""
    def infer(model, bags):
        sizes = [int(b.shape[0]) for b in bags]
        if min(sizes) < 1:
            raise ValueError("a bag of the group has no tiles")
        tiles = torch.cat(list(bags), dim=0)
        if transform_resolution is not None:
            tiles = transforms.eval_transform(
                tiles, resolution=transform_resolution)
        if extractor is not None:
            H = extractor(model.cnn, tiles).float()
        else:
            H = resnet.apply_resnet26(model.cnn, tiles,
                                      compute_dtype=compute_dtype,
                                      stem=cfg.stem).float()
        rows = [_pool_outputs(model, h, cfg)[1]
                for h in torch.split(H, sizes, dim=0)]
        return {"y_pred": np.stack([r["y_pred"] for r in rows]),
                "y_pred_hat": np.asarray([r["y_pred_hat"] for r in rows]),
                "Mterm": np.stack([r["Mterm"] for r in rows]),
                "Aterm_var": np.asarray([r["Aterm_var"] for r in rows]),
                "Aterm": [r["Aterm"] for r in rows]}
    return torch.no_grad()(infer)


def classify_slides_batched(model, cfg: amil.MILConfig, bags, *,
                            compute_dtype=torch.bfloat16, infer_fn=None):
    """bags: list of ``[T_i, H, W, 3]`` host arrays (or tensors), each
    with at least one tile. Runs one batched forward on the model's device
    (:func:`make_batched_infer`; ``infer_fn`` is one the caller built, such
    as the daemon's with a fused uint8 transform). Returns
    (probs [B, C], outputs dict)."""
    device = module_device(model)
    infer = infer_fn or make_batched_infer(cfg, compute_dtype=compute_dtype)
    outs = infer(model, [b.to(device) if isinstance(b, torch.Tensor)
                         else torch.from_numpy(np.array(b)).to(device)
                         for b in bags])
    return outs["y_pred"].reshape(len(bags), -1), outs


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
