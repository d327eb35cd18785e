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

With ``mesh=`` (``parallel/mesh.py``) the batched and streaming paths run
on every rank of the mesh together, each rank on its own card: the batched
group's bags spread over the slide axis and each bag's tiles over the tile
axis (the pool's sums become all-reduces of the tile group), and a streamed
slide's chunks spread over every rank, whose features are gathered before
the one pool. Every rank returns the same outputs; rank 0 writes them. A
sum or a gather over a group of one rank is not issued.
"""

import numpy as np
import torch
import torch.distributed as dist

from .._device import module_device
from ..data import transforms
from ..data.loader import pad_bag, staged_chunks
from ..models import attention_mil as amil
from ..ops import loss as L
from ..ops import u8_stem
from ..ops.collectives import all_gather_cat, alone
from ..utils import profiling
from . import mesh as M


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
    the builder's), whose tiles the builder resizes to ``resolution`` (the
    ViT's own for a ViT). Returns (probs [n_classes], outputs dict of
    numpy arrays, coords)."""
    _serving_device(model, builder)
    resolution = amil.input_resolution(cfg, resolution)
    if builder.params.get("resolution") != resolution:
        builder.update_resolution_and_buffer(resolution)
    tiles, coords, _ = builder.get_inference_data()
    outs = amil.apply_attention_mil(model, tiles, 0, cfg,
                                    compute_dtype=compute_dtype)
    outs = {k: _host(v) for k, v in outs.items()}
    return outs["y_pred"].ravel(), outs, coords


def fused_stem_applies(cfg: amil.MILConfig, cnn, raw_u8, *, device,
                       resolution: int, compute_dtype) -> bool:
    """Whether the streaming chunk program runs the ResNet's uint8 entry
    (``ResNet26.forward_u8``, the fused stem) for the raw chunk ``raw_u8``
    on ``device``: a CUDA device, the bf16 ResNet-26 served at 300 px,
    where the eval transform's resize is the identity, and a stem and
    chunk that ``u8_stem.accepts``. Anywhere else the eval transform and
    cuDNN's stem run: on the CPU, in float32 (bf16 operands would lower
    cuDNN's precision), for the ViT and at other tile sizes."""
    return (torch.device(device).type == "cuda"
            and compute_dtype == torch.bfloat16
            and cfg.extractor == "resnet26"
            and amil.input_resolution(cfg, resolution) == u8_stem.H_IN
            and u8_stem.accepts(cnn.conv1, raw_u8))


def make_transform_extract(cfg: amil.MILConfig, *, resolution: int = 300,
                           compute_dtype=torch.bfloat16):
    """The default per-chunk program of the streaming path:
    ``(cnn, raw uint8 [N, H, W, 3]) -> float32 features [N, L]`` on the
    chunk's device. Where :func:`fused_stem_applies` (a CUDA chunk of uint8
    300 px tiles served at 300 px through the bf16 ResNet-26) it is the
    ResNet's uint8 entry, ``ResNet26.forward_u8``, with the eval
    transform's normalize ``x * 2/255 - 1`` folded into the stem's one
    launch; the chunk's tiles are counted as ``stem.kernel_tiles``.
    Otherwise it is the eval transform then ``cfg``'s embedder
    (``amil.embed``: the ResNet-26 at ``resolution``, or the ViT at its
    own resolution). Both take the same bf16 products of the same
    normalized values; the choice is made per chunk, from what the chunk
    and the model are."""
    resolution = amil.input_resolution(cfg, resolution)
    alpha = 1.0 / (255.0 * transforms.STD)
    beta = -transforms.MEAN / transforms.STD

    def extract(cnn, raw_u8):
        if fused_stem_applies(cfg, cnn, raw_u8, device=raw_u8.device,
                              resolution=resolution,
                              compute_dtype=compute_dtype):
            profiling.count("stem.kernel_tiles", raw_u8.shape[0])
            return cnn.forward_u8(raw_u8, alpha=alpha, beta=beta,
                                  compute_dtype=compute_dtype).float()
        tiles = transforms.eval_transform(raw_u8, resolution=resolution)
        return amil.embed(cnn, tiles, cfg, compute_dtype=compute_dtype)
    return extract


def streaming_chunk_for(n_tiles: int, chunk: int, n_dev: int = 1) -> int:
    """The chunk a slide of ``n_tiles`` tiles streams at on ``n_dev``
    ranks: ``chunk``, or the whole slide when it is smaller, rounded up to
    a multiple of ``n_dev`` so that each rank takes an equal share of
    every chunk (the JAX package's ``streaming_chunk_for``, without its
    bucket ladder: no chunk is padded here)."""
    chunk = max(1, min(chunk, n_tiles))
    return -(-chunk // n_dev) * n_dev


@torch.no_grad()
def classify_slide_streaming(model, cfg: amil.MILConfig, builder, *,
                             resolution: int = 300, chunk: int = 1024,
                             compute_dtype=torch.bfloat16,
                             transform_extract=None, mesh=None):
    """Unbounded-slide inference: stream tile chunks through transform +
    extractor, then pool once over the small [T, L] feature matrix.

    Only one chunk of tiles plus the features are resident on the device,
    so slides of 50k+ tiles classify on one card. Exact, not approximate:
    the pool is linear over tiles and the per-bag batch-norm takes its
    statistics over the whole feature matrix. The default per-chunk
    program (:func:`make_transform_extract`) runs the fused uint8 stem
    kernel where :func:`fused_stem_applies` (a CUDA chunk of uint8 300 px
    tiles at ``resolution`` 300 through the bf16 ResNet-26), and the eval
    transform with cuDNN's stem elsewhere. ``transform_extract``, the JAX
    package's hook, replaces it with any ``(cnn, raw uint8 chunk on the
    device) -> [N, L]`` function, such as the int8 serving path's. Returns
    (probs, outputs dict, coords), as :func:`classify_slide`.

    With ``mesh``, every rank of the mesh calls this for the same slide:
    each chunk (:func:`streaming_chunk_for`) spreads its tiles over every
    rank (the JAX package's ``tile_stream_sharding``), each rank extracts
    its share, the features are gathered onto every rank and each pools
    the whole [T, L] matrix once. A slide whose reading or extraction
    fails on one rank raises on every rank, before any of them gathers."""
    profiling.count("stream.slides")
    with profiling.annotate("port.slide"):
        extract = (transform_extract if transform_extract is not None
                   else make_transform_extract(cfg, resolution=resolution,
                                               compute_dtype=compute_dtype))

        def local():
            _serving_device(model, builder)
            if builder.params.get("resolution") != resolution:
                builder.update_resolution_and_buffer(resolution)
            return _streamed_rows(model, cfg, builder, chunk, extract, mesh)

        # the extraction runs no collective: on a mesh a slide that fails on
        # one rank fails on all of them before the gather
        T, coords, step, rows = (
            local() if mesh is None else M.run_together(
                local, mesh, what="streaming a slide",
                agree_on=lambda r: r[0]))
        if T == 0:
            # a tile-less slide goes through the one-pass forward, whose
            # fallback is the post-transform f32 zero bag
            # (RoiBuilder._empty_bag) that validation feeds too
            return classify_slide(model, cfg, builder, resolution=resolution,
                                  compute_dtype=compute_dtype)
        if mesh is None:
            H = rows[:T]
        else:
            # rank r's row j of chunk c is row c * step + r * share + j
            H = all_gather_cat(rows, mesh.world_group).reshape(
                mesh.size, -1, step // mesh.size, cfg.L).transpose(
                    0, 1).reshape(-1, cfg.L)[:T]
        probs, outs = _pool_outputs(model, H, cfg)
        return probs.ravel(), outs, coords


def _streamed_rows(model, cfg, builder, chunk, extract, mesh):
    """This rank's features of ``builder``'s tile cache: ``(T, coords,
    step, rows)``. The cache streams in chunks of ``step`` tiles
    (:func:`streaming_chunk_for`) through ``extract``; with ``mesh`` each
    chunk splits over every rank and this rank takes its share (the JAX
    package's ``tile_stream_sharding``). ``rows`` holds, at ``c * share``
    for the chunk ``c``, this rank's ``share = step // ranks`` features of
    it, zero past the end of the slide; alone, that is the [T, L] feature
    matrix and a little padding."""
    n, rank = (1, 0) if mesh is None else (mesh.size, mesh.rank)
    # mmap: a 50k-tile 1200 px cache is ~200 GB; the loop copies one share
    # of a chunk at a time off the map
    raw, coords = builder._load_cache(with_coords=True, mmap=True)
    T = raw.shape[0]
    step = streaming_chunk_for(T, chunk, n)
    share = step // n
    device = builder.device
    rows = torch.zeros((-(-T // step) * share, cfg.L), dtype=torch.float32,
                       device=device)
    for lo, part in staged_chunks(raw, step, device, rank=rank, ranks=n):
        at = lo // step * share
        with profiling.annotate("port.extract"):
            rows[at:at + part.shape[0]] = extract(model.cnn, part)
    return T, coords, step, rows


def _pool_outputs(model, H, cfg, *, mask=None, group=None):
    """Pool the [T, L] features of one slide (this rank's rows of it with
    ``group``): (probs [1, C], host outputs with ``y_pred``, ``y_pred_hat``
    and ``Fterm``)."""
    pooled = amil.attention_pool(model, H, cfg, mask=mask, group=group)
    with profiling.annotate("port.home"):
        pooled = {k: _host(v) for k, v in pooled.items()}
        features = _host(H)
    z = pooled["logits"].astype(np.float32)
    z = np.exp(z - z.max(axis=1, keepdims=True))
    probs = z / z.sum(axis=1, keepdims=True)
    return probs, {**pooled, "y_pred": probs, "y_pred_hat": np.argmax(probs),
                   "Fterm": features}


def make_batched_infer(cfg: amil.MILConfig, *, mesh=None,
                       compute_dtype=torch.bfloat16, extractor=None,
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
    [B, K, O], ``Aterm_var`` [B] and ``Aterm``, a list of [K, T_i].

    With ``mesh``, every rank calls ``fn(model, bags)`` with the whole
    group (host arrays or CPU tensors): the group is padded with
    one-tile zero bags to a multiple of the slide axis and each bag with
    zero-mask tiles to a multiple of the tile axis, each rank runs its
    share (``steps.shard_batch``), and the padding is trimmed from every
    output, which every rank returns."""
    def embed(model, tiles):
        if transform_resolution is not None:
            tiles = transforms.eval_transform(
                tiles, resolution=amil.input_resolution(
                    cfg, transform_resolution))
        if extractor is not None:
            return extractor(model.cnn, tiles).float()
        return amil.embed(model.cnn, tiles, cfg, compute_dtype=compute_dtype)

    def stack(rows):
        return {"y_pred": np.stack([r["y_pred"] for r in rows]),
                "y_pred_hat": np.asarray([r["y_pred_hat"] for r in rows]),
                "Mterm": np.stack([r["Mterm"] for r in rows]),
                "Aterm_var": np.asarray([r["Aterm_var"] for r in rows]),
                "Aterm": [r["Aterm"] for r in rows]}

    def infer_mesh(model, bags):
        from .steps import shard_batch

        n_real, t = len(bags), mesh.shape[M.TILES_AXIS]

        def local():
            group = [b if isinstance(b, torch.Tensor)
                     else torch.from_numpy(np.array(b)) for b in bags]
            dummy = group[0].new_zeros((1,) + tuple(group[0].shape[1:]))
            group += [dummy] * (-n_real % mesh.shape[M.SLIDES_AXIS])
            sizes = [int(b.shape[0]) for b in group]
            padded = [pad_bag(b, n_tiles=-(-n // t) * t)
                      for b, n in zip(group, sizes)]
            mine, tiles, masks, _ = shard_batch(
                mesh, [p[0] for p in padded], [p[1] for p in padded],
                [0] * len(group))
            return sizes, mine, tiles, masks, embed(model,
                                                    torch.cat(tiles, dim=0))

        # reading and extracting run no collective: a group that fails on
        # one rank fails on all of them before the pool's all-reduces
        sizes, mine, tiles, masks, H = M.run_together(
            local, mesh, what="a batched group")
        rows = {}
        for b, h, m in zip(mine, torch.split(H, [x.shape[0] for x in tiles]),
                           masks):
            out = _pool_outputs(model, h, cfg, mask=m,
                                group=mesh.tiles_group)[1]
            out["Aterm"] = all_gather_cat(
                torch.as_tensor(out["Aterm"]).to(mesh.device),
                mesh.tiles_group, dim=1)[:, :sizes[b]].cpu().numpy()
            if mesh.tile == 0:
                rows[b] = {k: out[k] for k in ("y_pred", "y_pred_hat",
                                               "Mterm", "Aterm_var",
                                               "Aterm")}
        everyone = [rows]
        if not alone(mesh.world_group):
            everyone = [None] * mesh.size
            dist.all_gather_object(everyone, rows, group=mesh.world_group)
        merged = {b: r for part in everyone for b, r in part.items()}
        return stack([merged[b] for b in range(n_real)])

    def infer(model, bags):
        sizes = [int(b.shape[0]) for b in bags]
        if min(sizes) < 1:
            raise ValueError("a bag of the group has no tiles")
        H = embed(model, torch.cat(list(bags), dim=0))
        return stack([_pool_outputs(model, h, cfg)[1]
                      for h in torch.split(H, sizes, dim=0)])
    return torch.no_grad()(infer if mesh is None else infer_mesh)


def classify_slides_batched(model, cfg: amil.MILConfig, bags, *,
                            compute_dtype=torch.bfloat16, infer_fn=None,
                            mesh=None):
    """bags: list of ``[T_i, H, W, 3]`` host arrays (or tensors), each
    with at least one tile. Runs one batched forward on the model's device
    (:func:`make_batched_infer`; ``infer_fn`` is one the caller built, such
    as the daemon's with a fused uint8 transform), or, with ``mesh``, on
    every rank of the mesh, each taking its share. Returns
    (probs [B, C], outputs dict)."""
    infer = infer_fn or make_batched_infer(cfg, mesh=mesh,
                                           compute_dtype=compute_dtype)
    if mesh is None:
        device = module_device(model)
        bags = [b.to(device) if isinstance(b, torch.Tensor)
                else torch.from_numpy(np.array(b)).to(device) for b in bags]
    outs = infer(model, bags)
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
