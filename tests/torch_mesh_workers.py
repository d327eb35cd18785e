"""The functions that the mesh tests run on spawned ranks.

``parallel.mesh.launch`` spawns each rank as a fresh interpreter that
imports the function it runs by module path, so this module imports
neither JAX nor the JAX package: the test files that import both hand
their inputs over as numpy arrays and compare what comes back. Every
function takes the rank's ``Mesh`` first and returns numpy values.
"""

import time

import torch

from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.models import (
    attention_mil as amil,
)
from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.data import (
    roibuilder,
)
from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.parallel import (
    inference,
    shard_pool,
    steps,
)


def _model(cfg_kwargs, state):
    torch.set_num_threads(1)
    cfg = amil.MILConfig(**cfg_kwargs)
    model = amil.AttentionMIL(cfg, device="cpu")
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    return cfg, model


def _numpy(tree):
    return {k: (v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
                else v) for k, v in tree.items()}


def eval_session(mesh, cfg_kwargs, state, pool_cases, bags, slide):
    """The eval paths on the mesh: the explicit sharded pool of each whole
    ``(H [T, L], mask [T])`` of ``pool_cases`` (each rank feeding its
    share), ``classify_slides_batched(mesh=)`` on the raw uint8 ``bags``
    (the eval transform at 32 px on the rank), and
    ``classify_slide_streaming(mesh=)`` on ``slide``, ``(cache_dir,
    path, roi, chunk)``, at 32 px; all in float32."""
    import os

    cfg, model = _model(cfg_kwargs, state)
    pool = shard_pool.make_sharded_pool(cfg, mesh)
    pooled = []
    for H, mask in pool_cases:
        h, m = shard_pool.shard_features(mesh, torch.from_numpy(H),
                                         torch.from_numpy(mask))
        pooled.append(_numpy(pool(model, h, m)))
    infer = inference.make_batched_infer(cfg, mesh=mesh, compute_dtype=None,
                                         transform_resolution=32)
    probs, outs = inference.classify_slides_batched(model, cfg, bags,
                                                    infer_fn=infer)
    cache_dir, path, roi, chunk = slide
    os.environ["CACHE_DIR"] = cache_dir
    builder = roibuilder.RoiBuilder(path, {"roi_size": roi}, device="cpu")
    sprobs, souts, coords = inference.classify_slide_streaming(
        model, cfg, builder, resolution=32, chunk=chunk, compute_dtype=None,
        mesh=mesh)
    return {"pooled": pooled, "batched": (probs, outs),
            "streaming": (sprobs, _numpy(souts), coords)}


def train_window(mesh, cfg_kwargs, state, tiles, masks, labels, weights,
                 scores, keep, lr, windows=1):
    """``windows`` window steps of ``make_train_step(mesh=)`` on the same
    bags with injected noise; returns the parameters after them, Adam's
    first moments (``mu``, by parameter name) and the last window's
    metrics."""
    cfg, model = _model(cfg_kwargs, state)
    opt = steps.make_optimizer(model)
    steps.replicate_state(mesh, model, opt)
    step = steps.make_train_step(cfg, mesh=mesh)
    B = len(tiles)
    for _ in range(windows):
        metrics = step(model, opt, [torch.from_numpy(t) for t in tiles],
                       [torch.from_numpy(m) for m in masks], labels, lr,
                       bag_weights=weights,
                       scores=[torch.from_numpy(scores)] * B,
                       keep=[torch.from_numpy(keep)] * B)
    mu = {name: opt.state[p]["exp_avg"]
          for name, p in model.named_parameters()}
    return {"params": _numpy(model.state_dict()), "mu": _numpy(mu),
            "metrics": _numpy(metrics)}


def fail_on_rank(mesh, bad):
    """Rank ``bad`` raises; the others would run for a minute."""
    if mesh.rank == bad:
        raise RuntimeError(f"rank {bad} fails on purpose")
    time.sleep(60)


def serve_failing(mesh, argv, where):
    """One rank of ``serve --mesh 2`` (``serve._mesh_rank``) with a fault
    on one rank: ``"read"``, rank 1 cannot read ``GHP_9_B``'s tile cache;
    ``"calibrate"``, rank 0's first int8 calibration raises; ``"group"``,
    rank 1's first extractor call on a 24-tile batch (the share of a
    ``--batch 2`` group of two 24-tile slides) raises. Returns the rank's
    exit code."""
    from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.models import (
        resnet,
    )
    from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.ops import (
        quant,
    )
    from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.train import (
        serve,
    )

    torch.set_num_threads(1)
    calls = []
    if where == "read" and mesh.rank == 1:
        load = roibuilder.RoiBuilder._load_cache

        def failing_load(self, *args, **kwargs):
            if self.getname() == "GHP_9_B_H&E":
                raise OSError("unreadable tile cache (on purpose)")
            return load(self, *args, **kwargs)

        roibuilder.RoiBuilder._load_cache = failing_load
    elif where == "calibrate" and mesh.rank == 0:
        calibrate = quant.quantize_and_calibrate

        def failing_calibrate(*args, **kwargs):
            calls.append(None)
            if len(calls) == 1:
                raise RuntimeError("calibration fails on purpose")
            return calibrate(*args, **kwargs)

        quant.quantize_and_calibrate = failing_calibrate
    elif where == "group" and mesh.rank == 1:
        extract = resnet.apply_resnet26

        def failing_extract(cnn, tiles, **kwargs):
            if tiles.shape[0] == 24 and not calls:
                calls.append(None)
                raise RuntimeError("extraction fails on purpose")
            return extract(cnn, tiles, **kwargs)

        resnet.apply_resnet26 = failing_extract
    return serve._mesh_rank(mesh, argv)
