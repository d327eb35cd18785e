"""The functions that the mesh tests run on spawned ranks.

``parallel.mesh.launch`` spawns each rank as a fresh interpreter that
imports the function it runs by module path, so this module imports
neither JAX nor the JAX package: the test files that import both hand
their inputs over as numpy arrays and compare what comes back. Every
function takes the rank's ``Mesh`` first and returns numpy values.
"""

import copy
import time

import torch

from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.models import (
    attention_mil as amil,
)
from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.data import (
    roibuilder,
)
from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.models import (
    stylegan as sg,
)
from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.ops.collectives import (
    all_reduce_,
)
from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.parallel import (
    inference,
    shard_pool,
    steps,
)
from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.parallel import (
    mesh as M,
)
from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.train import (
    gan,
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


def serve_slow_build(mesh, argv, name, staged, delay_s):
    """One rank of ``serve --mesh 2`` whose rank 0 builds slide ``name``'s
    tile cache first-sight and slowly: the build sleeps ``delay_s`` (more
    than the group's timeout), then puts the cache files held in
    ``staged`` in place. Returns the rank's exit code."""
    import os
    import shutil

    from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.train import (
        serve,
    )

    torch.set_num_threads(1)
    if mesh.rank == 0:
        build = roibuilder.RoiBuilder.build

        def slow_build(self):
            if self.getname() == name:
                time.sleep(delay_s)
                for key in ("coor_cache", "data_cache"):
                    path = self.params[key]
                    shutil.copy(os.path.join(staged, os.path.basename(path)),
                                path)
            return build(self)

        roibuilder.RoiBuilder.build = slow_build
    return serve._mesh_rank(mesh, argv)


def bag_metrics(mesh, cfg_kwargs, state, bags):
    """Each ``(tiles [T, H, W, 3], H [T, L], mask [T], label)`` of
    ``bags`` with its rows split over the mesh's tile group (padded with
    zero-mask rows to the tile axis): the eval forward of the tiles
    (``KLD``, ``Aterm_mu``, ``Aterm_var``, ``loss``, ``y_pred``, keyed
    ``bag``) and ``attention_pool`` of the features (``KLD``,
    ``Aterm_mu``, ``Aterm_var``, keyed ``pool``), the bag's, on this
    rank."""
    cfg, model = _model(cfg_kwargs, state)
    out = []
    with torch.no_grad():
        for tiles, H, mask, label in bags:
            t, m = shard_pool.shard_features(mesh, torch.from_numpy(tiles),
                                             torch.from_numpy(mask))
            outs = amil.apply_attention_mil(model, t, label, cfg, mask=m,
                                            group=mesh.tiles_group)
            h, m = shard_pool.shard_features(mesh, torch.from_numpy(H),
                                             torch.from_numpy(mask))
            pooled = amil.attention_pool(model, h, cfg, mask=m,
                                         group=mesh.tiles_group)
            out.append({
                "bag": _numpy({k: outs[k] for k in (
                    "KLD", "Aterm_mu", "Aterm_var", "loss", "y_pred")}),
                "pool": _numpy({k: pooled[k] for k in (
                    "KLD", "Aterm_mu", "Aterm_var")})})
    return out


def full_tree_sync(params, live, mesh):
    """The StyleGAN's gradient sync over the whole tree, the reference of
    the live-only sync: every gradient of ``params``, a missing one as
    zeros, in one all-reduce (``live`` is ignored)."""
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    flat = torch.cat([p.grad.reshape(-1) for p in params])
    all_reduce_(flat, mesh.group)
    start = 0
    for p in params:
        p.grad.copy_(flat[start:start + p.numel()].view_as(p.grad))
        start += p.numel()


def _gan_pair(width, code, seed=2):
    gen = sg.init_styled_generator(torch.Generator().manual_seed(seed),
                                   style_dim=code, width_mult=width,
                                   device="cpu")
    disc = sg.init_discriminator(torch.Generator().manual_seed(seed + 1),
                                 width_mult=width, device="cpu")
    return gen, disc


def _gan_step_pair(dm, gen, disc, step, alpha, real, zs, seed, grad_accum=1):
    """One critic and one generator step of the data mesh ``dm`` on the
    whole batch ``real`` / ``zs``, with draws from ``seed``."""
    ema = copy.deepcopy(gen).requires_grad_(False)
    g_opt, d_opt = gan.make_optimizers(gen, disc)
    B = real.shape[0]
    draws = torch.Generator().manual_seed(seed)
    sel = [0] * gen.n_blocks
    gan.make_d_step(step, grad_accum=grad_accum, mesh=dm)(
        gen, disc, d_opt, real, zs, sel, alpha, 1e-3,
        gan.draw_d(draws, disc, B, step))
    gan.make_g_step(step, grad_accum=grad_accum, mesh=dm)(
        gen, disc, g_opt, ema, zs, sel, alpha, 1e-3,
        gan.draw_g(draws, disc, B, step))
    return ema


def gan_live_sets(mesh, width, code, cases):
    """For each ``(step, alpha)`` of ``cases``, one critic and one
    generator step on a data mesh over the world: per step, the names of
    the parameters this rank's backward reached (those with a gradient
    when the sync starts) and of the live set the sync sums."""
    torch.set_num_threads(1)
    dm = M.data_mesh(device="cpu")
    real_sync = gan._sync_grads
    out = []
    for step, alpha in cases:
        gen, disc = _gan_pair(width, code)
        names = {id(p): "generator." + n for n, p in gen.named_parameters()}
        names.update({id(p): "discriminator." + n
                      for n, p in disc.named_parameters()})
        record = []

        def spy(params, live, m):
            record.append((sorted(names[id(p)] for p in params
                                  if p.grad is not None),
                           [names[id(p)] for p in live]))
            return real_sync(params, live, m)

        B, res = 2 * dm.size, 4 * 2 ** step
        gan._sync_grads = spy
        try:
            _gan_step_pair(dm, gen, disc, step, alpha,
                           torch.ones((B, 3, res, res)),
                           torch.ones((1, B, code)), 5)
        finally:
            gan._sync_grads = real_sync
        out.append(record)
    return out


def gan_sync_ab(mesh, width, code, step, cases, real, zs):
    """For each ``(alpha, grad_accum)`` of ``cases``, one critic and one
    generator step on a data mesh over the world from the same seeded
    weights, batch and draws, with the live-only sync and then with
    :func:`full_tree_sync`: the critic, the generator and the EMA after
    each, by name."""
    torch.set_num_threads(1)
    dm = M.data_mesh(device="cpu")
    real_sync = gan._sync_grads
    out = []
    for alpha, accum in cases:
        pair = {}
        for label, sync in (("live", real_sync), ("full", full_tree_sync)):
            gen, disc = _gan_pair(width, code)
            gan._sync_grads = sync
            try:
                ema = _gan_step_pair(dm, gen, disc, step, alpha,
                                     torch.from_numpy(real),
                                     torch.from_numpy(zs), 7, accum)
            finally:
                gan._sync_grads = real_sync
            pair[label] = {f"{part}.{k}": v.detach().numpy().copy()
                           for part, module in (("generator", gen),
                                                ("discriminator", disc),
                                                ("ema", ema))
                           for k, v in module.state_dict().items()}
        out.append(pair)
    return out


def recorder_rules(mesh):
    """Every collective entry point under ``tools/torch_comm_audit``'s
    recorder on this rank, and the port's pass-through wrappers: the
    records as ``(op, payload bytes, dtype, group size, call site)``, the
    tally of all-reduces, the entry points restored after, the summed
    wrapper's gradient and the gathered rows."""
    import torch.distributed as dist

    from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.ops import (
        collectives,
    )
    from tools import torch_comm_audit as A

    real = {op: getattr(dist, op) for op in A.COLLECTIVES}
    x = torch.ones(100)
    with A.record_collectives() as recs:
        dist.all_reduce(x)
        dist.all_reduce(torch.ones((4, 4), dtype=torch.bfloat16))
        out = [torch.empty(8, dtype=torch.uint8) for _ in range(mesh.size)]
        dist.all_gather(out, torch.ones(8, dtype=torch.uint8))
        dist.broadcast(torch.ones(3, dtype=torch.float64), src=0)
        objs = [{"a": 1}, (2, 3)] if mesh.rank == 0 else [None, None]
        dist.broadcast_object_list(objs, src=0)
        gathered = [None] * mesh.size
        dist.all_gather_object(gathered, ["x"])
        dist.barrier()
        collectives.all_reduce_(torch.ones(2), dist.group.WORLD)
        y = torch.ones(5, requires_grad=True)
        collectives.all_reduce_sum(y, dist.group.WORLD).sum().backward()
        rows = collectives.all_gather_cat(
            torch.full((2, 3), float(mesh.rank)), dist.group.WORLD)
    restored = all(getattr(dist, op) is f for op, f in real.items())
    dist.all_reduce(x)  # not recorded
    return {"records": [(r["op"], r["payload_bytes"], r["dtype"],
                         r["group_size"], r["call_site"]) for r in recs],
            "all_reduce": A.tally(recs)["all_reduce"], "restored": restored,
            "objs": objs, "grad": y.grad.numpy(), "rows": rows.numpy()}
