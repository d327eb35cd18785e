"""Counted collective audit of the PyTorch port's mesh programs.

The twin of ``tools/comm_audit.py``. There XLA places the collectives of
each sharded program and the tool reads them off the compiled HLO. The
port writes every collective by hand (``ops/collectives.py``, and direct
``torch.distributed`` calls in ``parallel/``, ``models/`` and ``train/``),
so this tool counts them as they run: :func:`record_collectives` wraps the
collective entry points of ``torch.distributed`` while it is open, and
:func:`run_audit` drives the same six program families as the JAX tool in
one ``parallel/mesh.launch`` of ``n`` ranks, each rank recording its own
calls. Counts and payloads are properties of the program, not of the
device: gloo ranks on the CPU give the table that NCCL ranks on cards
give.

Each row has the JAX tool's layout (``workload``, ``mesh``,
``collectives {op: {count, payload_bytes}}``, ``payload_bytes_total``,
``predicted_payload_bytes``, ``measured_over_predicted``, ``note``) plus
``call_sites`` (the same tallies by the port function that issued each
collective), ``parts`` (the split the family's note explains) and ``jax``,
the row of the same workload in the committed ``SCALING_MEASURED.json``.
The predictions are the JAX tool's: one f32 parameter tree for a
data-parallel step, ``4*(1+2L+K+K*O)`` bytes for the pool's statistics,
zero inside the extract. :func:`expected_rows` gives the port's own counts
and bytes for any world size and widths; ``tests/test_torch_comm_audit.py``
pins them.

Usage:
    python tools/torch_comm_audit.py --devices 4 --test-width   # CPU, gloo
    python tools/torch_comm_audit.py --devices 4                # full width
    python tools/torch_comm_audit.py --devices 2 --device cuda  # NCCL cards
    python tools/torch_comm_audit.py --devices 2 --device cuda --one-card \
        --test-width                          # two gloo ranks on cuda:0

Prints the rows as JSON with the families that differ from
:func:`expected_rows` (``pins_mismatches``; exit code 1 when any does);
writes them to a file only with ``--out`` (never to
``SCALING_MEASURED.json``, the JAX tool's artifact).
"""

import argparse
import contextlib
import copy
import functools
import inspect
import json
import os
import pickle
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _REPO not in sys.path:  # the repo root, for `python tools/...`
    sys.path.insert(0, _REPO)

from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.data import (  # noqa: E402
    roibuilder,
)
from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.models import (  # noqa: E402
    attention_mil as amil,
)
from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.models import (  # noqa: E402
    stylegan as sg,
)
from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.parallel import (  # noqa: E402
    inference,
    shard_pool,
    steps,
)
from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.parallel import (  # noqa: E402
    mesh as M,
)
from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.train import (  # noqa: E402
    gan,
)

PORT = "deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch"
_PORT_DIR = os.path.join(_REPO, PORT)
SCALING_MEASURED = os.path.join(_REPO, "SCALING_MEASURED.json")

# the collective entry points of torch.distributed that the recorder wraps
COLLECTIVES = ("all_reduce", "all_gather", "all_gather_into_tensor",
               "reduce_scatter_tensor", "broadcast", "broadcast_object_list",
               "all_gather_object", "barrier", "send", "recv")
# the argument whose size is the payload: the synced tensor, or the
# gathered (or scattered) result, which is how the JAX tool counts a
# result shape; object collectives count their pickled objects
_PAYLOAD_ARG = {"all_reduce": "tensor", "broadcast": "tensor",
                "send": "tensor", "recv": "tensor",
                "all_gather": "tensor_list",
                "all_gather_into_tensor": "output_tensor",
                "reduce_scatter_tensor": "output",
                "broadcast_object_list": "object_list",
                "all_gather_object": "object_list", "barrier": None}
_OBJECT_OPS = ("broadcast_object_list", "all_gather_object")
# the thin wrappers of ops/collectives.py pass a call through: a record
# names their caller, except for a differentiable sum's backward, which
# the autograd engine calls (on the card, from its own thread)
_PASS_THROUGH = "ops/collectives.py"

TEST_CFG = dict(widths=(8, 8, 8, 8), blocks=(1, 1, 1, 1))
WINDOW = 5                   # bags a window step, the reference's accum
BAG_TILES = 40               # each bag's tiles (a 20 % subsample of 8)
TILE_PX = 32
GAN_STEP = 1                 # 8 px, the JAX tool's res_step
GAN_ALPHA = 1.0              # the fade-in done: no skip branch runs
GAN_CODE = 512
POOL_TILES_PER_RANK = 32     # the JAX tool's T4 = 32 * n


def _tensor_bytes(t) -> int:
    return t.numel() * t.element_size()


def _pickled_bytes(objects):
    try:
        return sum(len(pickle.dumps(o)) for o in objects)
    except (pickle.PicklingError, TypeError, AttributeError):
        return None


def _payload(op, args):
    """(payload bytes, dtype name) of one call, from its bound arguments
    (read after the call, when a gathered result is filled in)."""
    key = _PAYLOAD_ARG[op]
    if key is None:
        return 0, None
    x = args[key]
    if op in _OBJECT_OPS:
        return _pickled_bytes(x), None
    if isinstance(x, (list, tuple)):
        return (sum(_tensor_bytes(t) for t in x),
                str(x[0].dtype).replace("torch.", "") if x else None)
    return _tensor_bytes(x), str(x.dtype).replace("torch.", "")


def _port_frames(frame):
    """``(call site, stack)`` of a collective issued below ``frame``: the
    stack is every frame inside the port package, innermost first, as
    ``file:function`` relative to the package; the call site is the first
    of them that is not a pass-through wrapper of ``ops/collectives.py``
    (its ``backward`` counts as a site), else the first of them."""
    stack = []
    while frame is not None:
        path = os.path.abspath(frame.f_code.co_filename)
        if path.startswith(_PORT_DIR + os.sep):
            rel = os.path.relpath(path, _PORT_DIR).replace(os.sep, "/")
            stack.append(f"{rel}:{frame.f_code.co_name}")
        frame = frame.f_back
    site = next((s for s in stack if not s.startswith(_PASS_THROUGH + ":")
                 or s.endswith(":backward")), stack[0] if stack else None)
    return site, stack


def _recording(op, real, records):
    sig = inspect.signature(real)

    @functools.wraps(real)
    def call(*args, **kwargs):
        t0 = time.perf_counter()
        out = real(*args, **kwargs)
        seconds = time.perf_counter() - t0
        bound = sig.bind(*args, **kwargs).arguments
        payload, dtype = _payload(op, bound)
        site, stack = _port_frames(sys._getframe(1))
        records.append({"op": op,
                        "group_size": dist.get_world_size(bound.get("group")),
                        "dtype": dtype, "payload_bytes": payload,
                        "call_site": site, "stack": stack,
                        "seconds": seconds})
        return out

    return call


@contextlib.contextmanager
def record_collectives():
    """Record every call of the ``torch.distributed`` collectives of
    :data:`COLLECTIVES` made while the context is open, as dicts (``op``,
    ``group_size``, ``dtype``, ``payload_bytes``, ``call_site``, ``stack``,
    ``seconds``: the host time of the call) appended to the list it
    yields. The calls still run. The port calls them as
    ``dist.<name>``, so wrapping the module attributes catches every call
    site."""
    records = []
    saved = {op: getattr(dist, op) for op in COLLECTIVES}
    for op, real in saved.items():
        setattr(dist, op, _recording(op, real, records))
    try:
        yield records
    finally:
        for op, real in saved.items():
            setattr(dist, op, real)


def tally(records) -> dict:
    """``{op: {"count", "payload_bytes"}}`` over ``records`` (the JAX
    tool's ``parse_collectives`` layout; an object collective whose size
    could not be had adds 0 bytes)."""
    stats = {}
    for r in records:
        entry = stats.setdefault(r["op"], {"count": 0, "payload_bytes": 0})
        entry["count"] += 1
        entry["payload_bytes"] += r["payload_bytes"] or 0
    return stats


def by_call_site(records) -> dict:
    """``{call site: {op: {"count", "payload_bytes", "group_sizes"}}}``."""
    sites = {}
    for r in records:
        entry = sites.setdefault(str(r["call_site"]), {}).setdefault(
            r["op"], {"count": 0, "payload_bytes": 0, "group_sizes": []})
        entry["count"] += 1
        entry["payload_bytes"] += r["payload_bytes"] or 0
        if r["group_size"] not in entry["group_sizes"]:
            entry["group_sizes"].append(r["group_size"])
    return sites


def _within(records, frame):
    return [r for r in records if frame in r["stack"]]


def _without(records, frame):
    return [r for r in records if frame not in r["stack"]]


def _total(stats) -> int:
    return sum(v["payload_bytes"] for v in stats.values())


def summarize(name, records, predicted, mesh, note, parts=None):
    """One row in the JAX tool's layout, with the port's ``call_sites``,
    ``parts`` (each a tally of the records it names) and ``host_ms`` (the
    host time of the recorded calls)."""
    stats = tally(records)
    payload = _total(stats)
    return {"workload": name, "mesh": mesh, "collectives": stats,
            "payload_bytes_total": payload,
            "predicted_payload_bytes": predicted,
            "measured_over_predicted": (round(payload / predicted, 4)
                                        if predicted else None),
            "note": note, "call_sites": by_call_site(records),
            "parts": {k: tally(v) for k, v in (parts or {}).items()},
            "host_ms": 1e3 * sum(r["seconds"] for r in records)}


def tree_bytes(module) -> int:
    return sum(_tensor_bytes(p) for p in module.parameters())


def mil_config(full_width: bool) -> amil.MILConfig:
    return amil.MILConfig() if full_width else amil.MILConfig(**TEST_CFG)


def gan_width(full_width: bool) -> float:
    """The JAX tool's StyleGAN width: 0.25 at full width, 1/32 else."""
    return 0.25 if full_width else 1 / 32


def pool_statistics_bytes(cfg) -> int:
    """The JAX tool's prediction for the sharded pool: the count, the
    mean and variance [L], the L1 denominator [K] and the pooled product
    [K, O], all f32."""
    return 4 * (1 + 2 * cfg.L + cfg.K + cfg.K * cfg.O)


# ------------------------------------------------------------ the families
def _window(cfg, device, seed):
    """A window of WINDOW bags of BAG_TILES transformed tiles, labels and
    one seeded generator a bag (every rank draws the same noise)."""
    g = torch.Generator().manual_seed(seed)
    tiles = [torch.randn((BAG_TILES, TILE_PX, TILE_PX, 3),
                         generator=g).to(device) for _ in range(WINDOW)]
    masks = [torch.ones(BAG_TILES, device=device) for _ in range(WINDOW)]
    labels = [b % cfg.n_classes for b in range(WINDOW)]
    gens = [torch.Generator().manual_seed(seed + 1 + b)
            for b in range(WINDOW)]
    return tiles, masks, labels, gens


def _train_family(name, mesh, cfg, note):
    model = amil.init_attention_mil(torch.Generator().manual_seed(0), cfg,
                                    device=mesh.device)
    opt = steps.make_optimizer(model)
    tiles, masks, labels, gens = _window(cfg, mesh.device, 10)
    step = steps.make_train_step(cfg, mesh=mesh)
    with record_collectives() as records:
        step(model, opt, tiles, masks, labels, 1e-3, generators=gens)
    grads = _within(records, "parallel/steps.py:sync_grads")
    rows = [r for r in records if r["call_site"] == "parallel/steps.py:step"]
    tables = [r for r in records if r not in grads and r not in rows]
    shape = mesh.shape
    return summarize(
        name, records, tree_bytes(model),
        f"slides={shape[M.SLIDES_AXIS]},tiles={shape[M.TILES_AXIS]}", note,
        {"gradient": grads, "rows": rows, "tile_tables": tables})


def _streaming_family(mesh, cfg, slide):
    os.environ["CACHE_DIR"] = slide["cache"]
    model = amil.init_attention_mil(torch.Generator().manual_seed(0), cfg,
                                    device=mesh.device)
    builder = roibuilder.RoiBuilder(slide["path"],
                                    {"roi_size": TILE_PX},
                                    device=mesh.device)
    with record_collectives() as records:
        inference.classify_slide_streaming(
            model, cfg, builder, resolution=TILE_PX, chunk=slide["chunk"],
            compute_dtype=None, mesh=mesh)
    loop = _within(records, "parallel/inference.py:_streamed_rows")
    chunks = -(-slide["tiles"] // inference.streaming_chunk_for(
        slide["tiles"], slide["chunk"], mesh.size))
    return summarize(
        "streaming_extract", records, 0, f"tiles={mesh.size} (world)",
        "prediction: ZERO collectives in the extract (the JAX tool's "
        f"row). A slide of {slide['tiles']} tiles in {chunks} chunks: "
        "'chunk_loop' is what runs inside the chunk loop "
        "(inference._streamed_rows), 'per_slide' what runs once a slide "
        "around it (run_together's flags, the features' all-gather)",
        {"chunk_loop": loop, "per_slide": _without(
            records, "parallel/inference.py:_streamed_rows")})


def _pool_family(mesh, cfg):
    model = amil.init_attention_mil(torch.Generator().manual_seed(0), cfg,
                                    device=mesh.device)
    T = POOL_TILES_PER_RANK * mesh.size
    H = torch.randn((T, cfg.L), generator=torch.Generator().manual_seed(4))
    h, m = shard_pool.shard_features(mesh, H, torch.ones(T))
    pool = shard_pool.make_sharded_pool(cfg, mesh)
    with record_collectives() as records:
        pool(model, h, m)
    return summarize(
        "explicit_psum_pool", records, pool_statistics_bytes(cfg),
        f"tiles={mesh.size}",
        "prediction: the JAX tool's 4*(1+2L+K+K*O) bytes (count, mean, "
        "var, L1 denominator, pooled A^T B). 'statistics' are those four "
        "all-reduces, as the JAX function's (the pool computes no "
        "metric); 'aterm_gather' is make_sharded_pool's all-gather of "
        "Aterm [K, T], which stands for the JAX function's sharded "
        "out_specs",
        {"statistics": [r for r in records if r["op"] == "all_reduce"],
         "aterm_gather": [r for r in records if r["op"] == "all_gather"]})


def _gan_nets(device, width):
    g = sg.init_styled_generator(torch.Generator().manual_seed(2),
                                 style_dim=GAN_CODE, width_mult=width,
                                 device=device)
    d = sg.init_discriminator(torch.Generator().manual_seed(3),
                              width_mult=width, device=device)
    return g, d


def _gan_families(mesh, width):
    dm = M.data_mesh(device=mesh.device)
    dev = mesh.device
    B = dm.size
    res = 4 * 2 ** GAN_STEP
    gen, disc = _gan_nets(dev, width)
    ema = copy.deepcopy(gen).requires_grad_(False)
    g_opt, d_opt = gan.make_optimizers(gen, disc)
    real = torch.ones((B, 3, res, res), device=dev)
    zs = torch.ones((1, B, GAN_CODE), device=dev)
    sel = [0] * gen.n_blocks
    draws = torch.Generator(device=dev).manual_seed(5)
    d_draws = gan.draw_d(draws, disc, B, GAN_STEP)
    g_draws = gan.draw_g(draws, disc, B, GAN_STEP)
    desc = f"data={dm.size} (width_mult={width}, res={res})"
    rows = []
    for name, fn, args, net, note in (
            ("gan_d_step_dp", gan.make_d_step(GAN_STEP, mesh=dm),
             (gen, disc, d_opt, real, zs, sel, GAN_ALPHA, 1e-3, d_draws), disc,
             "prediction: one f32 D parameter tree (the JAX tool's). The "
             "port sums the gradients of the layers the step runs in one "
             "flat all-reduce (train/gan._sync_grads; the live set, "
             "stylegan.critic_live_parameters, follows from the step and "
             "alpha), the two loss terms in one more, and the minibatch "
             "stddev's mean and variance in each of the three critic "
             "passes, with their cotangents in the backward and the "
             "gradient penalty's double backward"),
            ("gan_g_step_dp", gan.make_g_step(GAN_STEP, mesh=dm),
             (gen, disc, g_opt, ema, zs, sel, GAN_ALPHA, 1e-3, g_draws), gen,
             "prediction: one f32 G parameter tree (the JAX tool's; XLA "
             "syncs only the live layers, 0.66x). The port's flat "
             "all-reduce takes the G gradients of the layers the step "
             "runs (stylegan.generator_live_parameters), as XLA's does; "
             "plus the loss and the critic pass's minibatch stddev, "
             "forward and backward")):
        with record_collectives() as records:
            fn(*args)
        grads = _within(records, "train/gan.py:_sync_grads")
        rows.append(summarize(name, records, tree_bytes(net), desc, note, {
            "gradient": grads,
            "minibatch_stddev": [r for r in records
                                 if "models/stylegan.py:minibatch_stddev"
                                 in r["stack"]
                                 or r["call_site"]
                                 == "ops/collectives.py:backward"],
            "loss": [r for r in records if r["call_site"]
                     in ("train/gan.py:d_step", "train/gan.py:g_step")]}))
    return rows


def _audit_rank(mesh, spec):
    """One rank of :func:`run_audit`: every family on the meshes of
    ``spec['devices']`` (each made by every rank, in one order). Returns
    the rows on rank 0, None elsewhere."""
    n, devices = mesh.size, spec["devices"]
    cfg = mil_config(spec["full_width"])
    if mesh.device.type == "cpu":
        torch.set_num_threads(1)
    dp = M.make_mesh(n, slides=n, devices=devices)
    grid = M.make_mesh(n, devices=devices)  # the JAX axis rule
    tiles = M.make_mesh(n, slides=1, devices=devices)
    rows = [
        _train_family(
            "classifier_train_dp", dp, cfg,
            "prediction: one f32 parameter tree (the JAX tool's). "
            "'gradient' is steps.sync_grads' one flat all-reduce, 'rows' "
            "the window's per-bag metric rows, 'tile_tables' the bag "
            "forward's and backward's sums over the tile group, which is "
            "one rank here and so issues none (rank 0 runs "
            f"{len(dp.bags(WINDOW))} of {WINDOW} bags)"),
        _train_family(
            "classifier_train_2d", grid, cfg,
            "prediction: the same tree plus O(kB) tile-axis statistics "
            "(the JAX tool's). 'tile_tables' per real bag, 8 sums: the "
            "forward's count, batch-norm mean and variance and the "
            "pool's [K, 1+O], and one detached sum of the metrics' "
            "partials (KLD, Aterm_mu, the column norms and the Gram "
            "matrix, 4*(1+2K+K^2) bytes); the backward's batch-norm "
            "cotangents and the pool's [K, 2] "
            f"(rank 0 runs {len(grid.bags(WINDOW))} of {WINDOW} bags)"),
        _streaming_family(tiles, cfg, spec["slide"]),
        _pool_family(tiles, cfg),
        *_gan_families(mesh, gan_width(spec["full_width"])),
    ]
    return rows if mesh.rank == 0 else None


# ---------------------------------------------------- the port's own counts
def _site(op, count, nbytes, group):
    return {op: {"count": count, "payload_bytes": nbytes,
                 "group_sizes": [group]}}


def _sum_sites(sites, keys=None) -> dict:
    """The ``tally`` of the ``call_sites`` entries named by ``keys`` (all
    when None)."""
    stats = {}
    for key, ops in sites.items():
        if keys is not None and key not in keys:
            continue
        for op, v in ops.items():
            e = stats.setdefault(op, {"count": 0, "payload_bytes": 0})
            e["count"] += v["count"]
            e["payload_bytes"] += v["payload_bytes"]
    return stats


def _expected(sites, parts) -> dict:
    """A family's expectation from its call sites; each part is the sum of
    the sites it names (all of them for None), or a tally given as is
    where a part cuts through a site."""
    return {"collectives": _sum_sites(sites), "call_sites": sites,
            "parts": {k: v if isinstance(v, dict) else _sum_sites(sites, v)
                      for k, v in parts.items()}}


def metric_sums_bytes(cfg) -> int:
    """The bag's one all-reduce of metric partials on a tile group of more
    than one rank: KLD's masked sum, Aterm_mu's column sums [K], the
    column squared sums [K] and the raw Gram matrix [K, K], f32."""
    return 4 * (1 + 2 * cfg.K + cfg.K * cfg.K)


def expected_window(n, slides, cfg, bags=WINDOW) -> dict:
    """A window step of ``bags`` real bags on rank 0 of a (slides, n /
    slides) mesh. On a tile group of more than one rank each of the
    rank's bags sums, in the forward, the bag's count, the batch-norm's
    mean and variance [L], the pool's [K, 1+O] and, in one detached sum,
    the metrics' partials (:func:`metric_sums_bytes`); in the backward the
    batch-norm's two cotangents [L] and the pool's [K, 2]: 7 sums that
    feed the loss and 1 of metrics. A tile group of one rank sums nothing.
    Then, on a world of more than one rank, one all-reduce of the gradient
    tree and one of the window's metric rows."""
    t = n // slides
    nb = -(-bags // slides)  # slide rank 0's share (Mesh.bags)
    L, K, O = cfg.L, cfg.K, cfg.O
    tree = tree_bytes(amil.AttentionMIL(cfg, device="meta"))
    sites = {}
    if t > 1:
        sites.update({
            "ops/nn.py:tile_count": _site("all_reduce", nb, 4 * nb, t),
            "ops/nn.py:_group_mean": _site("all_reduce", 2 * nb,
                                           8 * L * nb, t),
            "ops/gated_pool.py:forward": _site("all_reduce", nb,
                                               4 * K * (1 + O) * nb, t),
            "models/attention_mil.py:_group_diagnostics": _site(
                "all_reduce", nb, metric_sums_bytes(cfg) * nb, t),
            "ops/gated_pool.py:backward": _site("all_reduce", nb,
                                                8 * K * nb, t),
            "ops/collectives.py:backward": _site("all_reduce", 2 * nb,
                                                 8 * L * nb, t)})
    world = ("parallel/steps.py:_all_reduce_flat", "parallel/steps.py:step")
    if n > 1:
        sites.update({
            world[0]: _site("all_reduce", 1, tree, n),
            world[1]: _site("all_reduce", 1,
                            4 * bags * (len(steps._SCALARS)
                                        + cfg.n_classes + 1), n)})
    return _expected(sites, {
        "gradient": world[:1], "rows": world[1:],
        "tile_tables": [k for k in sites if k not in world]})


def gan_live_bytes(width) -> dict:
    """The bytes of the StyleGAN parameters that the audit's steps reach
    (step GAN_STEP, alpha 1), by family: what the gradient all-reduce
    moves."""
    gen = sg.StyledGenerator(GAN_CODE, 8, width, device="meta")
    disc = sg.Discriminator(width, device="meta")
    return {"gan_d_step_dp": sum(_tensor_bytes(p) for p in
                                 sg.critic_live_parameters(disc, GAN_STEP,
                                                           GAN_ALPHA)),
            "gan_g_step_dp": sum(_tensor_bytes(p) for p in
                                 sg.generator_live_parameters(gen, GAN_STEP,
                                                              GAN_ALPHA))}


def expected_rows(n: int, *, full_width: bool = True) -> dict:
    """The port's own collectives on rank 0 of :func:`run_audit`'s
    ``n``-rank launch, family by family, from what each call site sums:
    ``{workload: {"collectives", "call_sites", "parts"}}`` in the layout
    of the rows (``call_sites`` with each site's group size). These are
    the counts and bytes of the code as it stands, not a target: where
    they exceed the JAX tool's row, the extra is named in the row's
    note."""
    cfg = mil_config(full_width)
    L, K, O = cfg.L, cfg.K, cfg.O
    out = {"classifier_train_dp": expected_window(n, n, cfg),
           "classifier_train_2d": expected_window(n, M.slide_axis(n), cfg)}
    slide_T, chunk = 3 * 8 * n + 5, 8 * n
    step = inference.streaming_chunk_for(slide_T, chunk, n)
    gathered = 4 * L * step * -(-slide_T // step)
    out["streaming_extract"] = _expected(
        {"parallel/mesh.py:run_together": _site("all_reduce", 1, 24, n),
         "parallel/inference.py:classify_slide_streaming": _site(
             "all_gather", 1, gathered, n)},
        {"chunk_loop": [], "per_slide": None})
    T = POOL_TILES_PER_RANK * n
    # JAX's four all-reduces: the count, the batch-norm's mean and
    # variance, the pool's table; then the Aterm gather
    pool_sums = ["ops/nn.py:tile_count", "ops/nn.py:_group_mean",
                 "ops/gated_pool.py:forward"]
    out["explicit_psum_pool"] = _expected(
        {"ops/nn.py:tile_count": _site("all_reduce", 1, 4, n),
         "ops/nn.py:_group_mean": _site("all_reduce", 2, 8 * L, n),
         "ops/gated_pool.py:forward": _site("all_reduce", 1,
                                            4 * K * (1 + O), n),
         "parallel/shard_pool.py:pool": _site("all_gather", 1, 4 * K * T,
                                              n)},
        {"statistics": pool_sums,
         "aterm_gather": ["parallel/shard_pool.py:pool"]})
    width = gan_width(full_width)
    live = gan_live_bytes(width)
    # the minibatch stddev's mean and variance sums: [C, 4, 4] at the
    # critic's last block, C = its first channel count
    stddev = 4 * 16 * sg._disc_layout(width)[1][0]
    # the critic step: three passes forward, ten cotangents (the gradient
    # penalty's double backward among them), two loss terms; the
    # generator step: one pass forward and backward, one loss
    for name, fwd, bwd, loss, losses in (
            ("gan_d_step_dp", 6, 10, "train/gan.py:d_step", 2),
            ("gan_g_step_dp", 2, 2, "train/gan.py:g_step", 1)):
        out[name] = _expected(
            {"models/stylegan.py:minibatch_stddev": _site(
                "all_reduce", fwd, fwd * stddev, n),
             "ops/collectives.py:backward": _site("all_reduce", bwd,
                                                  bwd * stddev, n),
             "train/gan.py:_sync_grads": _site("all_reduce", 1, live[name],
                                               n),
             loss: _site("all_reduce", 1, 4 * losses, n)},
            {"gradient": ["train/gan.py:_sync_grads"],
             "minibatch_stddev": ["models/stylegan.py:minibatch_stddev",
                                  "ops/collectives.py:backward"],
             "loss": [loss]})
    return out


def pins_mismatch(rows, expected) -> list:
    """Each family of ``rows`` whose collectives, call sites or parts
    differ from ``expected`` (:func:`expected_rows`), as
    ``(workload, key, got, want)``."""
    bad = []
    for row in rows:
        want = expected[row["workload"]]
        for key in ("collectives", "call_sites", "parts"):
            if row[key] != want[key]:
                bad.append((row["workload"], key, row[key], want[key]))
    return bad


def write_slide(cache_dir, n, seed=0) -> dict:
    """A tile cache for the streaming family, in the RoiBuilder's layout
    under ``cache_dir``: ``3 * 8n + 5`` tiles of TILE_PX, streamed in
    chunks of ``8n`` (four chunks)."""
    chunk = 8 * n
    T = 3 * chunk + 5
    rng = np.random.default_rng(seed)
    base = "AUDIT_1"
    np.save(os.path.join(cache_dir, f"coor_{base}_rois_size{TILE_PX}"
                                    "_hsvcut_v3.npy"),
            np.stack([[j * TILE_PX, 0] for j in range(T)]))
    np.save(os.path.join(cache_dir, f"data_{base}_rois_size{TILE_PX}"
                                    "_hsvcut_v3.npy"),
            rng.integers(0, 256, (T, TILE_PX, TILE_PX, 3), dtype=np.uint8))
    return {"cache": cache_dir, "path": os.path.join(cache_dir,
                                                     base + ".npy"),
            "tiles": T, "chunk": chunk}


def jax_rows(path=SCALING_MEASURED) -> dict:
    """The JAX tool's committed rows, by workload."""
    with open(path) as f:
        return {r["workload"]: r for r in json.load(f)["workloads"]}


def run_audit(n: int = 4, *, full_width: bool = True, devices=None) -> list:
    """Every family on ``n`` spawned ranks (``devices``: gloo CPU ranks by
    default; one card a rank runs over NCCL, several ranks on one card
    over gloo), in one launch. Returns rank 0's rows, each with the JAX
    tool's row of the same workload beside it."""
    devices = [str(d) for d in (devices or ["cpu"] * n)]
    with tempfile.TemporaryDirectory(prefix="comm_audit_") as tmp:
        spec = {"full_width": full_width, "devices": devices,
                "slide": write_slide(tmp, n)}
        rows = M.launch(_audit_rank, n, args=(spec,), devices=devices)[0]
    jax = jax_rows()
    for row in rows:
        row["jax"] = jax.get(row["workload"])
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--devices", type=int, default=4,
                    help="ranks of the mesh")
    ap.add_argument("--device", default="cpu", choices=("cpu", "cuda"),
                    help="gloo CPU ranks, or one card a rank over NCCL")
    ap.add_argument("--one-card", action="store_true",
                    help="with --device cuda: every rank on cuda:0, over "
                         "gloo (chip_smoke.py's comm_audit phase)")
    ap.add_argument("--test-width", action="store_true",
                    help="the JAX test's widths (8, 8, 8, 8) and a 1/32 "
                         "StyleGAN")
    ap.add_argument("--out", default=None,
                    help="also write the rows to this JSON file")
    args = ap.parse_args(argv)
    devices = (["cuda:0"] * args.devices if args.one_card
               else M.mesh_devices(args.devices, args.device))
    rows = run_audit(args.devices, full_width=not args.test_width,
                     devices=devices)
    bad = pins_mismatch(rows, expected_rows(args.devices,
                                            full_width=not args.test_width))
    artifact = {"devices": [str(d) for d in devices],
                "platform": f"{args.device} ({M.backend_for(devices)}"
                            " ranks; counts and payloads are properties of "
                            "the program)",
                "tool": "tools/torch_comm_audit.py", "workloads": rows,
                "pins_mismatches": bad}
    text = json.dumps(artifact, indent=1)
    print(text)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
