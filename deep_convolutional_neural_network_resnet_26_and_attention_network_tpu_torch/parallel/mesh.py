"""The (slides, tiles) mesh of ranks for bag-of-tiles workloads.

Counterpart of ``parallel/mesh.py`` in the JAX package. There the mesh is a
``jax.sharding.Mesh`` of devices and GSPMD inserts the collectives; here it
is ``torch.distributed`` process groups, one rank per card, and the code
that reduces over the tile axis calls each collective itself
(``ops/collectives.py``):

  * axis "slides": data parallelism over the bags of an accumulation
    window (each slide rank runs its own bags; the parameter gradients are
    summed over every rank before the optimizer step);
  * axis "tiles": the tiles of one bag split across ranks; the per-bag
    batch-norm statistics, the attention's L1 denominator and the pooled
    product become all-reduces over the rank's tile group.

MIL attention pooling is a linear reduction over tiles, so the split is
exact up to the order of the sums.

Ranks are processes. :func:`launch` spawns ``n`` of them and runs a
function in each on its :class:`Mesh`; the CLIs' ``--mesh N`` go through
it, one rank per card (``cuda:0 .. cuda:N-1``) over NCCL. Ranks on the
CPU, or several ranks on one card (``devices=``), talk over gloo. Rank 0
owns every print and every file write: the other ranks' standard output
goes to ``os.devnull``.

:func:`data_mesh` is the GAN trainer's 1-axis mesh (the JAX package's
``data_mesh``, the reference's 4-GPU ``nn.DataParallel``): every rank of
the world holds the whole parameter set and a contiguous share of each
batch (:func:`data_batch_sharding`, :func:`style_batch_sharding`); the
critic's minibatch stddev is an all-reduce over it and the parameter
gradients are summed over it before each optimizer step
(``train/gan.py``).
"""

import dataclasses
import datetime
import math
import os
import shutil
import signal
import sys
import tempfile

import torch
import torch.distributed as dist
import torch.multiprocessing as tmp

SLIDES_AXIS = "slides"
TILES_AXIS = "tiles"
# a rank that waits this long in a collective raises instead of hanging
DEFAULT_TIMEOUT_S = 1800.0


def slide_axis(n: int, slides: int | None = None) -> int:
    """The JAX package's axis rule: the largest power-of-two slide axis no
    larger than sqrt(n) that divides n, so the tile axis gets at least half
    of the ranks; or ``slides`` when given (it must divide n)."""
    if slides is None:
        slides = 1
        while (slides * 2 <= math.isqrt(n)
               and n % (slides * 2) == 0):
            slides *= 2
    if slides < 1 or n % slides:
        raise ValueError(f"a slide axis of {slides} does not divide {n} "
                         "ranks")
    return slides


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in the mesh: ``shape`` ``{"slides": s, "tiles":
    t}``, its ``rank`` (``slide * t + tile``, the row-major order of JAX's
    device grid), its coordinates, its device, the backend, and the
    process groups of its tile axis (the ranks that share its bags) and of
    its slide axis (the ranks that hold the same tile share of other
    bags)."""
    shape: dict
    rank: int
    slide: int
    tile: int
    device: torch.device
    backend: str
    tiles_group: object
    slides_group: object

    @property
    def size(self) -> int:
        return self.shape[SLIDES_AXIS] * self.shape[TILES_AXIS]

    @property
    def world_group(self):
        return dist.group.WORLD

    def bags(self, n: int) -> range:
        """This rank's bags among ``n``: a contiguous run, the first
        ``n % slides`` slide ranks taking one more."""
        s = self.shape[SLIDES_AXIS]
        base, extra = divmod(n, s)
        start = self.slide * base + min(self.slide, extra)
        return range(start, start + base + (self.slide < extra))

    def rows(self, n: int) -> slice:
        """This rank's contiguous share of a bag of ``n`` rows, which must
        be a multiple of the tile axis."""
        t = self.shape[TILES_AXIS]
        if n % t:
            raise ValueError(f"{n} tiles do not split over a tile axis of "
                             f"{t}; pad the bag with zero-mask tiles")
        share = n // t
        return slice(self.tile * share, (self.tile + 1) * share)


def mesh_devices(n: int, device=None) -> list:
    """The devices of an ``n``-rank mesh for the CLIs: ``n`` CPU ranks for
    ``device="cpu"``, else one card each, ``cuda:0 .. cuda:n-1``; asking
    for more cards than there are raises."""
    if n < 1:
        raise ValueError(f"a mesh needs at least one rank, got {n}")
    if device is not None and torch.device(device).type == "cpu":
        return [torch.device("cpu")] * n
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n > count:
        raise ValueError(f"--mesh {n} but only {count} CUDA devices are "
                         "available")
    return [torch.device("cuda", i) for i in range(n)]


def backend_for(devices) -> str:
    """NCCL when every rank has a card of its own, gloo otherwise (CPU
    ranks, or several ranks on one card)."""
    devices = [torch.device(d) for d in devices]
    if (all(d.type == "cuda" for d in devices)
            and len({d.index for d in devices}) == len(devices)):
        return "nccl"
    return "gloo"


def init(world: int, rank: int, *, backend: str, init_method: str,
         timeout_s: float = DEFAULT_TIMEOUT_S):
    """Join the default process group as ``rank`` of ``world``, with an
    explicit timeout so that a rank that dies makes the others raise."""
    dist.init_process_group(
        backend=backend, init_method=init_method, world_size=world,
        rank=rank, timeout=datetime.timedelta(seconds=timeout_s))


def make_mesh(n: int | None = None, *, slides: int | None = None,
              devices=None) -> Mesh:
    """This rank's :class:`Mesh` over the initialised default group of
    ``n`` ranks (the whole world; ``n`` defaults to it). The slide axis
    follows :func:`slide_axis`. ``devices`` lists each rank's device (two
    ranks may share a card, over gloo); by default rank r takes ``cuda:r``
    where there are cards, and raises when there are fewer than ``n``.
    Every rank must call this, in the same order as the other ranks' calls
    (it creates the axis groups)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs the process group: call "
                           "parallel.mesh.init (or use launch) first")
    world, rank = dist.get_world_size(), dist.get_rank()
    n = world if n is None else n
    if n != world:
        raise ValueError(f"a {n}-rank mesh needs a world of {n} ranks, "
                         f"not {world}")
    if devices is None:
        devices = (mesh_devices(n) if dist.get_backend() == "nccl"
                   else [torch.device("cpu")] * n)
    devices = [torch.device(d) for d in devices]
    if len(devices) != n:
        raise ValueError(f"{len(devices)} devices for {n} ranks")
    s = slide_axis(n, slides)
    t = n // s
    tiles_group = slides_group = None
    for i in range(s):  # every rank creates every group, in one order
        g = dist.new_group(list(range(i * t, (i + 1) * t)))
        if rank // t == i:
            tiles_group = g
    for j in range(t):
        g = dist.new_group(list(range(j, n, t)))
        if rank % t == j:
            slides_group = g
    return Mesh(shape={SLIDES_AXIS: s, TILES_AXIS: t}, rank=rank,
                slide=rank // t, tile=rank % t, device=devices[rank],
                backend=dist.get_backend(), tiles_group=tiles_group,
                slides_group=slides_group)


def _to(tree, device):
    """``tree`` (nested dicts, lists and tuples) with every tensor moved to
    ``device``."""
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to(v, device) for v in tree)
    return tree


def broadcast_object(obj, mesh: Mesh):
    """Rank 0's ``obj`` (any picklable tree, tensors included) on every
    rank, its tensors on the rank's device; the other ranks' ``obj`` is
    ignored."""
    box = [_to(obj, "cpu") if mesh.rank == 0 else None]
    dist.broadcast_object_list(box, src=0, group=mesh.world_group)
    return _to(box[0], mesh.device)


def run_together(step, mesh: Mesh, *, what: str, agree_on=None):
    """``step()`` on this rank, its failure every rank's: when ``step``
    raises on any rank, or the ranks' ``agree_on(result)`` (an integer,
    such as a slide's tile count) differ, every rank raises (this rank's
    own error, else a RuntimeError naming ``what``). Wrap a step that runs
    no collective, ahead of the first collective after it, so that no rank
    waits in a collective that another rank has left."""
    err, out, v = None, None, 0
    try:
        out = step()
        v = 0 if agree_on is None else int(agree_on(out))
    except Exception as e:  # raised on every rank just below
        err = e
    flags = torch.tensor([0.0 if err is None else 1.0, v, -v],
                         dtype=torch.float64, device=mesh.device)
    dist.all_reduce(flags, op=dist.ReduceOp.MAX, group=mesh.world_group)
    failed, hi, lo = flags.tolist()
    if err is not None:
        raise err
    if failed:
        raise RuntimeError(f"another rank of the mesh failed in {what}")
    if hi != -lo:
        raise RuntimeError(f"the ranks of the mesh disagree in {what}: "
                           f"{-lo:.0f} against {hi:.0f}")
    return out


def _rank_main(rank, fn, n, slides, backend, devices, init_method, args,
               results, timeout_s):
    """One spawned rank: join the group, build the mesh, run ``fn(mesh,
    *args)`` and send its return value back."""
    if rank > 0:
        # rank 0 owns the prints, and a stop request: the others follow it
        sys.stdout = open(os.devnull, "w")
        signal.signal(signal.SIGTERM, signal.SIG_IGN)
    device = torch.device(devices[rank])
    if device.type == "cuda":
        torch.cuda.set_device(device)
    else:  # CPU ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // n))
    init(n, rank, backend=backend, init_method=init_method,
         timeout_s=timeout_s)
    try:
        mesh = make_mesh(n, slides=slides, devices=devices)
        results.put((rank, fn(mesh, *args)))
    finally:
        dist.destroy_process_group()


def launch(fn, n: int, *, args=(), slides: int | None = None,
           backend: str | None = None, devices=None,
           init_method: str | None = None,
           timeout_s: float = DEFAULT_TIMEOUT_S):
    """Run ``fn(mesh, *args)`` on ``n`` spawned ranks and return their
    return values, in rank order (each must pickle; keep them small).

    ``devices`` lists each rank's device (by default one card each,
    :func:`mesh_devices`); ``backend`` defaults to :func:`backend_for`.
    The ranks meet through ``init_method``, by default a file store in a
    fresh temporary directory. A rank that raises stops the others and the
    error re-raises here; a rank that waits ``timeout_s`` in a collective
    raises. A SIGTERM to this process goes to rank 0, which
    decides when the ranks stop."""
    devices = [str(d) for d in (mesh_devices(n) if devices is None
                                else devices)]
    if len(devices) != n:
        raise ValueError(f"{len(devices)} devices for {n} ranks")
    backend = backend or backend_for(devices)
    store_dir = None
    if init_method is None:
        store_dir = tempfile.mkdtemp(prefix="mesh_")
        init_method = "file://" + os.path.join(store_dir, "store")
    results = tmp.get_context("spawn").SimpleQueue()
    ctx = tmp.start_processes(
        _rank_main, args=(fn, n, slides, backend, devices, init_method,
                          args, results, timeout_s),
        nprocs=n, join=False, start_method="spawn")
    out = {}

    def drain():
        while not results.empty():
            rank, value = results.get()
            out[rank] = value

    def forward_stop(signum, frame):
        os.kill(ctx.processes[0].pid, signal.SIGTERM)

    try:
        prev = signal.signal(signal.SIGTERM, forward_stop)
    except ValueError:  # not the main thread
        prev = None
    try:
        while not ctx.join(timeout=0.2):
            drain()
        drain()
    finally:
        if prev is not None:
            signal.signal(signal.SIGTERM, prev)
        if store_dir is not None:
            shutil.rmtree(store_dir, ignore_errors=True)
    return [out.get(r) for r in range(n)]


DATA_AXIS = "data"


@dataclasses.dataclass(frozen=True)
class DataMesh:
    """A 1-axis data mesh: this rank's ``rank`` among ``size`` ranks, its
    device, and the group the batch splits over."""
    size: int
    rank: int
    device: torch.device
    group: object

    @property
    def world_group(self):
        return self.group

    def rows(self, n: int) -> slice:
        """This rank's contiguous share of a batch of ``n``, which must
        divide over the mesh."""
        if n % self.size:
            raise ValueError(f"a batch of {n} does not split over a data "
                             f"mesh of {self.size}")
        share = n // self.size
        return slice(self.rank * share, (self.rank + 1) * share)


def data_mesh(n_devices: int | None = None, *, device=None) -> DataMesh:
    """The data mesh over the initialised default group (the whole world;
    ``n_devices`` defaults to it and must equal it). ``device`` is this
    rank's, ``cuda:<rank>`` by default under NCCL and the CPU under gloo."""
    if not dist.is_initialized():
        raise RuntimeError("data_mesh needs the process group: call "
                           "parallel.mesh.init (or use launch) first")
    world, rank = dist.get_world_size(), dist.get_rank()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"a {n_devices}-rank data mesh needs a world of "
                         f"{n_devices} ranks, not {world}")
    if device is None:
        device = (torch.device("cuda", rank) if dist.get_backend() == "nccl"
                  else torch.device("cpu"))
    return DataMesh(size=world, rank=rank, device=torch.device(device),
                    group=dist.group.WORLD)


def data_batch_sharding(mesh: DataMesh):
    """``[B, ...]`` -> this rank's rows (the batch axis is the first)."""
    return lambda x: x[mesh.rows(x.shape[0])]


def style_batch_sharding(mesh: DataMesh):
    """``[n_styles, B, code]`` latent stacks -> this rank's rows of the
    batch, their axis 1."""
    return lambda zs: zs[:, mesh.rows(zs.shape[1])]
