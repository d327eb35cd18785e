"""AOT serving bundles: serve a slide from exported programs, not model code.

Counterpart of ``deploy.py`` in the JAX package, in PyTorch's idiom.
``export_serving_bundle`` traces the two streaming-inference programs with
``torch.export`` and saves them (``torch.export.save``) beside the weights
(the ``.model`` npz that both packages read) and a JSON manifest:

  * ``extract.pt2``: uint8 tiles ``[N, roi, roi, 3]`` -> float32 features
    ``[N, L]``, the streaming path's per-chunk program
    (``parallel.inference.make_transform_extract``), N from 1 to ``chunk``:
    on the card at a roi and resolution of 300 in bf16 the ResNet-26's
    uint8 entry, whose fused stem is the ``torch.library`` op
    ``POOL_OP`` of ``ops/u8_stem.py`` (the stem with its LeakyReLU and
    max-pool; bundles exported before it hold ``OP``, which still loads);
    elsewhere the eval transform then the ResNet-26;
  * ``pool.pt2``: features ``[T, L]`` -> the head's outputs
    (``models.attention_mil.attention_pool``), T from 1 to ``tiles``. The
    gated pool in it is the ``torch.library`` op of ``ops/gated_pool.py``,
    so on the card it runs the hand-written kernel.

Both programs take their weights as an argument (a state dict under
AttentionMIL's names, the ``cnn.`` ones for the extractor and the rest for
the pool), so the ``.pt2`` files hold no weights and ``swap_weights`` points
a bundle at re-trained weights of the same shapes without a new export.
``DeployedClassifier`` classifies from the bundle directory alone, with no
model-building code on its path: it runs the extractor over staged chunks
at each chunk's exact size, pools once at the exact tile count and takes
the softmax on the host. The JAX package exports a ladder of fixed shapes;
here one program with a dynamic tile dimension serves every size.

Two deliberate differences from the JAX package. A bundle serves on the
device it was exported on only: an exported program holds its device's
constants (the ``torch.ones`` and ``torch.eye`` of ``attention_pool``), so
``--platforms`` names that device or the export refuses. Its
``bundle_version`` is the string ``"torch-1"``, which the JAX loader refuses
by its version check, as this loader refuses the JAX package's bundles. The
f32 extractor's numbers depend on the serving process's TF32 setting
(``torch.backends.cudnn.allow_tf32``), which no program records.

CLI::

    python -m <package>.deploy export --ckpt run/train_step-340.model \\
        --out bundle/ [--tiles 4096] [--f32]
    python -m <package>.deploy run --bundle bundle/ --slide GHP_x.npy
"""

import argparse
import dataclasses
import json
import os
import sys

import numpy as np
import torch

from ._device import resolve_device
from .data.loader import staged_chunks
# registers the ops the programs hold: the pool's, and the uint8 stem's
from .ops import gated_pool, u8_stem  # noqa: F401
from .train import checkpoint
from .utils import interop

MANIFEST = "manifest.json"
WEIGHTS = "weights.model"
BUNDLE_VERSION = "torch-1"
PROGRAMS = {"extract": "extract.pt2", "pool": "pool.pt2"}
# the AttentionMIL submodules whose weights each program takes
PROGRAM_MODULES = {"extract": ("cnn",),
                   "pool": ("context", "attention", "buffer", "weight_mask")}


class _Slice(torch.nn.Module):
    """The submodules ``names`` of an AttentionMIL, shared, with
    ``fn(self, x)`` as the forward: its state-dict keys are the model's."""

    def __init__(self, model, names, fn):
        super().__init__()
        for name in names:
            setattr(self, name, getattr(model, name))
        self._fn = fn

    def forward(self, x):
        return self._fn(self, x)


class _Program(torch.nn.Module):
    """``forward(weights, x)``: ``body`` with ``weights`` in place of its
    parameters. The body is kept out of the module tree, so that the
    exported program lifts none of its parameters and carries no weights."""

    def __init__(self, body):
        super().__init__()
        self._body = (body,)

    def forward(self, weights, x):
        return torch.func.functional_call(self._body[0], weights, (x,))


def _canonical_backend(device) -> str:
    """The platform name of ``device``: ``cpu``, or ``cuda`` / ``rocm``
    for a GPU, whose two stacks are not interchangeable."""
    if device.type != "cuda":
        return device.type
    return "rocm" if torch.version.hip else "cuda"


def export_serving_bundle(model, cfg, out_dir: str, *, resolution: int = 300,
                          roi_size: int = 1200, chunk: int = 1024,
                          tiles: int = 4096, compute_dtype=torch.bfloat16
                          ) -> dict:
    """Export the streaming serving programs of ``model`` (an
    ``AttentionMIL`` with config ``cfg``) for its device, with its weights
    and the manifest, into ``out_dir``. ``chunk`` bounds the extractor's
    tiles a call, ``tiles`` a slide's. Returns the manifest."""
    from torch.export import Dim

    from ._device import module_device
    from .models import attention_mil as amil
    from .parallel import inference

    if chunk < 2 or tiles < 2:
        # torch.export fixes a dimension whose bound is 1
        raise ValueError(f"need chunk >= 2 and tiles >= 2, got {chunk}, "
                         f"{tiles}")
    gated_pool._limits(tiles, cfg.K, cfg.O)
    device = module_device(model)
    extract = inference.make_transform_extract(
        cfg, resolution=resolution, compute_dtype=compute_dtype)
    bodies = {
        "extract": (_Slice(model, PROGRAM_MODULES["extract"],
                           lambda m, x: extract(m.cnn, x)),
                    torch.zeros((2, roi_size, roi_size, 3), dtype=torch.uint8,
                                device=device),
                    Dim("N", min=1, max=chunk)),
        "pool": (_Slice(model, PROGRAM_MODULES["pool"],
                        lambda m, h: amil.attention_pool(m, h, cfg)),
                 torch.zeros((2, cfg.L), device=device),
                 Dim("T", min=1, max=tiles))}

    os.makedirs(out_dir, exist_ok=True)
    for kind, (body, example, dim) in bodies.items():
        weights = {k: v.detach()
                   for k, v in sorted(body.state_dict().items())}
        with torch.no_grad():
            prog = torch.export.export(
                _Program(body), (weights, example),
                dynamic_shapes=({k: None for k in weights}, {0: dim}))
        # the saved program would keep its example inputs: the weights
        prog.example_inputs = None
        torch.export.save(prog, os.path.join(out_dir, PROGRAMS[kind]))
    checkpoint.save(os.path.join(out_dir, WEIGHTS), model)
    manifest = {
        "bundle_version": BUNDLE_VERSION,
        "torch_version": torch.__version__,
        "platforms": [_canonical_backend(device)],
        "resolution": resolution, "roi_size": roi_size,
        "compute_dtype": str(compute_dtype or torch.float32).removeprefix(
            "torch."),
        "chunk": chunk, "max_tiles": tiles,
        "feature_dim": cfg.L, "n_classes": cfg.n_classes,
        "config": dataclasses.asdict(cfg),
        "programs": dict(PROGRAMS),
    }
    with open(os.path.join(out_dir, MANIFEST), "w") as f:
        json.dump(manifest, f, indent=1)
    return manifest


def _unflatten(flat: dict):
    """'/'-joined keys -> the nested parameter tree (the inverse of
    ``checkpoint._flatten``): dicts for named nodes, lists for all-digit
    key groups (the ResNet's ``stages``)."""
    tree = {}
    for key in sorted(flat):
        parts = key.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = flat[key]

    def listify(node):
        if not isinstance(node, dict):
            return node
        node = {k: listify(v) for k, v in node.items()}
        if node and all(k.isdigit() for k in node):
            return [node[k] for k in sorted(node, key=int)]
        return node

    return listify(tree)


def _check_manifest(manifest, device):
    """Refuse a bundle this loader cannot serve on ``device``: one of the
    JAX package, another version, or one exported for another platform."""
    version = manifest.get("bundle_version")
    programs = manifest.get("programs", {}).values()
    if isinstance(version, int) or any(str(p).endswith(".shlo")
                                       for p in programs):
        raise ValueError(
            f"this is a JAX-package bundle (bundle_version {version!r}, "
            "StableHLO programs): serve it with the JAX package's "
            "deploy.DeployedClassifier, or export a bundle for this package "
            "with its own deploy export")
    if version != BUNDLE_VERSION:
        raise ValueError(f"bundle version {version} != supported "
                         f"{BUNDLE_VERSION}")
    # fail at load time, not per slide in the daemon's retry loop. A
    # legacy 'gpu' entry matches either GPU stack (which one wrote it is
    # unknown); in the message it reads as this host's stack on a GPU host
    # and as 'cuda' elsewhere, so that only canonical names are printed
    canon = _canonical_backend(device)
    on_gpu = canon in ("cuda", "rocm")
    plats = manifest.get("platforms") or []
    if plats and not (({canon} | ({"gpu"} if on_gpu else set()))
                      & set(plats)):
        legacy_gpu = canon if on_gpu else "cuda"
        named = sorted({legacy_gpu if p == "gpu" else p for p in plats})
        raise ValueError(
            f"bundle was exported for platforms {named} but this host's "
            f"device is {canon!r}; a bundle serves on its export platform "
            f"only: re-export it here with --platforms {canon}")


class DeployedClassifier:
    """Streaming slide classification from a bundle directory alone, on
    ``device`` (the card unless ``"cpu"`` is asked for).

    Follows ``parallel.inference.classify_slide_streaming``: chunks staged
    to the device, the extractor program at each chunk's exact size, the
    pool program once at the slide's exact tile count, the softmax on the
    host; the same output keys. Slides above ``max_tiles`` raise: export
    with a larger ``--tiles``."""

    def __init__(self, bundle_dir: str, *, device=None):
        self.device = resolve_device(device)
        with open(os.path.join(bundle_dir, MANIFEST)) as f:
            self.manifest = json.load(f)
        _check_manifest(self.manifest, self.device)
        blob = checkpoint.load_raw(os.path.join(bundle_dir, WEIGHTS))
        state = interop.state_dict_from_jax(_unflatten(
            {k[len("classifier/"):]: v for k, v in blob.items()
             if k.startswith("classifier/")}))
        self.weights = {k: v.to(self.device) for k, v in state.items()}
        self._programs = {
            kind: torch.export.load(os.path.join(bundle_dir, name)).module()
            for kind, name in self.manifest["programs"].items()}

    def _weights_of(self, kind):
        """The weights of program ``kind``, in the sorted key order it
        was exported with: a program matches a dict's entries by
        position."""
        return {k: self.weights[k] for k in sorted(self.weights)
                if k.split(".", 1)[0] in PROGRAM_MODULES[kind]}

    @torch.no_grad()
    def extract(self, raw_u8):
        """The extractor program: uint8 ``[N, roi, roi, 3]`` on the device,
        1 <= N <= ``chunk`` -> float32 features ``[N, L]``."""
        return self._programs["extract"](self._weights_of("extract"), raw_u8)

    @torch.no_grad()
    def pool(self, feats):
        """The pool program: float32 ``[T, L]`` on the device, 1 <= T <=
        ``max_tiles`` -> ``attention_pool``'s dict of device tensors."""
        return self._programs["pool"](self._weights_of("pool"), feats)

    def classify(self, raw_tiles: np.ndarray):
        """uint8 ``[T, roi, roi, 3]`` (an array or a memory map) -> (probs
        [n_classes], outputs dict of host arrays)."""
        m = self.manifest
        T = int(raw_tiles.shape[0])
        if T == 0:
            raise ValueError("deploy bundles serve tiled slides only; a "
                             "tile-less slide has no exported program (the "
                             "library's zero-bag fallback needs the "
                             "one-pass forward)")
        if T > m["max_tiles"]:
            raise ValueError(f"slide has {T} tiles > bundle max_tiles "
                             f"{m['max_tiles']}; re-export with a larger "
                             "--tiles")
        roi = m["roi_size"]
        if tuple(raw_tiles.shape[1:]) != (roi, roi, 3):
            raise ValueError(f"tiles of shape {tuple(raw_tiles.shape[1:])}; "
                             f"the bundle takes ({roi}, {roi}, 3)")
        H = torch.empty((T, m["feature_dim"]), dtype=torch.float32,
                        device=self.device)
        for start, part in staged_chunks(raw_tiles, m["chunk"], self.device):
            H[start:start + part.shape[0]] = self.extract(part)
        pooled = {k: v.cpu().numpy() for k, v in self.pool(H).items()}
        z = pooled["logits"].astype(np.float32)
        z = np.exp(z - z.max(axis=1, keepdims=True))
        probs = z / z.sum(axis=1, keepdims=True)
        outs = {**pooled, "y_pred": probs, "y_pred_hat": np.argmax(probs),
                "Fterm": H.cpu().numpy()}
        return probs.ravel(), outs

    def classify_builder(self, builder, *, mmap: bool = True):
        """RoiBuilder -> (probs, outs, coords). The resolution is the
        bundle's: the transform is inside the extractor program."""
        raw, coords = builder._load_cache(with_coords=True, mmap=mmap)
        probs, outs = self.classify(raw)
        return probs, outs, coords

    def swap_weights(self, state):
        """Point the bundle at re-trained weights: ``state`` maps
        AttentionMIL's state-dict names to tensors of the bundle's shapes
        and dtypes (the programs take weights as an argument, so nothing is
        exported again). A dtype is part of a program's signature, so a
        mismatch raises here and not inside the program."""
        if set(state) != set(self.weights):
            raise ValueError(
                "swap_weights: the names "
                f"{sorted(set(state) ^ set(self.weights))[:4]} do not match "
                "bundle's")
        for k, have in self.weights.items():
            new = state[k]
            if tuple(new.shape) != tuple(have.shape) or new.dtype != have.dtype:
                raise ValueError(
                    f"swap_weights: {k} {tuple(new.shape)}/{new.dtype} does "
                    f"not match bundle {tuple(have.shape)}/{have.dtype}")
        self.weights = {k: v.detach().to(self.device)
                        for k, v in state.items()}


def build_argparser():
    p = argparse.ArgumentParser(description="AOT serving bundles")
    sub = p.add_subparsers(dest="cmd", required=True)
    pe = sub.add_parser("export")
    pe.add_argument("--ckpt", default=None,
                    help=".model checkpoint (random init with a warning if "
                         "unset: smoke tests only)")
    pe.add_argument("--out", required=True)
    pe.add_argument("--arch", default="full", choices=["full", "tiny"])
    pe.add_argument("--resolution", default=300, type=int)
    pe.add_argument("--roi_size", default=1200, type=int)
    pe.add_argument("--chunk", default=1024, type=int,
                    help="the extractor program's most tiles a call")
    pe.add_argument("--tiles", default=4096, type=int,
                    help="the pool program's most tiles: a slide's bound")
    pe.add_argument("--platforms", default=None,
                    help="comma-separated platforms; only the export "
                         "device's (cpu, cuda or rocm) is accepted: a "
                         "program holds its device's constants")
    pe.add_argument("--f32", action="store_true",
                    help="trace the extractor in float32 instead of bf16")
    pe.add_argument("--seed", default=0, type=int)
    pr = sub.add_parser("run")
    pr.add_argument("--bundle", required=True)
    pr.add_argument("--slide", required=True)
    return p


def main(argv=None, *, device=None) -> int:
    """The ``export`` / ``run`` CLI on ``device`` (the card unless
    ``"cpu"`` is asked for)."""
    args = build_argparser().parse_args(argv)
    device = resolve_device(device)

    if args.cmd == "export":
        from .models import attention_mil as amil
        from .train.classify import make_config

        here = _canonical_backend(device)
        asked = ([s.strip() for s in args.platforms.split(",") if s.strip()]
                 if args.platforms else [here])
        if asked != [here]:
            raise SystemExit(
                f"deploy: --platforms {args.platforms}: a bundle serves on "
                f"its export device only, here {here!r}; export on each "
                "platform's host instead")
        cfg = make_config(args)
        model = amil.init_attention_mil(
            torch.Generator().manual_seed(args.seed), cfg, device=device)
        if args.ckpt:
            _, loaded, skipped = checkpoint.restore_params(model, args.ckpt)
            print(f"deploy: loaded {len(loaded)} tensors "
                  f"({len(skipped)} skipped) from {args.ckpt}")
        else:
            print("deploy: WARNING: no --ckpt, exporting random weights "
                  "(smoke-test mode)")
        manifest = export_serving_bundle(
            model, cfg, args.out, resolution=args.resolution,
            roi_size=args.roi_size, chunk=args.chunk, tiles=args.tiles,
            compute_dtype=torch.float32 if args.f32 else torch.bfloat16)
        print(f"deploy: exported {len(manifest['programs'])} programs "
              f"(extract N <= {args.chunk}, pool T <= {args.tiles}, "
              f"{manifest['compute_dtype']}, {here}) -> {args.out}")
        return 0

    from .data.roibuilder import RoiBuilder

    clf = DeployedClassifier(args.bundle, device=device)
    builder = RoiBuilder(args.slide, {"roi_size": clf.manifest["roi_size"]},
                         device=device)
    if "MISSING" in builder.params["status"] and not builder.build():
        print(f"deploy: cache build failed for {args.slide}", file=sys.stderr)
        return 1
    builder.update_resolution_and_buffer(clf.manifest["resolution"])
    try:
        probs, outs, _ = clf.classify_builder(builder)
    except ValueError as e:  # a tile-less slide, or above max_tiles
        print(f"deploy: {e}", file=sys.stderr)
        return 1
    print(json.dumps({"name": builder.getname(),
                      "probs": [round(float(x), 6) for x in probs],
                      "pred": int(outs["y_pred_hat"]),
                      "ntiles": builder.getsize()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
