"""Checkpoint interchange with the reference PyTorch stack (the classifier).

Counterpart of the classifier half of ``utils/torch_interop.py`` in the JAX
package. A reference user arrives with checkpoints written by
``gbm/classify_combined.py:468-474``: torch pickles of ``{'classifier':
state_dict, 'optimizer': state_dict}`` named
``train_step-<epoch:03d>[_FINAL].model``. ``import_checkpoint`` turns one
into the npz ``.model`` that both packages read (``train/checkpoint.py``),
key for key and bit for bit what the JAX package writes from the same
file, so ``--ckpt``, ``--transfer`` and ``deploy export --ckpt`` take
reference-trained weights. ``export_checkpoint`` goes the other way: a
``.model`` becomes a pickle the reference ``Attention`` model loads
(reference: gbm/classify_combined.py:521-535), with the ResNet's keys under
DataParallel's ``cnn.module.``; ``export_state_dict`` does the same for an
``AttentionMIL`` in memory.

Key names (reference: gbm/model.py:114-157, 14-48; nnBlocks.py:157-185):
``cnn.module.conv1.*``, ``cnn.module.layer{1..4}.{b}.conv{1,2}.*``,
``...{b}.downsample.0.weight``, ``cnn.module.fc.weight``,
``context.bn.*`` (no running statistics), ``attention.lin{1,2}.*``,
``buffer.lin1.*``, ``buffer.classifier.*`` and ``weight_mask``; a leading
``module.`` from a whole-model DataParallel is tolerated. Layouts: torch
convs ``[O, I, kh, kw]`` against the ``.model``'s HWIO, torch linears
``[O, I]`` against ``[I, O]``. The optimizer state is not imported (torch
Adam keys its slots by position), so an import restarts with a fresh
optimizer, as the reference's ``--transfer`` does. The rules are this
package's own copy; nothing is imported from the JAX package. The
StyleGAN half waits for the GAN family (ROADMAP A.12).

CLI::

    python -m <package>.utils.torch_interop import ref.model out.model
    python -m <package>.utils.torch_interop export ours.model out_ref.model
"""

import argparse
import re
import sys

import numpy as np
import torch

from ..train import checkpoint
from . import interop

_CONV = "conv"   # [O,I,kh,kw] <-> [kh,kw,I,O]
_LIN = "lin"     # [O,I] <-> [I,O]
_VEC = "vec"     # as it is

# reference-key patterns -> ('/'-joined .model key template, layout). The
# stage, block and downsample structure comes from the keys themselves, so
# any widths and block counts go through without a schema
_IMPORT_RULES = [
    (re.compile(r"^cnn\.conv1\.weight$"), "cnn/conv1/w", _CONV),
    (re.compile(r"^cnn\.conv1\.bias$"), "cnn/conv1/b", _VEC),
    (re.compile(r"^cnn\.layer(\d+)\.(\d+)\.conv([12])\.weight$"),
     "cnn/stages/{s}/{b}/conv{c}/w", _CONV),
    (re.compile(r"^cnn\.layer(\d+)\.(\d+)\.conv([12])\.bias$"),
     "cnn/stages/{s}/{b}/conv{c}/b", _VEC),
    (re.compile(r"^cnn\.layer(\d+)\.(\d+)\.downsample\.0\.weight$"),
     "cnn/stages/{s}/{b}/downsample/w", _CONV),
    (re.compile(r"^cnn\.fc\.weight$"), "cnn/fc/w", _LIN),
    (re.compile(r"^context\.bn\.weight$"), "context/gamma", _VEC),
    (re.compile(r"^context\.bn\.bias$"), "context/beta", _VEC),
    (re.compile(r"^attention\.lin([12])\.weight$"), "attention/lin{c}/w",
     _LIN),
    (re.compile(r"^attention\.lin([12])\.bias$"), "attention/lin{c}/b",
     _VEC),
    (re.compile(r"^buffer\.lin1\.weight$"), "buffer/lin1/w", _LIN),
    (re.compile(r"^buffer\.lin1\.bias$"), "buffer/lin1/b", _VEC),
    (re.compile(r"^buffer\.classifier\.weight$"), "buffer/classifier/w",
     _LIN),
    (re.compile(r"^buffer\.classifier\.bias$"), "buffer/classifier/b",
     _VEC),
    (re.compile(r"^weight_mask$"), "weight_mask", _VEC),
]

# .model-key patterns -> reference-key template (the other way)
_EXPORT_RULES = [
    (re.compile(r"^cnn/conv1/w$"), "cnn.module.conv1.weight", _CONV),
    (re.compile(r"^cnn/conv1/b$"), "cnn.module.conv1.bias", _VEC),
    (re.compile(r"^cnn/stages/(\d+)/(\d+)/conv([12])/w$"),
     "cnn.module.layer{s}.{b}.conv{c}.weight", _CONV),
    (re.compile(r"^cnn/stages/(\d+)/(\d+)/conv([12])/b$"),
     "cnn.module.layer{s}.{b}.conv{c}.bias", _VEC),
    (re.compile(r"^cnn/stages/(\d+)/(\d+)/downsample/w$"),
     "cnn.module.layer{s}.{b}.downsample.0.weight", _CONV),
    (re.compile(r"^cnn/fc/w$"), "cnn.module.fc.weight", _LIN),
    (re.compile(r"^context/gamma$"), "context.bn.weight", _VEC),
    (re.compile(r"^context/beta$"), "context.bn.bias", _VEC),
    (re.compile(r"^attention/lin([12])/w$"), "attention.lin{c}.weight", _LIN),
    (re.compile(r"^attention/lin([12])/b$"), "attention.lin{c}.bias", _VEC),
    (re.compile(r"^buffer/lin1/w$"), "buffer.lin1.weight", _LIN),
    (re.compile(r"^buffer/lin1/b$"), "buffer.lin1.bias", _VEC),
    (re.compile(r"^buffer/classifier/w$"), "buffer.classifier.weight", _LIN),
    (re.compile(r"^buffer/classifier/b$"), "buffer.classifier.bias", _VEC),
    (re.compile(r"^weight_mask$"), "weight_mask", _VEC),
]


def _to_ours(arr, kind):
    arr = np.asarray(arr)
    if kind == _CONV:
        return np.transpose(arr, (2, 3, 1, 0))
    if kind == _LIN:
        return arr.T
    return arr


def _to_torch(arr, kind):
    arr = np.asarray(arr)
    if kind == _CONV:
        return np.transpose(arr, (3, 2, 0, 1))
    if kind == _LIN:
        return arr.T
    return arr


def _fill(template, groups, stage_offset):
    """The key ``template`` with a rule's matched ``groups``: stage and
    block for the ResNet's blocks (the stage shifted by
    ``stage_offset``), else the layer number."""
    if "{s}" in template:
        fields = {"s": int(groups[0]) + stage_offset, "b": int(groups[1])}
        if len(groups) > 2:
            fields["c"] = groups[2]
        return template.format(**fields)
    if "{c}" in template:
        return template.format(c=groups[0])
    return template


def import_state_dict(sd) -> tuple[dict, list, list]:
    """Reference state dict -> the flat ``classifier/...`` blob of a
    ``.model``. Returns (blob, imported reference keys, skipped reference
    keys); unknown keys (``loss.*`` buffers, ``num_batches_tracked``) are
    skipped, as the reference's own ``strict=False`` restore does."""
    blob, imported, skipped = {}, [], []
    for key, value in sd.items():
        norm = interop._reference_key(key)
        for rx, template, kind in _IMPORT_RULES:
            m = rx.match(norm)
            if m:
                ours = _fill(template, m.groups(), -1)
                blob[f"classifier/{ours}"] = _to_ours(
                    value.numpy() if hasattr(value, "numpy") else value,
                    kind)
                imported.append(key)
                break
        else:
            skipped.append(key)
    return blob, imported, skipped


def _export_flat(flat: dict) -> dict:
    """'/'-keyed attention-MIL leaves -> reference-keyed numpy arrays."""
    out = {}
    for okey, value in flat.items():
        for rx, template, kind in _EXPORT_RULES:
            m = rx.match(okey)
            if m:
                out[_fill(template, m.groups(), 1)] = _to_torch(value, kind)
                break
        else:
            raise KeyError(f"no reference mapping for parameter {okey!r}")
    return out


def export_state_dict(model) -> dict:
    """An ``AttentionMIL`` -> its reference-keyed state dict of numpy
    arrays."""
    return _export_flat(checkpoint._flatten(
        interop.jax_params_from_module(model)))


def import_checkpoint(src: str, dest: str, *,
                      unsafe_pickle: bool = False) -> tuple[list, list]:
    """Convert a reference torch checkpoint file into a ``.model`` npz.
    The pickle is read with ``weights_only`` unless ``unsafe_pickle``.
    Returns (imported keys, skipped keys)."""
    try:
        ckpt = torch.load(src, map_location="cpu",
                          weights_only=not unsafe_pickle)
    except Exception as e:  # torch raises pickle.UnpicklingError subclasses
        if unsafe_pickle:
            raise
        raise RuntimeError(
            f"weights_only load of {src!r} failed ({e}); if you trust this "
            "file, retry with --unsafe-pickle") from e
    sd = ckpt.get("classifier", ckpt) if isinstance(ckpt, dict) else ckpt
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    blob, imported, skipped = import_state_dict(sd)
    if not imported:
        raise ValueError(
            f"{src!r} contains no recognizable reference parameters "
            f"(saw keys like {list(sd)[:3]})")
    blob["extra/imported_from"] = np.asarray(src)
    blob["extra/format"] = np.asarray("torch-reference")
    checkpoint.save_blob(dest, blob)
    return imported, skipped


def export_checkpoint(src: str, dest: str) -> list:
    """Convert a ``.model`` npz into a torch pickle ``{'classifier':
    state_dict}`` that the reference loads. Returns the keys written."""
    blob = checkpoint.load_raw(src)
    flat = {k[len("classifier/"):]: v for k, v in blob.items()
            if k.startswith("classifier/")}
    out = {k: torch.from_numpy(np.ascontiguousarray(v))
           for k, v in _export_flat(flat).items()}
    torch.save({"classifier": out}, dest)
    return sorted(out)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="Convert checkpoints between the reference torch "
                    "format and the npz .model format.")
    sub = p.add_subparsers(dest="cmd", required=True)
    imp = sub.add_parser("import", help="reference torch .model -> .model npz")
    imp.add_argument("src")
    imp.add_argument("dest")
    imp.add_argument("--unsafe-pickle", action="store_true",
                     help="allow a full pickle load for pre-weights_only "
                          "checkpoints you trust")
    exp = sub.add_parser("export", help=".model npz -> reference torch")
    exp.add_argument("src")
    exp.add_argument("dest")
    for name in ("import-gan", "export-gan"):
        gan = sub.add_parser(name, help="not ported yet (ROADMAP A.12)")
        gan.add_argument("src")
        gan.add_argument("dest")
        gan.add_argument("--unsafe-pickle", action="store_true")
    args = p.parse_args(argv)

    if args.cmd in ("import-gan", "export-gan"):
        raise SystemExit(
            f"torch_interop: {args.cmd} is not ported to the PyTorch "
            "package yet; ROADMAP item A.12 (the GAN family) brings it")
    if args.cmd == "import":
        imported, skipped = import_checkpoint(
            args.src, args.dest, unsafe_pickle=args.unsafe_pickle)
        print(f"imported {len(imported)} tensors -> {args.dest}")
        if skipped:
            print(f"skipped {len(skipped)} non-parameter keys: "
                  f"{skipped[:6]}{'...' if len(skipped) > 6 else ''}")
        print("note: torch optimizer state is positional and is not "
              "imported; training resumes with a fresh optimizer "
              "(reference --transfer semantics)")
    else:
        keys = export_checkpoint(args.src, args.dest)
        print(f"exported {len(keys)} tensors -> {args.dest}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
