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
package's own copy; nothing is imported from the JAX package.

The StyleGAN half (the JAX module's ``import_gan_checkpoint`` /
``export_gan_checkpoint``): ``import_gan_checkpoint`` turns a reference
StyleGAN pickle (the trainer's ``{generator, discriminator, g_running,
...}``, or a bare ``g_running`` state dict, which then fills both the
``g_running/`` and ``generator/`` sections) into the 5-part npz that
``train/gan.py`` reads; ``export_gan_checkpoint`` writes a GAN npz as the
reference's ``generator`` / ``g_running`` / ``discriminator`` state
dicts, with ``weight_orig`` names, the from_rgb_activate keys and
regenerated blur buffers, which the port's ``models/stylegan.py`` modules
(and the reference's) load with ``strict=True``. The name rules are
``utils/interop.gan_key``. Optimizer state never crosses (torch keys it by
position).

CLI::

    python -m <package>.utils.torch_interop import ref.model out.model
    python -m <package>.utils.torch_interop export ours.model out_ref.model
    python -m <package>.utils.torch_interop import-gan ref.model out.model
    python -m <package>.utils.torch_interop export-gan ours.model out_ref.pt
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


# ---------------------------------------------------------------- StyleGAN
def _load_pickle(src, unsafe_pickle):
    try:
        return torch.load(src, map_location="cpu",
                          weights_only=not unsafe_pickle)
    except Exception as e:  # torch raises pickle.UnpicklingError subclasses
        if unsafe_pickle:
            raise
        raise RuntimeError(
            f"weights_only load of {src!r} failed ({e}); if you trust this "
            "file, retry with --unsafe-pickle") from e


def _convert_gan_sd(sd, part):
    out, imported, skipped = {}, [], []
    for key, value in sd.items():
        ours, kind = interop.gan_key(key, part)
        if kind == interop.SKIP:
            continue
        if kind == interop.UNKNOWN:
            skipped.append(key)
            continue
        arr = value.numpy() if hasattr(value, "numpy") else np.asarray(value)
        out[ours] = interop.gan_to_jax(arr, kind)
        imported.append(key)
    return out, imported, skipped


def import_gan_checkpoint(src: str, dest: str, *,
                          unsafe_pickle: bool = False):
    """Reference StyleGAN torch checkpoint -> the 5-section npz. Returns
    (imported keys, skipped keys)."""
    ckpt = _load_pickle(src, unsafe_pickle)
    if hasattr(ckpt, "state_dict"):
        ckpt = ckpt.state_dict()
    if not isinstance(ckpt, dict):
        raise ValueError(f"{src!r} is not a checkpoint dict")
    blob, imported, skipped = {}, [], []
    parts = {"generator": "generator", "g_running": "generator",
             "discriminator": "discriminator"}
    if any(k in ckpt for k in parts):
        for section, part in parts.items():
            if section not in ckpt:
                continue
            conv, imp, skp = _convert_gan_sd(ckpt[section], part)
            blob.update({f"{section}/{k}": v for k, v in conv.items()})
            imported += [f"{section}.{k}" for k in imp]
            skipped += [f"{section}.{k}" for k in skp]
        skipped += [k for k in ckpt if k not in parts]
    else:  # a bare StyledGenerator state dict (a g_running snapshot)
        conv, imported, skipped = _convert_gan_sd(ckpt, "generator")
        for section in ("g_running", "generator"):
            blob.update({f"{section}/{k}": v for k, v in conv.items()})
    if not imported:
        raise ValueError(
            f"{src!r} contains no recognizable StyleGAN parameters "
            f"(saw keys like {list(ckpt)[:3]})")
    blob["extra/imported_from"] = np.asarray(src)
    blob["extra/format"] = np.asarray("torch-stylegan")
    checkpoint.save_blob(dest, blob)
    return imported, skipped


# generator blocks from _GEN_FUSED_FROM and critic blocks below
# _DISC_FUSED_BELOW use the fused resampling convs (reference:
# model.py:383-391, 515-523; models/stylegan._gen_layout / _disc_layout)
_GEN_FUSED_FROM = 5
_DISC_FUSED_BELOW = 4
_N_BLOCKS = 9


def _blur_buffers(channels: int):
    k = np.array([[1, 2, 1], [2, 4, 2], [1, 2, 1]], np.float32)
    k = (k / k.sum()).reshape(1, 1, 3, 3).repeat(channels, 0)
    return k, k.copy()  # a symmetric kernel: the flip is the kernel


def _n_blocks(flat, prefix, index):
    n = 1 + max(int(k.split("/")[index]) for k in flat
                if k.startswith(prefix))
    if n != _N_BLOCKS:
        raise ValueError(f"expected {_N_BLOCKS} blocks under {prefix}, found "
                         f"{n}; the reference layout is fixed "
                         "(model.py:383-391, 515-523)")


def _wo(leaf):
    return "weight_orig" if leaf == "w" else "bias"


def _export_gen_sd(flat):
    _n_blocks(flat, "generator/progression/", 2)
    sd = {}
    for okey, value in flat.items():
        parts = okey.split("/")
        lin_or_vec = interop.LIN if parts[-1] == "w" else interop.VEC
        conv_or_vec = interop.CONV if parts[-1] == "w" else interop.VEC
        if parts[0] == "style":
            sd[f"style.{2 * int(parts[1]) + 1}.linear.{_wo(parts[2])}"] = \
                interop.gan_to_torch(value, lin_or_vec)
        elif parts[1] == "to_rgb":
            sd[f"generator.to_rgb.{parts[2]}.conv.{_wo(parts[3])}"] = \
                interop.gan_to_torch(value, conv_or_vec)
        elif parts[1] == "progression":
            i, leaf = int(parts[2]), parts[3]
            base = f"generator.progression.{i}"
            fused = i >= _GEN_FUSED_FROM
            if leaf == "constant":
                sd[f"{base}.conv1.input"] = interop.gan_to_torch(
                    value, interop.CONST)
            elif leaf == "conv1" and fused:
                name = "weight" if parts[4] == "w" else "bias"
                kind = interop.FUP if parts[4] == "w" else interop.VEC
                sd[f"{base}.conv1.0.{name}"] = interop.gan_to_torch(value,
                                                                    kind)
            elif leaf == "conv1":
                sd[f"{base}.conv1.1.conv.{_wo(parts[4])}"] = \
                    interop.gan_to_torch(value, conv_or_vec)
            elif leaf in ("noise1", "noise2"):
                sd[f"{base}.{leaf}.weight_orig"] = interop.gan_to_torch(
                    value, interop.NOISE)
            elif leaf in ("adain1", "adain2"):
                sd[f"{base}.{leaf}.style.linear.{_wo(parts[4])}"] = \
                    interop.gan_to_torch(value, lin_or_vec)
            elif leaf == "conv2":
                sd[f"{base}.conv2.conv.{_wo(parts[4])}"] = \
                    interop.gan_to_torch(value, conv_or_vec)
            else:
                raise KeyError(f"no reference mapping for {okey!r}")
        else:
            raise KeyError(f"no reference mapping for {okey!r}")
    for i in range(1, _N_BLOCKS):  # the blur after each upsampling conv1
        c = flat[f"generator/progression/{i}/conv2/w"].shape[2]
        blur = 1 if i >= _GEN_FUSED_FROM else 2
        base = f"generator.progression.{i}.conv1.{blur}"
        sd[f"{base}.weight"], sd[f"{base}.weight_flip"] = _blur_buffers(c)
    return sd


def _export_disc_sd(flat):
    _n_blocks(flat, "progression/", 1)
    sd = {}
    for okey, value in flat.items():
        parts = okey.split("/")
        is_w = parts[-1] == "w"
        conv_or_vec = interop.CONV if is_w else interop.VEC
        if parts[0] == "linear":
            sd[f"linear.linear.{_wo(parts[1])}"] = interop.gan_to_torch(
                value, interop.LIN if is_w else interop.VEC)
        elif parts[0] == "from_rgb":
            # the from_rgb_activate keys, the reference trainers' default
            sd[f"from_rgb.{parts[1]}.0.conv.{_wo(parts[2])}"] = \
                interop.gan_to_torch(value, conv_or_vec)
        elif parts[0] == "progression":
            i, leaf = int(parts[1]), parts[2]
            base = f"progression.{i}"
            if leaf == "conv1":
                sd[f"{base}.conv1.0.conv.{_wo(parts[3])}"] = \
                    interop.gan_to_torch(value, conv_or_vec)
            elif leaf == "conv2" and i < _DISC_FUSED_BELOW:
                # the FusedDownsample's own weight sits at conv2.1
                name = "weight" if is_w else "bias"
                sd[f"{base}.conv2.1.{name}"] = interop.gan_to_torch(
                    value, conv_or_vec)
            elif leaf == "conv2":
                idx = 0 if i == _N_BLOCKS - 1 else 1
                sd[f"{base}.conv2.{idx}.conv.{_wo(parts[3])}"] = \
                    interop.gan_to_torch(value, conv_or_vec)
            else:
                raise KeyError(f"no reference mapping for {okey!r}")
        else:
            raise KeyError(f"no reference mapping for {okey!r}")
    for i in range(_N_BLOCKS - 1):  # the blur before each downsampling conv2
        c = flat[f"progression/{i}/conv2/w"].shape[2]
        base = f"progression.{i}.conv2.0"
        sd[f"{base}.weight"], sd[f"{base}.weight_flip"] = _blur_buffers(c)
    return sd


def export_gan_checkpoint(src: str, dest: str) -> dict:
    """A GAN npz -> a torch pickle of the reference's ``generator``,
    ``g_running`` and ``discriminator`` state dicts (the optimizer
    sections stay behind). Returns each section's tensor count."""
    blob = checkpoint.load_raw(src)
    out = {}
    for section in sorted({k.split("/", 1)[0] for k in blob
                           if not k.startswith("extra/")}):
        flat = {k.split("/", 1)[1]: v for k, v in blob.items()
                if k.startswith(f"{section}/")}
        if section in ("generator", "g_running"):
            out[section] = _export_gen_sd(flat)
        elif section == "discriminator":
            out[section] = _export_disc_sd(flat)
    if not out:
        raise ValueError(f"{src!r} has no generator/discriminator sections")
    out = {sec: {k: torch.from_numpy(np.ascontiguousarray(v))
                 for k, v in sd.items()} for sec, sd in out.items()}
    torch.save(out, dest)
    return {sec: len(sd) for sec, sd in out.items()}


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
    gimp = sub.add_parser(
        "import-gan", help="reference StyleGAN torch checkpoint -> GAN npz")
    gimp.add_argument("src")
    gimp.add_argument("dest")
    gimp.add_argument("--unsafe-pickle", action="store_true")
    gexp = sub.add_parser("export-gan",
                          help="GAN npz -> reference StyleGAN torch")
    gexp.add_argument("src")
    gexp.add_argument("dest")
    args = p.parse_args(argv)

    if args.cmd == "import-gan":
        imported, skipped = import_gan_checkpoint(
            args.src, args.dest, unsafe_pickle=args.unsafe_pickle)
        print(f"imported {len(imported)} tensors -> {args.dest}")
        if skipped:
            print(f"skipped {len(skipped)} keys (optimizer state / "
                  f"buffers): {skipped[:4]}"
                  f"{'...' if len(skipped) > 4 else ''}")
        print("note: torch optimizer state is positional and is not "
              "imported; GAN training resumes with fresh Adam state")
    elif args.cmd == "export-gan":
        counts = export_gan_checkpoint(args.src, args.dest)
        print(f"exported {counts} -> {args.dest}")
    elif args.cmd == "import":
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
