"""Checkpoint save/load in the JAX package's file format.

Counterpart of ``train/checkpoint.py`` in the JAX package. A checkpoint is
one ``.model`` file holding an npz of the flattened parameter tree, keys
``classifier/<'/'-joined JAX path>`` (``classifier/cnn/stages/0/1/conv2/w``),
with JAX layouts (``utils/interop.jax_params_from_module``). So a file that
either package writes restores into the other, and the reference's
transfer-mode filter (keys containing both 'cnn' and 'conv'; reference:
gbm/classify_combined.py:526-535) stays a literal string match.
``restore_opt_state`` and ``AsyncCheckpointer`` come with the training
slice.
"""

import io
import os
import re

import numpy as np

from ..utils import interop


def _flatten(tree, prefix=""):
    """Nested dicts/lists -> {'a/0/b': array}, dict keys in sorted order
    (the JAX package's traversal)."""
    flat = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            flat.update(_flatten(tree[k], f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            flat.update(_flatten(v, f"{prefix}{i}/"))
    else:
        flat[prefix[:-1]] = np.asarray(tree)
    return flat


def _set_path(tree, key: str, value):
    parts = key.split("/")
    node = tree
    for p in parts[:-1]:
        node = node[int(p)] if isinstance(node, list) else node[p]
    last = parts[-1]
    if isinstance(node, list):
        node[int(last)] = value
    else:
        node[last] = value


def checkpoint_path(output_dir: str, epoch: int, final: bool = False) -> str:
    suffix = "_FINAL" if final else ""
    return os.path.join(output_dir, f"train_step-{epoch:03d}{suffix}.model")


def save_blob(path: str, blob: dict):
    """Atomically persist an already-flattened checkpoint blob: a kill
    mid-write never leaves a truncated file where ``latest_checkpoint`` or
    ``--ckpt`` would pick it up."""
    buf = io.BytesIO()
    np.savez(buf, **blob)
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        with open(tmp, "wb") as f:
            f.write(buf.getvalue())
        os.replace(tmp, path)
    except OSError:
        if os.path.isfile(tmp):
            os.unlink(tmp)
        raise
    return path


def save(path: str, model):
    """Persist ``model``'s parameters (an ``AttentionMIL``) as one .model
    file, in JAX layouts. The optimizer state and extra keys of the JAX
    package's ``save`` come with the training slice."""
    params = interop.jax_params_from_module(model)
    return save_blob(path, {f"classifier/{k}": v
                            for k, v in _flatten(params).items()})


def load_raw(path: str) -> dict:
    with np.load(path, allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


def restore_params(model, path: str, *, transfer: bool = False,
                   strict: bool = False):
    """Overlay checkpointed parameters onto ``model`` in place; returns
    ``(model, loaded keys, skipped keys)``.

    strict=False skips unknown keys and shape mismatches (torch
    ``load_state_dict(strict=False)`` semantics); strict=True raises on
    either, and on a missing key unless ``transfer``. transfer=True keeps
    only keys containing both 'cnn' and 'conv', the reference's
    ResNet-conv-only filter."""
    blob = load_raw(path)
    tree = interop.jax_params_from_module(model)
    flat_new = _flatten(tree)
    loaded, skipped = [], []
    for key, value in blob.items():
        if not key.startswith("classifier/"):
            continue
        pkey = key[len("classifier/"):]
        if transfer and not ("cnn" in pkey and "conv" in pkey):
            continue
        if pkey not in flat_new:
            if strict:
                raise KeyError(f"unexpected checkpoint key {pkey}")
            skipped.append(pkey)
            continue
        if flat_new[pkey].shape != value.shape:
            if strict:
                raise ValueError(f"shape mismatch at {pkey}")
            skipped.append(pkey)
            continue
        _set_path(tree, pkey, value)
        loaded.append(pkey)
    if strict and not transfer:
        missing = set(flat_new) - set(loaded)
        if missing:
            raise KeyError(f"missing checkpoint keys: {sorted(missing)[:5]}...")
    interop.load_jax_params(model, tree)
    return model, loaded, skipped


def latest_checkpoint(output_dir: str) -> str | None:
    pattern = re.compile(r"train_step-(\d+)(_FINAL)?\.model$")
    best, best_epoch = None, -1
    for name in os.listdir(output_dir):
        m = pattern.match(name)
        if m and int(m.group(1)) > best_epoch:
            best_epoch = int(m.group(1))
            best = os.path.join(output_dir, name)
    return best
