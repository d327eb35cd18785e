"""Checkpoint save/load in the JAX package's file format.

Counterpart of ``train/checkpoint.py`` in the JAX package. A checkpoint is
one ``.model`` file holding an npz of the flattened parameter tree, keys
``classifier/<'/'-joined JAX path>`` (``classifier/cnn/stages/0/1/conv2/w``),
with JAX layouts (``utils/interop.jax_params_from_module``). So a file that
either package writes restores into the other, and the reference's
transfer-mode filter (keys containing both 'cnn' and 'conv'; reference:
gbm/classify_combined.py:526-535) stays a literal string match.

With an optimizer, ``save`` also writes its Adam state under the keys that
the JAX package's ``_flatten`` gives optax's ``ScaleByAdamState``:
``optimizer/count``, ``optimizer/mu/<JAX path>`` and
``optimizer/nu/<JAX path>``; ``restore_opt_state`` reads them back, so a
run resumes across the two packages with its moments. ``AsyncCheckpointer``
writes in a background thread; since ``optimizer.step()`` updates the
parameters in place, its ``save`` copies everything to host memory before
it returns.
"""

import io
import os
import re
import threading

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


def snapshot(model, optimizer=None) -> dict:
    """The flattened checkpoint blob of ``model`` (an ``AttentionMIL``)
    and, when given, its ``torch.optim.Adam``: host numpy copies in JAX
    layouts, taken when this returns (the copies off the card
    synchronise)."""
    blob = {f"classifier/{k}": v for k, v in
            _flatten(interop.jax_params_from_module(model)).items()}
    if optimizer is not None:
        count, mu, nu = interop.adam_state_to_jax(model, optimizer)
        blob["optimizer/count"] = np.asarray(count, np.int32)
        for name, tree in (("mu", mu), ("nu", nu)):
            blob.update({f"optimizer/{name}/{k}": v
                         for k, v in _flatten(tree).items()})
    return blob


def save(path: str, model, optimizer=None, extra: dict | None = None):
    """Persist ``model``'s parameters (and ``optimizer``'s Adam state) as
    one .model file, in JAX layouts; ``extra`` entries go under
    ``extra/<key>``."""
    blob = snapshot(model, optimizer)
    for k, v in (extra or {}).items():
        blob[f"extra/{k}"] = np.asarray(v)
    return save_blob(path, blob)


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


def restore_opt_state(optimizer, model, path: str):
    """Overlay the Adam state of a checkpoint (written by either package)
    onto ``optimizer`` over ``model``'s parameters; a moment whose key is
    missing or whose shape differs keeps its current value. Returns
    ``(optimizer, ok)``, ``ok`` False when the file holds no optimizer
    state (the optimizer is then untouched)."""
    blob = load_raw(path)
    if "optimizer/count" not in blob:
        return optimizer, False
    count, mu, nu = interop.adam_state_to_jax(model, optimizer)
    loaded = 0
    for name, tree in (("mu", mu), ("nu", nu)):
        for key, value in _flatten(tree).items():
            stored = blob.get(f"optimizer/{name}/{key}")
            if stored is not None and stored.shape == value.shape:
                _set_path(tree, key, stored)
                loaded += 1
    if not loaded:
        return optimizer, False
    interop.load_adam_state(model, optimizer, blob["optimizer/count"], mu,
                            nu)
    return optimizer, True


class AsyncCheckpointer:
    """Overlap a checkpoint's serialization and file write with training
    (what orbax calls async checkpointing).

    ``save`` takes the host snapshot (:func:`snapshot`) before it returns,
    so the next in-place ``optimizer.step()`` cannot reach the file; a
    worker thread then writes it atomically. At most one write is in
    flight: a new ``save``/``submit`` (or ``wait()``) joins the previous
    one first, and a worker failure re-raises there. Callers ``wait()``
    before exiting or halting so the last file is durable (the thread is
    not a daemon, so a clean interpreter exit drains it too)."""

    def __init__(self):
        self._thread: threading.Thread | None = None
        self._exc: BaseException | None = None

    def submit(self, fn, /, *args, **kwargs):
        self.wait()

        def run():
            try:
                fn(*args, **kwargs)
            except BaseException as e:  # surfaced by the next wait()
                self._exc = e

        self._thread = threading.Thread(target=run,
                                        name="async-checkpoint-writer")
        self._thread.start()

    def save(self, path: str, model, optimizer=None):
        """Snapshot now, write in the background (module-level ``save``)."""
        self.submit(save_blob, path, snapshot(model, optimizer))

    def wait(self):
        """Join the in-flight write, if any; re-raise its failure."""
        t, self._thread = self._thread, None
        if t is not None:
            t.join()
        if self._exc is not None:
            e, self._exc = self._exc, None
            raise e


def latest_checkpoint(output_dir: str) -> str | None:
    pattern = re.compile(r"train_step-(\d+)(_FINAL)?\.model$")
    best, best_epoch = None, -1
    for name in os.listdir(output_dir):
        m = pattern.match(name)
        if m and int(m.group(1)) > best_epoch:
            best_epoch = int(m.group(1))
            best = os.path.join(output_dir, name)
    return best
