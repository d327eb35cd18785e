"""Driver helpers: epoch stats, weight summaries, the classification
report and the caMicroscope ``.dla`` heatmap writer.

Counterpart of ``utils/helpers.py`` in the JAX package (the reconstruction
of the reference's missing ``PyTorchHelpers`` module). Layer names are the
JAX package's parameter paths (``cnn/stages/0/1/conv2/w``), so the
``*summary.json`` files of the two packages compare key for key.
``classification_report`` is the port's own copy of scikit-learn's
``output_dict`` report, which the machines the port runs on need not
have. The matplotlib plots (activations, kernels, layer and gradient
flows) are not ported yet. Pure numpy over host arrays.
"""

import json
import os

import numpy as np


def _minmax_normalize(x):
    x = np.asarray(x, np.float64)
    if x.size == 0:  # a tile-less slide writes an empty .dla
        return x
    lo, hi = x.min(), x.max()
    return (x - lo) / (hi - lo) if hi > lo else np.zeros_like(x)


def write_map(meta: dict, epoch: int, raster, attn, manifest=None,
              output_dir: str = "."):
    """Emit per-tile heatmap annotations as ``.dla`` text files.

    Format (one line per tile): ``x y weight`` with x=col, y=row, the
    caMicroscope annotation export (reference: gbm/classify.py:207-225).
    attn: [K, T] attention maps; map 0 is written as ATTN (min-max
    normalized) and each map k as ACTF<k+1>. Appends a manifest row when a
    file handle is given. ``epoch`` is unused, as in the reference's
    signature. Returns the paths written."""
    name = meta["basename"]
    attn = np.asarray(attn)
    if attn.ndim == 1:
        attn = attn[None, :]
    files = []
    norm = _minmax_normalize(attn[0])
    path = os.path.join(output_dir, f"prediction-AGMIL-ATTN.{name}.dla")
    with open(path, "w") as f:
        for i, coord in enumerate(raster):
            f.write(f"{coord[1]} {coord[0]} {norm[i]}\n")
    files.append(path)
    for k in range(attn.shape[0]):
        path = os.path.join(output_dir,
                            f"prediction-AGMIL-ACTF{k + 1}.{name}.dla")
        with open(path, "w") as f:
            for i, coord in enumerate(raster):
                f.write(f"{coord[1]} {coord[0]} {attn[k, i]}\n")
        files.append(path)
    if manifest is not None:
        manifest.write("{0},{1},{2},{3}\n".format(
            files[0], meta.get("caMIC_study", meta.get("studyid", "na")),
            meta.get("caMIC_id_name", name), meta.get("caMIC_id_name", name)))
    return files


# ---------------------------------------------------------------- stats


def savestats(args, output_dir: str, epoch: int, epoch_stats: dict) -> str:
    """Persist the per-epoch stats dict as ``<epoch>summary.json`` (call
    site: gbm/classify_combined.py:570; globbed as '*summary.json')."""
    path = os.path.join(output_dir, f"{epoch:04d}summary.json")
    payload = dict(epoch_stats)
    payload["epoch"] = epoch
    if args is not None:
        payload["args"] = {k: v for k, v in vars(args).items()
                           if isinstance(v, (str, int, float, bool, type(None)))}
    with open(path, "w") as f:
        json.dump(payload, f, indent=2, sort_keys=True, default=float)
    return path


def named_parameters(model):
    """Yield ('/'-joined JAX path, numpy array in the JAX layout) for an
    ``AttentionMIL``, in the checkpoint's key order."""
    from ..train.checkpoint import _flatten
    from . import interop

    yield from _flatten(interop.jax_params_from_module(model)).items()


def get_layer_weight_summary_mean(model) -> dict:
    """Per-layer mean |w| (call site: gbm/classify_combined.py:484)."""
    return {name: float(np.abs(w).mean())
            for name, w in named_parameters(model)}


def get_layer_weight_summary_max(model) -> dict:
    """Per-layer max |w| (call site: gbm/classify_combined.py:485)."""
    return {name: float(np.abs(w).max())
            for name, w in named_parameters(model)}


def model_summary(model, header: str = "AttentionMIL") -> str:
    """Structure dump string (model_structure.txt, call site:
    gbm/classify_combined.py:546-549)."""
    lines = [header]
    total = 0
    for name, w in named_parameters(model):
        lines.append(f"  {name:60s} {str(w.shape):20s} {w.size}")
        total += w.size
    lines.append(f"  total parameters: {total}")
    return "\n".join(lines)


def classification_report(y_true, y_pred, *, labels, target_names):
    """scikit-learn's ``classification_report(..., output_dict=True,
    zero_division=0)``: per class ``precision``, ``recall``, ``f1-score``
    and ``support``, then ``accuracy`` and the ``macro avg`` / ``weighted
    avg`` rows. A ratio with a zero denominator is 0. ``labels`` must cover
    every label present (the trainer passes all classes), which is when
    scikit-learn reports ``accuracy`` rather than a micro average."""
    y_true = np.asarray(y_true).ravel()
    y_pred = np.asarray(y_pred).ravel()
    labels = list(labels)
    if set(np.unique(np.concatenate([y_true, y_pred]))) - set(labels):
        raise ValueError("labels must cover every label present")

    def ratio(num, den):
        return float(num) / float(den) if den > 0 else 0.0

    report, rows = {}, []
    for name, lbl in zip(target_names, labels):
        tp = int(np.sum((y_true == lbl) & (y_pred == lbl)))
        fp = int(np.sum((y_true != lbl) & (y_pred == lbl)))
        fn = int(np.sum((y_true == lbl) & (y_pred != lbl)))
        row = {"precision": ratio(tp, tp + fp), "recall": ratio(tp, tp + fn),
               "f1-score": ratio(2 * tp, 2 * tp + fp + fn),
               "support": tp + fn}
        report[name] = row
        rows.append(row)
    support = np.asarray([r["support"] for r in rows], np.float64)
    total = int(support.sum())
    report["accuracy"] = ratio(np.sum(y_true == y_pred), len(y_true))
    for avg, weights in (("macro avg", None), ("weighted avg", support)):
        out = {}
        for key in ("precision", "recall", "f1-score"):
            vals = np.asarray([r[key] for r in rows], np.float64)
            if weights is None:
                out[key] = float(vals.mean())
            else:
                out[key] = (float(np.average(vals, weights=weights))
                            if total > 0 else 0.0)
        out["support"] = total
        report[avg] = out
    return report
