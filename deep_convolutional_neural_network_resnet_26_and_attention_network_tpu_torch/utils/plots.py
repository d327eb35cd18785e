"""Metric and report plots over the training JSON artifacts.

Counterpart of ``utils/plots.py`` in the JAX package: the reference's
plot entry points against the same artifacts (``*summary.json`` a
validated epoch, ``<epoch>predictions.json``):

  plot_gbm_metrics        (reference: plot_gbm_metrics.py:13-81, loss /
                           accuracy / F1 curves; gbm/plot_coef_metrics.py:
                           31-59, the gate-coefficient curves)
  plot_prediction_summary (reference: gbm/plot_coef_metrics.py:61-92)
  plot_roc                (reference: gbm/plot_roc.py:12-38)
  plot_layer_metrics      (reference: plot_layer_metrics.py:19-44)

and ``save_predictions``, which writes ``plot_roc``'s input. The figures
need matplotlib (``helpers.pyplot``, a guarded import): where it is not
installed they raise naming it, and ``main`` exits naming it.
``plot_roc``'s curve and AUC are computed here (:func:`roc_curve`,
:func:`auc`, scikit-learn's functions), so it does not need scikit-learn.

    python -m deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.utils.plots <run_dir>
"""

import glob
import json
import os

import numpy as np

from .helpers import have_matplotlib, require_pyplot


def _load_summaries(path: str):
    out = []
    for file in sorted(glob.glob(os.path.join(path, "*summary.json"))):
        with open(file) as f:
            out.append(json.load(f))
    return out


def metric_series(summaries, key, sub=None, cls=None):
    """One curve's values over the epochs' summaries (NaN where absent)."""
    vals = []
    for d in summaries:
        try:
            v = d[key]
            if cls is not None:
                v = v[cls][sub] if sub else v[cls]
            vals.append(v)
        except (KeyError, TypeError):
            vals.append(np.nan)
    return vals


def plot_gbm_metrics(path: str, tag: str = "TEST", show: bool = False):
    """Training curves (losses, accuracy, per-class F1, the regularizer)
    and the gate coefficients; returns the saved figure paths."""
    summaries = _load_summaries(path)
    if not summaries:
        return []
    plt = require_pyplot("plot_gbm_metrics")

    def series(*a, **kw):
        return metric_series(summaries, *a, **kw)

    plt.figure(figsize=(8, 8))
    plt.plot(series("train_loss"), "C1--", label="Train Loss")
    plt.plot(series("valid_loss"), "C1", label="Valid Loss")
    plt.plot(series("train_wsum"), "C6--", label="Train Regularization")
    plt.plot(series("valid_wsum"), "C6", label="Valid Regularization")
    plt.plot(series("train_acc", cls="accuracy"), "k--",
             label="Train Accuracy")
    plt.plot(series("valid_acc", cls="accuracy"), "k",
             label="Validation Accuracy")
    for cls, color in zip("ABC", "rgb"):
        plt.plot(series("valid_acc", "f1-score", cls), color,
                 label=f"Validation {cls} F1-Score")
        plt.plot(series("train_acc", "f1-score", cls), color + "--",
                 label=f"Train {cls} F1-Score")
    plt.ylabel("Value")
    plt.xlabel("Epoch")
    plt.legend(loc="upper left")
    fig_path = os.path.join(path, f"gbm_progress_tag{tag}.pdf")
    plt.savefig(fig_path)
    plt.close()

    plt.figure(figsize=(8, 8))
    for i, color in zip((1, 2, 3), "rgb"):
        plt.plot(series(f"coef_a{i}"), color, label=f"Coefficent {i}")
    plt.ylabel("Value")
    plt.xlabel("Epoch")
    plt.legend(loc="upper left")
    coef_path = os.path.join(path, f"gbm_coef_tag{tag}.pdf")
    plt.savefig(coef_path)
    plt.close()
    return [fig_path, coef_path]


def plot_prediction_summary(epoch: int, output_dir: str, preds, labels):
    """Per-slide class-probability bars, each slide's true-class bar green
    and the others red (gbm/plot_coef_metrics.py:74-76)."""
    plt = require_pyplot("plot_prediction_summary")
    preds = np.asarray(preds)
    labels = np.asarray(labels)
    plt.figure(figsize=(24, 4))
    bar_width = 0.2
    r1 = np.arange(preds.shape[0])
    for k, label_name in enumerate(["Pred A", "Pred B", "Pred C"]):
        plt.bar(r1 + k * bar_width, preds[:, k],
                color=np.where(labels == k, "g", "r"), width=bar_width,
                edgecolor="white", label=f"{label_name} (r/g correct)")
    plt.legend()
    path = os.path.join(output_dir,
                        f"validation_performance-{epoch:03d}.pdf")
    plt.savefig(path)
    plt.close()
    return path


def save_predictions(output_dir: str, epoch: int, predictions, labels):
    """Write ``<epoch>predictions.json``, the input of plot_roc (globbed at
    gbm/plot_roc.py:14)."""
    path = os.path.join(output_dir, f"{epoch:04d}predictions.json")
    with open(path, "w") as f:
        json.dump({"predictions": [float(p) for p in predictions],
                   "labels": [float(lbl) for lbl in labels]}, f)
    return path


def roc_curve(labels, scores):
    """scikit-learn's ``roc_curve(labels, scores)`` with its defaults
    (``drop_intermediate=True``): (fpr, tpr, thresholds), the first
    threshold +inf. ``labels`` are 0/1."""
    y = np.asarray(labels, np.float64).ravel()
    s = np.asarray(scores, np.float64).ravel()
    order = np.argsort(s, kind="mergesort")[::-1]
    y, s = y[order], s[order]
    distinct = np.where(np.diff(s))[0]
    idx = np.r_[distinct, y.size - 1]
    tps = np.cumsum(y)[idx]
    fps = 1 + idx - tps
    thresholds = s[idx]
    if tps.size > 2:  # drop the collinear points, as scikit-learn does
        keep = np.where(np.r_[True, np.logical_or(np.diff(fps, 2),
                                                  np.diff(tps, 2)),
                              True])[0]
        fps, tps, thresholds = fps[keep], tps[keep], thresholds[keep]
    tps = np.r_[0, tps]
    fps = np.r_[0, fps]
    thresholds = np.r_[np.inf, thresholds]
    fpr = fps / fps[-1] if fps[-1] > 0 else np.full(fps.shape, np.nan)
    tpr = tps / tps[-1] if tps[-1] > 0 else np.full(tps.shape, np.nan)
    return fpr, tpr, thresholds


def auc(x, y):
    """The trapezoidal area under (x, y), x monotonic (scikit-learn's
    ``auc``)."""
    x, y = np.asarray(x, np.float64), np.asarray(y, np.float64)
    direction = -1 if np.any(np.diff(x) < 0) else 1
    trapezoid = getattr(np, "trapezoid", None) or np.trapz  # numpy < 2
    return float(direction * trapezoid(y, x))


def plot_roc(path: str, tag: str = "TEST", show: bool = False,
             describe: bool = False):
    """ROC curves and the AUC trajectory over the ``*predictions.json``
    artifacts (reference: gbm/plot_roc.py:12-38); returns (paths, aucs)."""
    files = sorted(glob.glob(os.path.join(path, "*predictions.json")))
    if not files:
        return [], []
    plt = require_pyplot("plot_roc")
    colors = plt.cm.rainbow(np.linspace(0, 1, len(files)))
    aucs = []
    plt.figure(figsize=(8, 8))
    for i, file in enumerate(files):
        with open(file) as f:
            d = json.load(f)
        fpr, tpr, _ = roc_curve(d["labels"], d["predictions"])
        roc_auc = auc(fpr, tpr)
        plt.plot(fpr, tpr, color=colors[i], label="AUC = %0.2f" % roc_auc)
        aucs.append(roc_auc)
    plt.legend(loc="lower right")
    plt.plot([0, 1], [0, 1], "r--")
    plt.xlim([0, 1])
    plt.ylim([0, 1])
    plt.ylabel("True Positive Rate")
    plt.xlabel("False Positive Rate")
    roc_path = os.path.join(path, f"roc_tag{tag}.pdf")
    plt.savefig(roc_path)
    plt.close()

    plt.figure()
    plt.plot(aucs)
    auc_path = os.path.join(path, f"auc_tag{tag}.pdf")
    plt.savefig(auc_path)
    plt.close()
    return [roc_path, auc_path], aucs


def layer_metric_series(summaries) -> dict:
    """Layer -> its max |w| over the epochs (biases left out), from the
    summaries' ``model_max_weights``."""
    if not summaries or "model_max_weights" not in summaries[0]:
        return {}
    results = {k: [] for k in summaries[0]["model_max_weights"]
               if "b" != k.rsplit("/", 1)[-1]}
    for d in summaries:
        for k in results:
            results[k].append(d.get("model_max_weights", {}).get(k, np.nan))
    return results


def plot_layer_metrics(path: str, tag: str = "TEST"):
    """Per-layer max |w| trajectories from the summary JSONs
    (reference: plot_layer_metrics.py:19-44)."""
    results = layer_metric_series(_load_summaries(path))
    if not results:
        return None
    plt = require_pyplot("plot_layer_metrics")
    colors = iter(plt.cm.rainbow(np.linspace(0, 1, len(results))))
    plt.figure(figsize=(8, 8))
    for k, vals in results.items():
        plt.plot(vals, c=next(colors), label=k)
    plt.ylabel("Value")
    plt.xlabel("Epoch")
    plt.legend(loc="best", fontsize=5)
    fig_path = os.path.join(path, f"gbm_layer_progress_tag{tag}.pdf")
    plt.savefig(fig_path)
    plt.close()
    return fig_path


def build_argparser():
    import argparse

    ap = argparse.ArgumentParser(description="Plot training artifacts")
    ap.add_argument("path", help="run directory with *summary.json")
    ap.add_argument("--tag", default="TEST")
    return ap


def main(argv=None, device=None):
    """CLI: redraw every plot of a run directory (the reference ships
    plot_gbm_metrics.py / plot_roc.py / plot_layer_metrics.py as
    scripts). ``device`` is taken as the other CLIs take it and not used:
    the plots are drawn on the host from the run's JSON."""
    args = build_argparser().parse_args(argv)
    if not have_matplotlib():
        raise SystemExit("plots: drawing needs matplotlib, which is not "
                         "installed here; the JSON artifacts under "
                         f"{args.path} hold the data")
    print("metrics:", plot_gbm_metrics(args.path, args.tag))
    roc = plot_roc(args.path, args.tag)
    if roc[0]:
        print("roc:", roc[0])
    layers = plot_layer_metrics(args.path, args.tag)
    if layers:
        print("layers:", layers)
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
