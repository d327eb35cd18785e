"""Driver helpers: epoch stats, weight summaries, the classification
report and the caMicroscope ``.dla`` heatmap writer.

Counterpart of ``utils/helpers.py`` in the JAX package (the reconstruction
of the reference's missing ``PyTorchHelpers`` module). Layer names are the
JAX package's parameter paths (``cnn/stages/0/1/conv2/w``), so the
``*summary.json`` files of the two packages compare key for key.
``classification_report`` is the port's own copy of scikit-learn's
``output_dict`` report and ``classification_report_text`` of its printed
table, which the machines the port runs on need not have;
``write_frame_csv`` writes the interface mode's tables in the layout of
pandas' ``to_csv``, which they need not have either.

The figures: ``activation_summary`` / ``activation_grids`` (the data of
``prime_activation_summary`` / ``prime_activation_vis``, from the
ResNet-26's ``taps``), ``plot_activations``, ``plot_kernels``,
``plot_layer_summary``, ``plot_attn_flow``, ``plot_bag_flow``,
``plot_grad_flow``, and ``RandomCrop2X``. matplotlib is imported only
inside :func:`pyplot`, behind a guard: where it is not installed (the
card's machine), :func:`have_matplotlib` is False and a drawing call
raises naming it; the data functions need only numpy and torch.
"""

import csv
import json
import os

import numpy as np
import torch


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


def named_parameters(model, value=None):
    """Yield ('/'-joined JAX path, numpy array in the JAX layout) for an
    ``AttentionMIL``, in the checkpoint's key order; ``value(param)``
    picks another per-parameter tensor (``interop.jax_params_from_module``)."""
    from ..train.checkpoint import _flatten
    from . import interop

    yield from _flatten(interop.jax_params_from_module(model, value)).items()


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


def classification_report_text(report: dict, target_names,
                               digits: int = 2) -> str:
    """The table scikit-learn's ``classification_report`` prints (without
    ``output_dict``), from :func:`classification_report`'s dict."""
    headers = ["precision", "recall", "f1-score", "support"]
    width = max(max(len(n) for n in target_names), len("weighted avg"),
                digits)
    text = ("{:>{width}s} " + " {:>9}" * 4).format("", *headers,
                                                   width=width) + "\n\n"
    row_fmt = "{:>{width}s} " + " {:>9.{digits}f}" * 3 + " {:>9}\n"
    for name in target_names:
        r = report[name]
        text += row_fmt.format(name, r["precision"], r["recall"],
                               r["f1-score"], int(r["support"]),
                               width=width, digits=digits)
    text += "\n"
    total = int(report["macro avg"]["support"])
    text += ("{:>{width}s} " + " {:>9.{digits}}" * 2 + " {:>9.{digits}f}"
             + " {:>9}\n").format("accuracy", "", "", report["accuracy"],
                                  total, width=width, digits=digits)
    for avg in ("macro avg", "weighted avg"):
        r = report[avg]
        text += row_fmt.format(avg, r["precision"], r["recall"],
                               r["f1-score"], total, width=width,
                               digits=digits)
    return text


def write_frame_csv(path: str, rows: dict):
    """Write ``rows`` (key -> 1-D array of floats, all of one length) as
    pandas' ``DataFrame.from_dict(rows, orient="index").to_csv(path)``
    does: the header ``,0,1,...``, one line per key with the key first,
    each float as its shortest ``repr`` (NaN as an empty field), ``\\n``
    line ends and minimal quoting."""
    width = max((len(v) for v in rows.values()), default=0)
    with open(path, "w", newline="") as f:
        out = csv.writer(f, lineterminator="\n")
        out.writerow([""] + [str(i) for i in range(width)])
        for key, values in rows.items():
            out.writerow([key] + ["" if np.isnan(v) else repr(float(v))
                                  for v in np.asarray(values, np.float64)])


# --------------------------------------------------------------- figures


def pyplot():
    """matplotlib's pyplot on the Agg backend, or None where matplotlib is
    not installed."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return None
    return plt


def have_matplotlib() -> bool:
    return pyplot() is not None


def require_pyplot(what: str):
    """pyplot, or a RuntimeError saying that ``what`` needs matplotlib."""
    plt = pyplot()
    if plt is None:
        raise RuntimeError(f"{what} needs matplotlib, which is not "
                           "installed")
    return plt


def _taps(cnn, tiles, compute_dtype, acts):
    if acts is None:
        from ..models import resnet

        with torch.no_grad():
            _, acts = resnet.apply_resnet26(cnn, tiles,
                                            compute_dtype=compute_dtype,
                                            taps=True)
    return {k: v.float().cpu().numpy() if isinstance(v, torch.Tensor)
            else np.asarray(v, np.float32) for k, v in acts.items()}


def activation_summary(cnn, tiles, *, compute_dtype=None, acts=None) -> dict:
    """Layer -> activation stats of the ResNet-26 ``cnn`` over a stack of
    NHWC tiles (``prime_activation_summary``'s hooks, as returns). ``acts``
    reuses a forward's taps."""
    out = {}
    for name, a in _taps(cnn, tiles, compute_dtype, acts).items():
        out[name] = {
            "shape": list(a.shape),
            "mean": float(a.mean()),
            "std": float(a.std()),
            "min": float(a.min()),
            "max": float(a.max()),
            "frac_nonzero": float((a != 0).mean()),
        }
    return out


def activation_grids(cnn, tiles, *, compute_dtype=None, acts=None) -> dict:
    """Layer -> [C, h, w] mean-over-batch feature maps
    (``prime_activation_vis``); feed to :func:`plot_activations`."""
    grids = {}
    for name, a in _taps(cnn, tiles, compute_dtype, acts).items():
        if a.ndim == 4:  # [N, H, W, C] -> [C, H, W]
            grids[name] = a.mean(axis=0).transpose(2, 0, 1)
    return grids


def plot_activations(grid, path=None, max_channels: int = 16):
    """Render a [C, H, W] activation grid (call site:
    gbm/classify_combined.py:381)."""
    plt = require_pyplot("plot_activations")
    c = min(grid.shape[0], max_channels)
    cols = int(np.ceil(np.sqrt(c)))
    rows = int(np.ceil(c / cols))
    fig, axes = plt.subplots(rows, cols, figsize=(2 * cols, 2 * rows))
    axes = np.atleast_1d(axes).ravel()
    for i in range(c):
        axes[i].imshow(grid[i], cmap="viridis")
        axes[i].axis("off")
    for ax in axes[c:]:
        ax.axis("off")
    plt.tight_layout()
    if path:
        plt.savefig(path)
    plt.close(fig)
    return path


def plot_kernels(model, epoch: int, step, *, output_dir: str = ".",
                 max_kernels: int = 20):
    """The first conv kernel grid, in checkpoint key order (call site:
    gbm/classify_combined.py:541)."""
    plt = require_pyplot("plot_kernels")
    for name, w in named_parameters(model):
        if w.ndim == 4:  # HWIO conv kernel
            k = w.transpose(3, 0, 1, 2)  # [O, H, W, I]
            n = min(k.shape[0], max_kernels)
            cols = int(np.ceil(np.sqrt(n)))
            rows = int(np.ceil(n / cols))
            fig, axes = plt.subplots(rows, cols, figsize=(2 * cols, 2 * rows))
            axes = np.atleast_1d(axes).ravel()
            for i in range(n):
                img = k[i, :, :, :3] if k.shape[-1] >= 3 else k[i, :, :, 0]
                lo, hi = img.min(), img.max()
                axes[i].imshow((img - lo) / (hi - lo + 1e-9))
                axes[i].axis("off")
            for ax in axes[n:]:
                ax.axis("off")
            path = os.path.join(
                output_dir,
                f"kernels-{name.replace('/', '.')}-ep{epoch:03d}.png")
            plt.tight_layout()
            plt.savefig(path)
            plt.close(fig)
            return path  # the reference plots the stem: the first conv wins
    return None


def _bar_chart(plt, names, series, path, ylabel=None):
    fig = plt.figure(figsize=(max(6, len(names) * 0.4), 4))
    xs = np.arange(len(names))
    width = 0.8 / len(series)
    for j, (label, vals) in enumerate(series):
        offset = (j - (len(series) - 1) / 2) * width
        plt.bar(xs + offset, vals, width=width if len(series) > 1 else 0.8,
                label=label)
    plt.xticks(xs, names, rotation=90, fontsize=5)
    if ylabel:
        plt.ylabel(ylabel)
    if len(series) > 1:
        plt.legend()
    plt.tight_layout()
    if path:
        plt.savefig(path)
    plt.close(fig)


def plot_layer_summary(model, path=None):
    """Per-layer weight mean/max |w| bars (call site: gbm/classify.py:324);
    returns {layer: (mean, max)}."""
    plt = require_pyplot("plot_layer_summary")
    names, means, maxes = [], [], []
    for name, w in named_parameters(model):
        names.append(name)
        means.append(float(np.abs(w).mean()))
        maxes.append(float(np.abs(w).max()))
    _bar_chart(plt, names, [("mean |w|", means), ("max |w|", maxes)], path)
    return dict(zip(names, zip(means, maxes)))


def plot_attn_flow(attention_weights, path=None):
    """Per-map attention-weight histograms over tiles (call site:
    gbm/classify.py:325). attention_weights: [K, T]."""
    plt = require_pyplot("plot_attn_flow")
    a = np.asarray(attention_weights)
    fig, axes = plt.subplots(1, a.shape[0], figsize=(4 * a.shape[0], 3))
    for k, ax in enumerate(np.atleast_1d(axes)):
        ax.hist(a[k], bins=40)
        ax.set_title(f"map {k}")
        ax.set_xlabel("attention weight")
    plt.tight_layout()
    if path:
        plt.savefig(path)
    plt.close(fig)
    return path


def plot_bag_flow(bag_sizes, losses=None, path=None):
    """Tiles-a-bag trajectory with an optional loss overlay (call site:
    gbm/classify.py:327)."""
    plt = require_pyplot("plot_bag_flow")
    fig, ax1 = plt.subplots(figsize=(8, 3))
    ax1.plot(bag_sizes, "C0")
    ax1.set_ylabel("tiles/bag", color="C0")
    ax1.set_xlabel("step")
    if losses is not None:
        ax2 = ax1.twinx()
        ax2.plot(losses, "C1")
        ax2.set_ylabel("loss", color="C1")
    plt.tight_layout()
    if path:
        plt.savefig(path)
    plt.close(fig)
    return path


def plot_grad_flow(model, path=None):
    """Mean |grad| per layer, from the parameters' ``.grad`` (zero where
    none), as bars (call site: gbm/classify.py:326); returns the means."""
    plt = require_pyplot("plot_grad_flow")
    names, means = [], []
    for name, g in named_parameters(
            model, lambda p: p.grad if p.grad is not None
            else torch.zeros_like(p)):
        names.append(name)
        means.append(float(np.abs(g).mean()))
    _bar_chart(plt, names, [("mean |grad|", means)], path,
               ylabel="mean |grad|")
    return means


class RandomCrop2X:
    """One random crop applied to two paired images
    (PyTorchHelpers.RandomCrop2X call sites: Datasets.py:171,242,331).

    Execute(imgA, imgB) -> (cropA, cropB, (row, col)); HWC numpy arrays,
    zero-padded like torchvision's pad_if_needed. The offsets draw from
    numpy's ``default_rng(seed)`` as in the JAX package, so both packages
    crop alike."""

    def __init__(self, size: int, pad_if_needed: bool = True, seed=None):
        self.size = size
        self.pad_if_needed = pad_if_needed
        self._rng = np.random.default_rng(seed)

    def _pad(self, img):
        h, w = img.shape[:2]
        ph, pw = max(0, self.size - h), max(0, self.size - w)
        if ph or pw:
            img = np.pad(img, [(0, ph), (0, pw)] + [(0, 0)] * (img.ndim - 2))
        return img

    def Execute(self, img_a, img_b):
        if self.pad_if_needed:
            img_a, img_b = self._pad(img_a), self._pad(img_b)
        h, w = img_a.shape[:2]
        r = int(self._rng.integers(0, h - self.size + 1))
        c = int(self._rng.integers(0, w - self.size + 1))
        crop_a = img_a[r:r + self.size, c:c + self.size]
        crop_b = img_b[r:r + self.size, c:c + self.size]
        return crop_a, crop_b, (r, c)
