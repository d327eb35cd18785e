"""Training artifacts written as data.

Counterpart of ``utils/plots.py`` in the JAX package. Only
``save_predictions`` (a JSON file) is ported: the figures (the metric
curves, the prediction summary, ROC and layer plots) need matplotlib,
which the machines the port runs on need not have, and wait for their own
slice (``ROADMAP.md``).
"""

import json
import os


def save_predictions(output_dir: str, epoch: int, predictions, labels):
    """Write ``<epoch>predictions.json``, the input of plot_roc (globbed at
    gbm/plot_roc.py:14)."""
    path = os.path.join(output_dir, f"{epoch:04d}predictions.json")
    with open(path, "w") as f:
        json.dump({"predictions": [float(p) for p in predictions],
                   "labels": [float(lbl) for lbl in labels]}, f)
    return path
