"""Driver helpers: the caMicroscope ``.dla`` heatmap writer.

Counterpart of ``utils/helpers.py`` in the JAX package (the reconstruction
of the reference's missing ``PyTorchHelpers`` module). Only ``write_map``
is ported so far, for the serving daemon; the stats, summaries and
matplotlib plots come with their own slice. Pure numpy over host arrays.
"""

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
