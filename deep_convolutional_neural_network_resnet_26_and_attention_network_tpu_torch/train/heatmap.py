"""The attention heatmap panel.

Counterpart of ``train/heatmap.py`` in the JAX package, after the
reference's ``visualize``/``create_map`` figure (reference:
gbm/classify_combined.py:142-218): a 2x3 panel with (0,0) the tissue mosaic
under the mean-attention overlay, (1,0..2) the three per-map attention
overlays on the tiles' raster, (0,1) the per-tile feature strips and (0,2)
the slide embedding with the mean angle between the class vectors in its
title. The data (:func:`embedding_angle`, :func:`attention_overlay`,
:func:`panel_data`) is numpy; the drawing needs matplotlib
(``utils/helpers.pyplot``), and raises naming it where it is missing.
"""

import os

import numpy as np

from ..utils.helpers import require_pyplot


def embedding_angle(M: np.ndarray) -> float:
    """Mean pairwise angle (degrees) between slide-embedding vectors
    (reference: gbm/classify_combined.py:157-161)."""
    M = np.asarray(M, np.float64)
    angles = []
    for i in range(M.shape[0]):
        for j in range(i + 1, M.shape[0]):
            v1, v2 = M[i], M[j]
            cosine = v1.dot(v2) / (np.linalg.norm(v1) * np.linalg.norm(v2)
                                   + 1e-5)
            angles.append(np.arccos(np.clip(cosine, -1.0, 1.0)))
    return float(np.degrees(np.mean(angles))) if angles else 0.0


def attention_overlay(w, rows, cols, roi_size, n_rows, n_cols, alpha,
                      cmap_lin) -> np.ndarray:
    """[n_rows, n_cols, 4] RGBA grid coloring every tile like the
    reference's per-tile rectangles (gbm/classify_combined.py:186-203):
    cell (r // roi_size, c // roi_size) gets jet(min(int(w), 104)) at
    ``alpha``; cells without a tile stay transparent."""
    colors = cmap_lin[np.minimum(np.asarray(w).astype(int), 104)]
    overlay = np.zeros((n_rows, n_cols, 4), np.float32)
    gr, gc = rows // roi_size, cols // roi_size
    overlay[gr, gc, :3] = colors[:, :3]
    overlay[gr, gc, 3] = alpha
    return overlay


def panel_data(img_data, raster, A, F, M, *, roi_size: int = 1200,
               downsample_tissue: int = 8) -> dict:
    """The arrays the panel draws: the min-max normalized attention ``A1``,
    the overlay weights (100 x the mean map, then each map), the tissue
    ``mosaic`` [n_rows*ts, n_cols*ts, 3] uint8, the ``featmap`` strips, the
    raster's ``rows``/``cols`` and grid size, and the embedding ``angle``.

    A: [K>=3, T] per-map attention (wROIs), F: [T, L] per-tile features,
    M: [K, O] slide embedding, raster: [T, 2] (row, col) tile coordinates,
    img_data: the T raw tiles."""
    A = np.asarray(A, np.float64)
    F = np.asarray(F, np.float64)
    M = np.asarray(M, np.float64).reshape(A.shape[0], -1)
    lo, hi = A.min(), A.max()
    A1 = (A - lo) / (hi - lo) if hi > lo else np.zeros_like(A)
    a_all = A1.mean(axis=0)
    s = roi_size
    rows = np.asarray(raster)[:, 0].astype(int)
    cols = np.asarray(raster)[:, 1].astype(int)
    ts = max(4, min(32, s // max(downsample_tissue, 1)))  # thumb px/tile
    n_rows = (int(rows.max()) // s + 1) if len(rows) else 1
    n_cols = (int(cols.max()) // s + 1) if len(cols) else 1
    mosaic = np.full((n_rows * ts, n_cols * ts, 3), 255, np.uint8)
    side = F.shape[1] // 10 if F.ndim == 2 else 8
    featmap = np.zeros((n_rows * side, n_cols * 10), np.float32)
    for i, roi in enumerate(img_data):
        gr, gc = rows[i] // s, cols[i] // s
        roi = np.asarray(roi)
        step_r = max(1, roi.shape[0] // ts)
        thumb = roi[::step_r, ::step_r][:ts, :ts]
        mosaic[gr * ts:gr * ts + thumb.shape[0],
               gc * ts:gc * ts + thumb.shape[1]] = thumb[..., :3]
        featmap[gr * side:(gr + 1) * side, gc * 10:(gc + 1) * 10] = \
            np.asarray(F[i]).ravel()[: side * 10].reshape(side, 10)
    return {"A1": A1, "M": M, "angle": embedding_angle(M),
            "weights": [100 * a_all, 100 * A1[0], 100 * A1[1], 100 * A1[2]],
            "mosaic": mosaic, "featmap": featmap, "rows": rows,
            "cols": cols, "n_rows": n_rows, "n_cols": n_cols}


def create_map(name, epoch, step, img_data, raster, A, F, M, *,
               roi_size: int = 1200, output_dir: str = ".",
               show: bool = False, downsample_tissue: int = 8):
    """Render and save the 2x3 attention panel; returns its path."""
    plt = require_pyplot("create_map")
    d = panel_data(img_data, raster, A, F, M, roi_size=roi_size,
                   downsample_tissue=downsample_tissue)
    M = d["M"]
    s, rows, cols = roi_size, d["rows"], d["cols"]
    n_rows, n_cols = d["n_rows"], d["n_cols"]
    plt.ioff()
    fig, ax = plt.subplots(figsize=(12, 8), nrows=2, ncols=3)
    cmap_lin = plt.cm.jet(np.linspace(0, 1, 105))
    fig.suptitle(f"Epoch = {epoch}")
    # slide-coordinate extent matching the reference rectangles' spans:
    # the canvas's top row (slide row 0) renders at y in [-s, 0]
    extent = (0, n_cols * s, n_rows * s - s, -s)
    ax[0, 0].imshow(d["mosaic"], origin="upper", extent=extent,
                    interpolation="nearest")
    ax[0, 1].imshow(d["featmap"], origin="upper", extent=extent,
                    interpolation="nearest")
    # one RGBA image a map over the mosaic's extent: the per-tile
    # rectangles of the reference, as O(1) artists
    for panel, w, alpha in zip([ax[0, 0], ax[1, 0], ax[1, 1], ax[1, 2]],
                               d["weights"], [0.3, 0.9, 0.9, 0.9]):
        panel.imshow(attention_overlay(w, rows, cols, s, n_rows, n_cols,
                                       alpha, cmap_lin),
                     origin="upper", extent=extent, interpolation="nearest",
                     zorder=2)
    chan_min, chan_max = M.min(), M.max()
    span = (chan_max - chan_min) if chan_max > chan_min else 1.0
    ax[0, 2].imshow((M.reshape(1, 1, -1)[..., :3] - chan_min) / span,
                    origin="upper", extent=(0, 1, 0, -1))
    ax[0, 2].title.set_text(
        f"Angle = {d['angle']:.2f}, Chan = {chan_min:.2f},{chan_max:.2f}")
    y_top = int(rows.max()) if len(rows) else s
    x_right = (int(cols.max()) + s) if len(cols) else s
    for a in [ax[0, 0], ax[0, 1], ax[1, 0], ax[1, 1], ax[1, 2]]:
        a.set_ylim(0 - s, y_top)
        a.set_xlim(0, x_right)
        a.set_aspect("equal")
    # fixed margins: tight_layout would render the whole figure once more
    fig.subplots_adjust(left=0.06, right=0.98, bottom=0.06, top=0.90,
                        wspace=0.25, hspace=0.25)
    path = os.path.join(
        output_dir,
        f"gbm_status-{str(epoch).zfill(3)}_sample-{name}-heatmap.pdf")
    if show:
        plt.show()
    plt.savefig(path)
    plt.close(fig)
    return path
