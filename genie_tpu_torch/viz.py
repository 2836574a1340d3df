"""Training/inference diagnostic plots.

Copied from ``genie_tpu/viz.py``. Twin of the reference's
``visualize_predictions`` (utils.py:1118-1225): map views of grid
detections vs labels, query cross-sections, and association score panels,
written as PNGs under ``Plots/``. Matplotlib is imported inside each
function, so importing this module does not need it.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np


def visualize_predictions(out_path, step, grid_pos, lbl_grid, pred_grid,
                          x_query=None, lbl_query=None, pred_query=None,
                          arv_p=None, lbl_p=None):
    """Write one diagnostic figure. Arrays:
    grid_pos (n_src, 3) cart; lbl_grid/pred_grid (n_src, n_t)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    n_panels = 4 + (2 if x_query is not None else 0) + (1 if arv_p is not None else 0)
    fig, axes = plt.subplots(1, n_panels, figsize=(4 * n_panels, 4))
    axes = np.atleast_1d(axes)

    it = np.unravel_index(np.argmax(lbl_grid), lbl_grid.shape)[1]
    sc = axes[0].scatter(grid_pos[:, 0] / 1e3, grid_pos[:, 1] / 1e3,
                         c=lbl_grid[:, it], s=8, vmin=0, vmax=1, cmap="viridis")
    axes[0].set_title(f"grid labels (t={it})")
    plt.colorbar(sc, ax=axes[0])
    sc = axes[1].scatter(grid_pos[:, 0] / 1e3, grid_pos[:, 1] / 1e3,
                         c=pred_grid[:, it], s=8, vmin=0, vmax=1, cmap="viridis")
    axes[1].set_title("grid predictions")
    plt.colorbar(sc, ax=axes[1])

    # depth cross-sections (the reference's x–z panels, utils.py:1158-1190)
    sc = axes[2].scatter(grid_pos[:, 0] / 1e3, grid_pos[:, 2] / 1e3,
                         c=lbl_grid[:, it], s=8, vmin=0, vmax=1, cmap="viridis")
    axes[2].set_title("labels x-z")
    axes[2].set_xlabel("x (km)")
    axes[2].set_ylabel("z (km)")
    sc = axes[3].scatter(grid_pos[:, 0] / 1e3, grid_pos[:, 2] / 1e3,
                         c=pred_grid[:, it], s=8, vmin=0, vmax=1, cmap="viridis")
    axes[3].set_title("predictions x-z")

    i = 4
    if x_query is not None:
        sc = axes[i].scatter(x_query[:, 0] / 1e3, x_query[:, 1] / 1e3,
                             c=lbl_query[:, it], s=4, vmin=0, vmax=1)
        axes[i].set_title("query labels")
        sc = axes[i + 1].scatter(x_query[:, 0] / 1e3, x_query[:, 1] / 1e3,
                                 c=pred_query[:, it], s=4, vmin=0, vmax=1)
        axes[i + 1].set_title("query predictions")
        i += 2
    if arv_p is not None:
        axes[i].imshow(arv_p, aspect="auto", vmin=0, vmax=1, cmap="magma")
        axes[i].set_title("P association scores")
        if lbl_p is not None:
            axes[i].contour(lbl_p, levels=[0.5], colors="c", linewidths=0.5)

    for ax in axes[:2]:
        ax.set_xlabel("x (km)")
        ax.set_ylabel("y (km)")
    fig.tight_layout()
    out = Path(out_path)
    out.mkdir(parents=True, exist_ok=True)
    fig.savefig(out / f"predictions_step_{step}.png", dpi=110)
    plt.close(fig)
    return out / f"predictions_step_{step}.png"


def plot_catalog_day(out_file, det, usgs=None, det_mags=None, usgs_mags=None,
                     title=""):
    """Day-catalog diagnostic: map view + depth cross-section of detections
    vs the reference catalog, plus the origin-time timeline (the catalog-
    level counterpart of the reference's map/cross-section panels,
    utils.py:1118-1225). ``det``/``usgs``: (n, 4) Cartesian x,y,z + t."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    det = np.asarray(det).reshape(-1, 4)
    fig, axes = plt.subplots(1, 3, figsize=(15, 4.5))
    axes[0].scatter(det[:, 0] / 1e3, det[:, 1] / 1e3, s=14, c="tab:red",
                    label=f"detected ({len(det)})", alpha=0.75)
    axes[1].scatter(det[:, 0] / 1e3, det[:, 2] / 1e3, s=14, c="tab:red",
                    alpha=0.75)
    sizes = (np.clip(np.asarray(det_mags, float), 0.5, 6) * 10
             if det_mags is not None else 12)
    axes[2].scatter(det[:, 3] / 3600.0, np.zeros(len(det)) + 1, s=sizes,
                    c="tab:red", alpha=0.75)
    if usgs is not None and len(usgs):
        usgs = np.asarray(usgs).reshape(-1, 4)
        axes[0].scatter(usgs[:, 0] / 1e3, usgs[:, 1] / 1e3, s=30,
                        facecolors="none", edgecolors="k",
                        label=f"USGS M>1 ({len(usgs)})")
        axes[1].scatter(usgs[:, 0] / 1e3, usgs[:, 2] / 1e3, s=30,
                        facecolors="none", edgecolors="k")
        us = (np.clip(np.asarray(usgs_mags, float), 0.5, 6) * 10
              if usgs_mags is not None else 24)
        axes[2].scatter(usgs[:, 3] / 3600.0, np.zeros(len(usgs)), s=us,
                        facecolors="none", edgecolors="k")
    axes[0].set_xlabel("x (km)")
    axes[0].set_ylabel("y (km)")
    axes[0].legend(loc="upper right", fontsize=8)
    axes[0].set_title(title or "map view")
    axes[1].set_xlabel("x (km)")
    axes[1].set_ylabel("z (km)")
    axes[1].set_title("depth section")
    axes[2].set_xlabel("hour of day")
    axes[2].set_yticks([0, 1], ["USGS", "det"])
    axes[2].set_ylim(-0.5, 1.5)
    axes[2].set_title("origin times")
    fig.tight_layout()
    out = Path(out_file)
    out.parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(out, dpi=110)
    plt.close(fig)
    return out
