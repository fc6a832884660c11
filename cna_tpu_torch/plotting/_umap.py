"""UMAP overlay plots of association results (host-side matplotlib).

Reference ``plotting/_umap.py`` delegates the scatter to ``sc.pl.umap``;
here the embedding is read directly from ``data.obsm['X_umap']`` so the
framework has no scanpy dependency.  Semantics match: a gray base layer of
all cells, with FDR-passing cells overlaid on a symmetric seismic scale.

A copy of the TPU package's ``plotting/_umap.py``; matplotlib is imported
inside the functions, so that the package imports without it.
"""

from __future__ import annotations

import numpy as np
import pandas as pd


def _embedding(data, basis="X_umap"):
    if basis not in data.obsm:
        raise KeyError(
            f"data.obsm[{basis!r}] not found; compute an embedding first "
            "(e.g. cna_tpu_torch.pp.umap or import one from h5ad)")
    return np.asarray(data.obsm[basis])


def umap_ncorr(data, fdr_thresh=None, key="coef", **kwargs):
    """Overlay FDR-passing neighborhood coefficients on the UMAP.

    Mirrors reference ``umap_ncorr`` (``_umap.py:6-14``): cells with
    ``{key}_fdr <= fdr_thresh`` (default 0.1) are colored by coefficient.
    """
    if fdr_thresh is None:
        fdr_thresh = 0.1

    passed = data.obs[f"{key}_fdr"] <= fdr_thresh
    if passed.sum() == 0:
        print("no neighborhoods were significant at FDR <", fdr_thresh)

    return umap_overlay(data, passed, key, **kwargs)


def umap_overlay(data, mask, key, scatter0=None, scatter1=None, ax=None,
                 noframe=True, basis="X_umap"):
    """Gray base scatter + colored overlay of masked cells.

    Mirrors reference ``umap_overlay`` (``_umap.py:16-36``): overlay uses
    the seismic colormap with symmetric limits at the max |coefficient|.
    """
    import matplotlib.pyplot as plt

    if ax is None:
        ax = plt.gca()
    if isinstance(mask, pd.Series):
        mask = mask.to_numpy()
    mask = np.asarray(mask).astype(bool)

    xy = _embedding(data, basis)
    c = np.asarray(data.obs[key])[mask]

    scatter0_ = {"alpha": 0.8, "s": 2, "c": "lightgray"}
    scatter1_ = {
        "alpha": 0.9, "s": 8, "cmap": "seismic",
        "vmin": -np.abs(c).max() if len(c) > 0 else 0,
        "vmax": np.abs(c).max() if len(c) > 0 else 1,
    }
    scatter0_.update(scatter0 or {})
    scatter1_.update(scatter1 or {})

    ax.scatter(xy[:, 0], xy[:, 1], **scatter0_)
    if mask.any():
        pts = ax.scatter(xy[mask, 0], xy[mask, 1], c=c, **scatter1_)
        plt.colorbar(pts, ax=ax)
    ax.set_xlabel("UMAP1")
    ax.set_ylabel("UMAP2")
    if noframe:
        for spine in ax.spines.values():
            spine.set_visible(False)
        ax.set_xticks([])
        ax.set_yticks([])
    return ax
