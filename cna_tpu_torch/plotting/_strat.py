"""Stratified violin plots of neighborhood coefficients.

Covers the role of the reference's ``plotting/_strat.py`` (one violin of
per-cell coefficients per stratum, shaded with a diverging colormap along
the y axis) with an independent rendering design: each violin body is
drawn directly from a Gaussian KDE of the group's values as a stack of
thin horizontal quads in a single ``PolyCollection``, with each quad's
face color taken from the colormap at its height.  No clip-path/imshow
layering and no ``ax.violinplot`` — the density outline and the gradient
are produced by the same geometry.

A copy of the TPU package's ``plotting/_strat.py`` (matplotlib imported
inside the function).
"""

from __future__ import annotations

import numpy as np


def _kde_profile(values, grid):
    """Gaussian-KDE density of ``values`` evaluated on ``grid``.

    Scott's-rule bandwidth; degenerate groups (constant or singleton)
    fall back to a narrow Gaussian bump around their value so every
    stratum still renders.
    """
    values = np.asarray(values, dtype=float)
    if values.size == 0:
        return np.zeros_like(grid)
    sd = values.std()
    if values.size < 2 or sd == 0:
        span = max(grid[-1] - grid[0], 1e-12)
        bw = 0.02 * span
        return np.exp(-0.5 * ((grid - values.mean()) / bw) ** 2)
    bw = sd * values.size ** (-1.0 / 5.0)
    diff = (grid[:, None] - values[None, :]) / bw
    return np.exp(-0.5 * diff * diff).sum(axis=1) / (values.size * bw)


def violinplot(data, stratification, key="coef", ax=None, cmap="seismic",
               width=0.9, gridsize=200, **kwargs):
    """Gradient-shaded violins of ``data.obs[key]`` per stratum.

    Args:
      data: AnnData-like object whose ``.obs`` carries ``key`` (per-cell
        neighborhood coefficients from ``tl.association``) and the
        ``stratification`` column (e.g. cluster labels).
      stratification: name of the grouping column in ``data.obs``.
      key: name of the value column (default the association write-back).
      ax: matplotlib axes (default: current axes).
      cmap: colormap sampled along the value axis (shared across violins,
        so color encodes the coefficient value itself).
      width: maximum violin width in x-axis units.
      gridsize: number of density-evaluation rows per violin.
      **kwargs: forwarded to the underlying ``PolyCollection``.

    Returns the axes.
    """
    import matplotlib.pyplot as plt
    from matplotlib import colormaps
    from matplotlib.collections import PolyCollection

    if ax is None:
        ax = plt.gca()

    obs = data.obs
    levels = obs[stratification].unique()
    series = obs[key]
    finite_all = series.to_numpy(dtype=float)
    finite_all = finite_all[np.isfinite(finite_all)]
    if finite_all.size == 0:
        raise ValueError(f"data.obs[{key!r}] has no finite values to plot")
    lo, hi = float(finite_all.min()), float(finite_all.max())
    pad = 0.05 * (hi - lo or 1.0)
    grid = np.linspace(lo - pad, hi + pad, gridsize)
    y_edges = np.linspace(lo - pad, hi + pad, gridsize + 1)

    colors = colormaps.get_cmap(cmap)(np.linspace(0, 1, gridsize))

    for pos, level in enumerate(levels):
        vals = series[obs[stratification] == level].to_numpy(dtype=float)
        vals = vals[np.isfinite(vals)]
        dens = _kde_profile(vals, grid)
        peak = dens.max()
        half = (width / 2.0) * (dens / peak if peak > 0 else dens)

        # one quad per density row: x spans [pos-half, pos+half], y spans
        # the row's bin — the union of the quads IS the shaded violin
        x0, x1 = pos - half, pos + half
        yb, yt = y_edges[:-1], y_edges[1:]
        quads = np.stack(
            [
                np.stack([x0, yb], axis=1),
                np.stack([x1, yb], axis=1),
                np.stack([x1, yt], axis=1),
                np.stack([x0, yt], axis=1),
            ],
            axis=1,
        )
        visible = half > 1e-4 * width
        coll = PolyCollection(quads[visible], facecolors=colors[visible],
                              edgecolors="none", **kwargs)
        ax.add_collection(coll)

    ax.set_xlim(-0.6, len(levels) - 0.4)
    ax.set_ylim(y_edges[0], y_edges[-1])
    ax.set_ylabel("Neighborhood Coefficient")
    ax.set_xlabel(stratification)
    ax.set_xticks(np.arange(len(levels)))
    ax.set_xticklabels(levels)
    return ax
