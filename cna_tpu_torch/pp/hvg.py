"""Highly-variable-gene selection (the scanpy recipe upstream of PCA).

The reference assumes preprocessing happened in scanpy before its
library boundary.  Real atlases enter as sparse cells x 20k-gene count
matrices; the standard pipeline (``sc.pp.highly_variable_genes``,
Seurat-dispersion flavor) reduces to ~2k informative genes before PCA.
This makes that step in-framework so a sparse h5ad can run
``select_hvg -> pca -> neighbors -> association`` end to end without
materializing a dense X on the host.

The TPU package's ``pp/hvg.py``, with the per-gene moments streamed
through the device: row chunks of X go to the device, are densified
there, and their sums and sums of squares accumulate in float64 (a dense
column sum has a fixed order, so the result does not change from run to
run).  Everything after the moments (dispersion, mean-quantile bins,
z-scores, the top ``n_top``) is the TPU package's numpy, unchanged.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import config
from ..utils.profiling import global_profiler
from ..utils.transfer import fetch

# elements of one densified float64 chunk on the device (512 MiB)
_CHUNK_ELEMS = 1 << 26


def _gene_moments(x):
    """Per-gene (mean, var) of a scipy sparse or dense (N, G) matrix: row
    chunks densified on the device, float64 sums."""
    import scipy.sparse as sp

    n, g = x.shape
    dev = config.device()
    chunk_rows = max(1, _CHUNK_ELEMS // max(g, 1))
    s = torch.zeros(g, dtype=torch.float64, device=dev)
    ss = torch.zeros(g, dtype=torch.float64, device=dev)
    if sp.issparse(x):
        x = sp.csr_matrix(x)
    for lo in range(0, n, chunk_rows):
        blk = x[lo:lo + chunk_rows]
        if sp.issparse(blk):
            rows = blk.shape[0]
            dense = torch.zeros((rows, g), dtype=torch.float64, device=dev)
            counts = torch.as_tensor(np.diff(blk.indptr), device=dev)
            r = torch.repeat_interleave(
                torch.arange(rows, device=dev), counts)
            c = torch.as_tensor(blk.indices, device=dev).long()
            dense[r, c] = torch.as_tensor(blk.data, device=dev).double()
        else:
            dense = torch.as_tensor(np.asarray(blk), device=dev).double()
        s += dense.sum(dim=0)
        ss += (dense * dense).sum(dim=0)
    s, ss = fetch(s), fetch(ss)
    mean = s / n
    var = (ss - n * mean * mean) / max(n - 1, 1)
    return mean, np.maximum(var, 0.0)


def select_hvg(data, n_top=2000, n_bins=20, subset=True,
               key_added="highly_variable"):
    """Flag (and by default subset to) the ``n_top`` most variable genes.

    Seurat-flavor dispersion: ``disp = var / mean`` per gene, z-scored
    within ``n_bins`` mean-quantile bins (so lowly- and highly-expressed
    genes compete only with their peers); the top ``n_top`` by normalized
    dispersion are kept.  Writes a boolean ``var[key_added]`` column;
    with ``subset=True`` also slices ``X``/``var`` down to the kept
    genes (sparse X stays sparse).

    Returns the boolean keep mask over the ORIGINAL gene axis.
    """
    import scipy.sparse as sp

    if data.X is None:
        raise ValueError("data.X is required for HVG selection")
    n, g = data.X.shape
    n_top = min(n_top, g)
    with global_profiler().phase("select_hvg", cells=int(n)):
        mean, var = _gene_moments(data.X)

        with np.errstate(divide="ignore", invalid="ignore"):
            disp = np.where(mean > 0, var / np.maximum(mean, 1e-12), 0.0)

        # mean-quantile bins; z-score dispersion within each bin.  The bin
        # count adapts down so each bin keeps >= ~25 genes — z-scores
        # within tiny bins are noise (n_bins=20 is calibrated for ~20k-gene
        # panels)
        n_bins = int(np.clip(g // 25, 1, n_bins))
        order = np.argsort(mean, kind="stable")
        ranks = np.empty(g, dtype=np.int64)
        ranks[order] = np.arange(g)
        bins = np.minimum((ranks * n_bins) // g, n_bins - 1)
        norm_disp = np.zeros(g)
        for b in range(n_bins):
            sel = bins == b
            if not sel.any():
                continue
            d = disp[sel]
            sd = d.std()
            norm_disp[sel] = (d - d.mean()) / (sd if sd > 0 else 1.0)

        keep = np.zeros(g, dtype=bool)
        keep[np.argsort(norm_disp, kind="stable")[::-1][:n_top]] = True

        data.var[key_added] = keep
        if subset:
            x = data.X
            data.X = (x[:, keep].tocsr() if sp.issparse(x)
                      else np.ascontiguousarray(np.asarray(x)[:, keep]))
            data.var = data.var.loc[keep].copy()
    return keep
