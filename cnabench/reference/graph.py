"""Graph build, plainly: centred PCA by the gene covariance, exact kNN,
and umap-learn's fuzzy simplicial set (local_connectivity 1, union
``A + A^T - A o A^T``), the construction that scanpy's ``pp.neighbors``
documents and that CNA reads as ``obsp['connectivities']``.

Edge lists are (rows, cols, values) tensors; a symmetric graph is keyed
by ``row * n + col``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import Precision, mm

SMOOTH_K_TOLERANCE = 1e-5
MIN_K_DIST_SCALE = 1e-3
BISECTION_STEPS = 64


def pca(x_host: np.ndarray, n_comps: int, prec: Precision, device):
    """Scores (N, n_comps) of the centred, unscaled PCA of ``x_host``:
    the covariance ``Xc' Xc / (N-1)``, its eigenvectors by descending
    eigenvalue (``numpy.linalg.eigh`` on the host), the projection of
    ``Xc``.  Component signs are arbitrary."""
    x = torch.as_tensor(x_host, device=device).to(prec.dtype)
    xc = x - x.mean(dim=0, keepdim=True)
    del x
    cov = mm(xc.T.contiguous(), xc, prec) / (xc.shape[0] - 1)
    evals, evecs = np.linalg.eigh(cov.cpu().numpy())
    comps = np.ascontiguousarray(evecs[:, ::-1][:, :n_comps])
    return mm(xc, torch.as_tensor(comps, device=device, dtype=prec.dtype),
              prec)


def _block_rows(n, elems=1 << 27):
    return max(1, elems // max(n, 1))


def knn(scores: torch.Tensor, k: int, prec: Precision, rows=None):
    """Exact kNN (self included) of ``rows`` (all rows when None) among
    all rows of ``scores``: squared distances by the expansion
    ``|q|^2 + |x|^2 - 2 q.x`` in ``prec``, the k smallest.  Returns
    (ids (Q, k) int64, distances (Q, k)) ascending."""
    n = scores.shape[0]
    rows = (torch.arange(n, device=scores.device) if rows is None
            else torch.as_tensor(rows, device=scores.device).long())
    sq = (scores * scores).sum(dim=1)
    st = scores.T.contiguous()
    ids, dists = [], []
    step = _block_rows(n)
    for lo in range(0, rows.shape[0], step):
        q = rows[lo:lo + step]
        d2 = sq[q][:, None] + sq[None, :] - 2.0 * mm(scores[q], st, prec)
        vals, idx = torch.topk(d2, k, dim=1, largest=False, sorted=True)
        ids.append(idx)
        dists.append(torch.sqrt(torch.clamp(vals, min=0.0)))
    return torch.cat(ids), torch.cat(dists)


def pair_distances(scores: torch.Tensor, rows: torch.Tensor,
                   cols: torch.Tensor, chunk=1 << 22):
    """Direct-difference distances ``|s_r - s_c|`` of index pairs."""
    out = []
    for lo in range(0, rows.shape[0], chunk):
        diff = scores[rows[lo:lo + chunk]] - scores[cols[lo:lo + chunk]]
        out.append(torch.sqrt((diff * diff).sum(dim=1)))
    return torch.cat(out) if out else scores.new_zeros(0)


def lists_from_edges(rows, cols, n, k):
    """(N, k) neighbour lists, self in column 0, from directed edges that
    leave the self edge out (k - 1 per row)."""
    order = torch.argsort(rows * n + cols)
    rows, cols = rows[order], cols[order]
    counts = torch.bincount(rows, minlength=n)
    if bool((counts != k - 1).any()):
        raise ValueError("every row must list k - 1 neighbours besides "
                         "itself")
    lists = torch.empty((n, k), dtype=torch.int64, device=rows.device)
    lists[:, 0] = torch.arange(n, device=rows.device)
    lists[:, 1:] = cols.reshape(n, k - 1)
    return lists


def smooth_knn_dist(dists: torch.Tensor, k: int):
    """umap-learn's ``smooth_knn_dist`` with local_connectivity 1, per
    row at once: rho the smallest non-zero distance; sigma by bisection on
    ``sum_{j>=1} exp(-max(d_j - rho, 0) / sigma) = log2(k)``, a row
    stopping once within ``SMOOTH_K_TOLERANCE``; sigma floored at
    ``MIN_K_DIST_SCALE`` times the row's mean distance (the global mean
    where rho is 0).  ``dists`` (N, k) has the self distance in column
    0."""
    target = math.log2(k)
    inf = torch.full_like(dists, math.inf)
    rho = torch.where(dists > 0, dists, inf).min(dim=1).values
    rho = torch.where(torch.isfinite(rho), rho, torch.zeros_like(rho))
    shift = dists[:, 1:] - rho[:, None]
    n = dists.shape[0]
    lo = torch.zeros(n, dtype=dists.dtype, device=dists.device)
    hi = torch.full((n,), math.inf, dtype=dists.dtype, device=dists.device)
    mid = torch.ones(n, dtype=dists.dtype, device=dists.device)
    active = torch.ones(n, dtype=torch.bool, device=dists.device)
    for _ in range(BISECTION_STEPS):
        psum = torch.where(shift > 0, torch.exp(-shift / mid[:, None]),
                           torch.ones_like(shift)).sum(dim=1)
        active = active & ((psum - target).abs() >= SMOOTH_K_TOLERANCE)
        over = active & (psum > target)
        under = active & ~(psum > target)
        hi = torch.where(over, mid, hi)
        lo = torch.where(under, mid, lo)
        mid = torch.where(over, (lo + hi) / 2.0, mid)
        mid = torch.where(under & torch.isinf(hi), mid * 2.0,
                          torch.where(under, (lo + hi) / 2.0, mid))
    floor_row = MIN_K_DIST_SCALE * dists.mean(dim=1)
    floor_all = MIN_K_DIST_SCALE * dists.mean()
    sigma = torch.where(rho > 0, torch.maximum(mid, floor_row),
                        torch.maximum(mid, floor_all))
    return rho, sigma


def fuzzy_graph(lists: torch.Tensor, dists: torch.Tensor, n: int):
    """The fuzzy union of (N, k) neighbour lists (self in column 0) with
    their distances: (keys sorted int64, values)."""
    k = lists.shape[1]
    rho, sigma = smooth_knn_dist(dists, k)
    w = torch.exp(-torch.clamp(dists - rho[:, None], min=0.0)
                  / sigma[:, None])
    rows = torch.arange(n, device=lists.device)[:, None].expand_as(lists)
    w = torch.where(lists == rows, torch.zeros_like(w), w)
    r, c, w = rows.reshape(-1), lists.reshape(-1), w.reshape(-1)
    keys = torch.cat([r * n + c, c * n + r])
    zero = torch.zeros_like(w)
    a = torch.cat([w, zero])
    b = torch.cat([zero, w])
    keys, order = torch.sort(keys)
    uniq, inv = torch.unique_consecutive(keys, return_inverse=True)
    sa = torch.zeros(uniq.shape[0], dtype=w.dtype, device=w.device)
    sb = torch.zeros_like(sa)
    sa.index_add_(0, inv, a[order])
    sb.index_add_(0, inv, b[order])
    val = sa + sb - sa * sb
    keep = val > 0
    return uniq[keep], val[keep]


def edge_keys(rows, cols, vals, n):
    """Sorted (keys, values) of an edge list (duplicates summed)."""
    keys = rows.long() * n + cols.long()
    keys, order = torch.sort(keys)
    uniq, inv = torch.unique_consecutive(keys, return_inverse=True)
    out = torch.zeros(uniq.shape[0], dtype=vals.dtype, device=vals.device)
    out.index_add_(0, inv, vals[order])
    return uniq, out
