"""Degree-bucketed ELL graph: gather traffic proportional to nnz.

The plain ELL format (``graph.ell``) pads every row to one global width K
set near the 98th degree percentile, but UMAP-union kNN graphs are
heavily degree-skewed (mean degree ~22 vs K=48..64), so most gathered
slots are padding.

Fix: sort rows by degree (a ``Reordering``) and pack them into a handful
of contiguous buckets, each padded only to its own max degree.  Bucket
boundaries are chosen by exact dynamic programming over the (few dozen)
distinct padded widths to minimize total padded area with at most
``max_buckets`` segments.  Hub rows land in a tiny wide bucket, so no COO
overflow (and no scatter) is needed.  The host planning and packing are
the TPU package's, array for array.

The SpMM is a concatenation of per-bucket gather+einsum calls over the
same right-hand side (``ops.spmm.bucket_spmm``); it replaces the same
reference hot line as the other formats (``a.dot(s/colsums)`` at
reference ``_nam.py:33``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import config
from ..utils.transfer import to_device
from .ell import _np_float
from .reorder import Reordering


@dataclasses.dataclass(frozen=True)
class BucketEllGraph:
    """Degree-sorted rows packed into per-width ELL buckets.

    Attributes:
      indices: tuple of int32 (N_b, K_b) neighbor ids (in the *permuted*
        row space); padding slots point at row 0 with weight 0.
      weights: tuple of (N_b, K_b) edge weights, 0 at padding.
      colsums_raw: (N,) column sums (permuted order, no self weight).
    """

    indices: tuple
    weights: tuple
    colsums_raw: torch.Tensor

    @property
    def n_cells(self) -> int:
        return sum(i.shape[0] for i in self.indices)

    @property
    def n_rows(self) -> int:
        return self.colsums_raw.shape[0]

    @property
    def max_degree(self) -> int:
        return max((i.shape[1] for i in self.indices), default=0)

    @property
    def dtype(self) -> torch.dtype:
        return self.colsums_raw.dtype

    @property
    def device(self) -> torch.device:
        return self.colsums_raw.device

    def colsums(self, self_weight: float = 1.0):
        return self.colsums_raw + self_weight

    def padded_area(self) -> int:
        """Total gathered slots per SpMM (rows x their bucket width)."""
        return sum(i.shape[0] * i.shape[1] for i in self.indices)


def degree_ordering(a) -> Reordering:
    """Stable ascending-degree row ordering of a scipy sparse matrix."""
    import scipy.sparse as sp

    a = sp.csr_matrix(a)
    degrees = np.diff(a.indptr)
    perm = np.argsort(degrees, kind="stable")
    inv = np.empty_like(perm)
    inv[perm] = np.arange(len(perm))
    return Reordering(perm=perm, inv=inv)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def plan_buckets(sorted_degrees, max_buckets: int = 8, pad_to: int = 8,
                 per_bucket_cost: int = 4096):
    """Optimal <= ``max_buckets`` partition of ascending degrees.

    Minimizes sum over buckets of rows_b * roundup(max_degree_b, pad_to)
    (the gathered slots of the bucketed SpMM) plus a fixed
    ``per_bucket_cost`` per segment so the plan does not spend extra
    launches on negligible savings.  DP runs over distinct padded widths
    only: O(m^2 * max_buckets) for m distinct widths (a few dozen for kNN
    graphs).

    Returns a list of (row_start, row_end, width) with row_end exclusive.
    """
    d = np.asarray(sorted_degrees, dtype=np.int64)
    n = len(d)
    if n == 0:
        return []
    # zero-degree rows get a WIDTH-0 segment (free), not a pad_to-wide one
    widths = np.where(
        d > 0,
        np.maximum(_round_up(1, pad_to),
                   (((d + pad_to - 1) // pad_to) * pad_to)),
        0)
    # candidate segment ends: last row of each run of equal padded width
    ends = np.flatnonzero(np.diff(widths) != 0) + 1
    ends = np.concatenate([ends, [n]])  # exclusive end positions
    m = len(ends)
    w_at = widths[ends - 1]  # width if a segment ends here

    inf = np.int64(1) << 60
    # best[g][j] = min cost covering rows [0, ends[j]) with g+1 segments
    best = np.full((max_buckets, m), inf)
    choice = np.full((max_buckets, m), -1, dtype=np.int64)
    for j in range(m):
        best[0][j] = ends[j] * w_at[j]
    for g in range(1, max_buckets):
        for j in range(m):
            best[g][j] = best[g - 1][j]
            choice[g][j] = -1
            for i in range(j):
                c = (best[g - 1][i] + (ends[j] - ends[i]) * w_at[j]
                     + per_bucket_cost)
                if c < best[g][j]:
                    best[g][j] = c
                    choice[g][j] = i
    # walk back from (max_buckets-1, m-1); choice == -1 means this level
    # inherited the (g-1)-segment solution, so descend a level in place
    bounds = [n]
    g, j = max_buckets - 1, m - 1
    while g > 0:
        i = int(choice[g][j])
        if i < 0:
            g -= 1
            continue
        bounds.append(int(ends[i]))
        j = i
        g -= 1
    bounds.append(0)
    bounds = sorted(set(bounds))
    return [(bounds[i], bounds[i + 1], int(widths[bounds[i + 1] - 1]))
            for i in range(len(bounds) - 1)]


def _pack_buckets_host(a, dtype=None, max_buckets: int = 8,
                       pad_to: int = 8):
    """Host pack of a degree-sorted scipy matrix: (indices list, weights
    list, colsums), numpy."""
    import scipy.sparse as sp

    dtype = _np_float(dtype)
    a = sp.csr_matrix(a)
    a.sort_indices()
    degrees = np.diff(a.indptr)
    if np.any(np.diff(degrees) < 0):
        raise ValueError("rows must be in ascending-degree order; apply "
                         "degree_ordering first")
    colsums = np.asarray(a.sum(axis=0)).ravel().astype(dtype)
    plan = plan_buckets(degrees, max_buckets=max_buckets, pad_to=pad_to)

    indices, weights = [], []
    for start, end, width in plan:
        nb = end - start
        idx = np.zeros((nb, width), dtype=np.int32)
        w = np.zeros((nb, width), dtype=dtype)
        # flat scatter: row r of the bucket has degrees[start+r] edges
        degs = degrees[start:end]
        lo, hi = a.indptr[start], a.indptr[end]
        rows = np.repeat(np.arange(nb), degs)
        slots = np.arange(hi - lo) - np.repeat(a.indptr[start:end] - lo, degs)
        idx[rows, slots] = a.indices[lo:hi]
        w[rows, slots] = a.data[lo:hi]
        indices.append(idx)
        weights.append(w)
    return indices, weights, colsums


def from_scipy_buckets(a, dtype=None, max_buckets: int = 8,
                       pad_to: int = 8, device=None) -> BucketEllGraph:
    """Pack an (already degree-sorted) scipy sparse matrix into buckets.

    ``a``'s rows must be in ascending-degree order (apply
    ``degree_ordering`` + ``reorder.permute_graph`` first); column sums
    are taken from ``a`` exactly, as at reference ``_nam.py:28``.
    """
    indices, weights, colsums = _pack_buckets_host(
        a, dtype=dtype, max_buckets=max_buckets, pad_to=pad_to)
    return from_bucket_arrays(indices, weights, colsums, device=device)


def from_bucket_arrays(indices, weights, colsums_raw,
                       device=None) -> BucketEllGraph:
    """A ``BucketEllGraph`` from per-bucket host arrays or tensors."""
    dev = config.device() if device is None else torch.device(device)
    return BucketEllGraph(
        indices=tuple(to_device(i, dev, torch.int32) for i in indices),
        weights=tuple(to_device(w, dev) for w in weights),
        colsums_raw=to_device(colsums_raw, dev))
