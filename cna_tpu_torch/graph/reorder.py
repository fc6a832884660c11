"""Cell-axis reorderings of a graph (host numpy / scipy).

The degree-bucketed format (``graph.buckets``) sorts rows by degree; the
locality formats ('banded', 'block', 'hybrid') order cells so that each
row's neighbours fall into a narrow index band (``graph.blocks
.cluster_ordering`` on an embedding, or reverse Cuthill-McKee on the
graph itself).  The permutation is computed once at graph import on the
host, everything downstream (one-hot, diffusion state) works in the
permuted order, and results are de-permuted only at the API boundary.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class Reordering:
    """A cell-axis permutation: ``perm[new] = old`` and its inverse."""

    perm: np.ndarray
    inv: np.ndarray

    @property
    def n(self) -> int:
        return len(self.perm)


def permute_graph(a, ordering: Reordering):
    """Apply an ordering to both axes of a sparse matrix."""
    return a[ordering.perm][:, ordering.perm].tocsr()


def rcm_ordering(a) -> Reordering:
    """Reverse-Cuthill-McKee ordering of a symmetric sparse graph."""
    import scipy.sparse as sp
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    a = sp.csr_matrix(a)
    perm = np.asarray(reverse_cuthill_mckee(a, symmetric_mode=True))
    inv = np.empty_like(perm)
    inv[perm] = np.arange(len(perm))
    return Reordering(perm=perm, inv=inv)


def permute_graph_unsorted(a, ordering: Reordering):
    """Both-axes permutation without re-sorting column indices.

    scipy's ``a[perm][:, perm]`` pays a per-row column sort; consumers
    that only need the row structure and remapped column ids can skip
    it: the row permutation is an indptr gather, the column remap a
    single fancy index.  The result has ``sorted_indices == False``.
    """
    import scipy.sparse as sp

    a = sp.csr_matrix(a)[ordering.perm]
    a.indices = ordering.inv.astype(a.indices.dtype)[a.indices]
    return a


def bandwidth_profile(a, percentile=99.0):
    """(max |i-j| over edges, percentile of per-edge band distance)."""
    import scipy.sparse as sp

    coo = sp.coo_matrix(a)
    d = np.abs(coo.row - coo.col)
    if len(d) == 0:
        return 0, 0
    return int(d.max()), int(np.percentile(d, percentile))
