"""Cell-axis reorderings of a graph (host numpy / scipy).

The degree-bucketed format (``graph.buckets``) sorts rows by degree; the
permutation is computed once at graph import on the host, everything
downstream (one-hot, diffusion state) works in the permuted order, and
results are de-permuted only at the API boundary.
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
