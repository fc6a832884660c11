"""Graphs carried across from the TPU package as numpy arrays.

CNA has no learned parameters; the state that crosses between the two
packages is the packed graph.  ``graph_from_numpy`` turns the fields of
the TPU package's ``EllGraph`` or ``BucketEllGraph`` (pulled to numpy)
into the port's, so both packages can diffuse the very same packed graph.
"""

from __future__ import annotations

from ..graph.buckets import BucketEllGraph, from_bucket_arrays
from ..graph.ell import EllGraph, from_arrays


def graph_from_numpy(indices, weights, colsums_raw, overflow_rows=None,
                     overflow_cols=None, overflow_weights=None,
                     device=None) -> EllGraph | BucketEllGraph:
    """The port's graph from packed numpy fields.

    ``indices`` / ``weights`` as single (N, K) arrays give an
    ``EllGraph`` (with the optional COO overflow); as sequences of
    per-bucket (N_b, K_b) arrays they give a ``BucketEllGraph``, which
    has no overflow.
    """
    if isinstance(indices, (tuple, list)):
        if overflow_rows is not None:
            raise ValueError("a bucketed graph has no COO overflow")
        return from_bucket_arrays(indices, weights, colsums_raw,
                                  device=device)
    return from_arrays(indices, weights, colsums_raw, overflow_rows,
                       overflow_cols, overflow_weights, device=device)
