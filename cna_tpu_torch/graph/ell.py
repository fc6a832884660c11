"""Device-resident kNN graph in hybrid ELL + COO-overflow format.

The cell-cell graph arrives as a scipy CSR (``obsp['connectivities']``)
and is packed once on the host into tensors on the compute device:

* **ELL part**: fixed-width padded neighbour lists covering the bulk of
  rows, turning SpMM into a dense gather + contraction.  kNN-union graphs
  have tightly bounded *typical* degree, so a width at the ~98th
  percentile wastes little padding;
* **COO overflow**: edges of hub rows beyond the ELL width, applied with
  a scatter-add (``index_add_``).

``colsums_raw`` is computed once at import (reference ``_nam.py:28``):
``a.sum(axis=0)``; the diffusion layer adds ``self_weight``.  The host
pack (``_pack_ell_host``) is the TPU package's, array for array.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import config
from ..utils.transfer import to_device


@dataclasses.dataclass(frozen=True)
class EllGraph:
    """Padded fixed-width sparse graph on device, with COO overflow.

    Attributes:
      indices: int32 (N, K); padded slots point at row 0 with weight 0.
      weights: (N, K) edge weights; 0 at padding.
      overflow_rows / overflow_cols: int32 (M,) COO edges beyond the ELL
        width (M = 0 for bounded-degree graphs); padding points at row 0
        with weight 0.
      overflow_weights: (M,) weights for the overflow edges.
      colsums_raw: (N,) column sums of the underlying matrix (WITHOUT any
        self-loop weight added; the diffusion layer adds ``self_weight``).
    """

    indices: torch.Tensor
    weights: torch.Tensor
    overflow_rows: torch.Tensor
    overflow_cols: torch.Tensor
    overflow_weights: torch.Tensor
    colsums_raw: torch.Tensor

    @property
    def n_cells(self) -> int:
        return self.indices.shape[0]

    @property
    def max_degree(self) -> int:
        return self.indices.shape[1]

    @property
    def n_overflow(self) -> int:
        return self.overflow_rows.shape[0]

    @property
    def n_rows(self) -> int:
        return self.colsums_raw.shape[0]

    @property
    def dtype(self) -> torch.dtype:
        return self.weights.dtype

    @property
    def device(self) -> torch.device:
        return self.weights.device

    def colsums(self, self_weight: float = 1.0):
        return self.colsums_raw + self_weight


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _np_float(dtype):
    """numpy float dtype for ``dtype`` (None: the configured default)."""
    if dtype is None:
        return np.float64 if config.x64_enabled() else np.float32
    if isinstance(dtype, torch.dtype):
        return np.float64 if dtype == torch.float64 else np.float32
    return np.dtype(dtype).type


def from_scipy(a, dtype=None, pad_to: int = 8,
               width_percentile: float = 98.0, device=None) -> EllGraph:
    """Convert a scipy sparse matrix (rows = cells) to hybrid ELL on device.

    The row structure of ``a`` drives the gather (matching ``a.dot(...)``
    semantics at reference ``_nam.py:33``); column sums are computed
    exactly from ``a`` so asymmetric inputs keep reference behavior.

    ``width_percentile`` sets the ELL width at that percentile of the
    degree distribution (rounded up to ``pad_to``); heavier rows spill
    into the COO overflow.
    """
    parts = _pack_ell_host(a, dtype=dtype, pad_to=pad_to,
                           width_percentile=width_percentile)
    return from_arrays(parts["indices"], parts["weights"], parts["colsums"],
                       parts["overflow_rows"], parts["overflow_cols"],
                       parts["overflow_weights"], device=device)


def _pack_ell_host(a, dtype=None, pad_to: int = 8,
                   width_percentile: float = 98.0) -> dict:
    """Host-side ELL+COO pack of a scipy sparse matrix (numpy arrays)."""
    import scipy.sparse as sp

    a = sp.csr_matrix(a)
    n = a.shape[0]
    degrees = np.diff(a.indptr)
    maxdeg = int(degrees.max()) if n else 0
    k = int(np.percentile(degrees, width_percentile)) if n else 0
    k = _round_up(max(k, 1), pad_to)
    if _round_up(maxdeg, pad_to) <= 2 * k:
        k = _round_up(max(maxdeg, 1), pad_to)  # overflow not worth it

    dtype = _np_float(dtype)

    # flat scatter into the padded (n, k) layout; int32 throughout and a
    # single flat index keep the one-time pack fast at ~100M-edge scale
    rows = np.repeat(np.arange(n, dtype=np.int32), degrees)
    offsets = (np.arange(a.nnz, dtype=np.int64)
               - np.repeat(a.indptr[:-1].astype(np.int64), degrees))

    in_ell = offsets < k
    indices = np.zeros(n * k, dtype=np.int32)
    weights = np.zeros(n * k, dtype=dtype)
    flat = rows[in_ell].astype(np.int64) * k + offsets[in_ell]
    indices[flat] = a.indices[in_ell]
    weights[flat] = a.data[in_ell].astype(dtype)
    indices = indices.reshape(n, k)
    weights = weights.reshape(n, k)

    ov = ~in_ell
    m = _round_up(int(ov.sum()), pad_to) if ov.any() else 0
    overflow_rows = np.zeros(m, dtype=np.int32)
    overflow_cols = np.zeros(m, dtype=np.int32)
    overflow_weights = np.zeros(m, dtype=dtype)
    if m:
        cnt = int(ov.sum())
        overflow_rows[:cnt] = rows[ov]
        overflow_cols[:cnt] = a.indices[ov]
        overflow_weights[:cnt] = a.data[ov].astype(dtype)

    colsums = np.asarray(a.sum(axis=0)).ravel().astype(dtype)
    return dict(indices=indices, weights=weights,
                overflow_rows=overflow_rows, overflow_cols=overflow_cols,
                overflow_weights=overflow_weights, colsums=colsums)


def from_arrays(indices, weights, colsums_raw, overflow_rows=None,
                overflow_cols=None, overflow_weights=None,
                device=None) -> EllGraph:
    """An ``EllGraph`` from host arrays or tensors (numpy in, tensors on
    ``device`` out; default: the configured device).  Missing overflow
    arrays mean an overflow-free graph."""
    dev = config.device() if device is None else torch.device(device)
    weights = to_device(weights, dev)

    def ids(v):
        if v is None:
            return torch.zeros((0,), dtype=torch.int32, device=dev)
        return to_device(v, dev, torch.int32)

    return EllGraph(
        indices=ids(indices),
        weights=weights,
        overflow_rows=ids(overflow_rows),
        overflow_cols=ids(overflow_cols),
        overflow_weights=(
            to_device(overflow_weights, dev)
            if overflow_weights is not None
            else torch.zeros((0,), dtype=weights.dtype, device=dev)),
        colsums_raw=to_device(colsums_raw, dev),
    )
