"""Device-resident symmetric fuzzy graph with a lazy scipy-CSR face.

The TPU package's ``graph/device.py``.  The graph stays on the device end
to end:

* ``build_sym_ell`` turns the fuzzy-union edge codes
  (``pp.neighbors.fuzzy_union_device``) into a hybrid ELL + COO-overflow
  ``EllGraph`` without leaving the device.  The directed (N, k) kNN layout
  is the ELL body for the edges each row emits itself; the mirror edges
  (partner rows that must carry an edge their own kNN list lacks) are
  grouped by target row with one stable sort and written once into extra
  ELL columns, with the rare hub overrun spilling to the COO tail.
* ``DeviceConnectivities`` is what ``pp.neighbors`` stores in
  ``obsp['connectivities']``: ``tl`` consumers take the packed graph and
  the cell ``Reordering`` directly (no host work), while anything that
  expects the AnnData convention (a scipy matrix in obsp) materializes a
  CSR in the original cell order on first access.

Coordinates: on the IVF path the graph lives in the search's compact
layout order (``Reordering.perm[compact] = original``); materialization
de-permutes.

The TPU package pads the sorted edge list, the spill tail and the bucket
slices to a small grid of sizes so that nearby datasets reuse compiled
programs; nothing is compiled here, so the port keeps exact sizes.  The
matrix is the same.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import config
from ..utils.transfer import fetch, scalar
from .buckets import plan_buckets
from .ell import EllGraph

_KX_CANDS = (8, 16, 32, 64, 128)


@dataclasses.dataclass(frozen=True)
class SortedExtGraph:
    """Symmetric fuzzy graph as [uniform direct ELL] + [in-degree-
    bucketed mirror columns], built on the device.

    The directed kNN part has bounded width k, but the mirror in-degree is
    heavily hub-skewed: one global mirror width either multiplies the
    gather traffic or blows up the padded gather buffer.  Mirror entries
    are left-packed per row by construction, so rows can be degree-sorted
    and sliced into per-width buckets with no row compaction; per step the
    bucket outputs concatenate in sorted order and one (N, S) row gather
    restores compact order.

      direct_indices/weights: (N, k), neighbor ids in compact space.
      ext_indices/weights: per-bucket (N_b, K_b), rows ascending by
        mirror in-degree (ids in compact space).
      inv_pi: (N,) with y_ext_compact = y_ext_sorted[inv_pi].
      overflow_*: small COO spill for rows beyond the widest bucket.
      colsums_raw: (N,) compact order.
    """

    direct_indices: torch.Tensor
    direct_weights: torch.Tensor
    ext_indices: tuple
    ext_weights: tuple
    inv_pi: torch.Tensor
    overflow_rows: torch.Tensor
    overflow_cols: torch.Tensor
    overflow_weights: torch.Tensor
    colsums_raw: torch.Tensor

    @property
    def n_cells(self) -> int:
        return self.direct_indices.shape[0]

    @property
    def n_rows(self) -> int:
        return self.colsums_raw.shape[0]

    @property
    def max_degree(self) -> int:
        return self.direct_indices.shape[1] + max(
            (int(i.shape[1]) for i in self.ext_indices), default=0)

    @property
    def n_overflow(self) -> int:
        return self.overflow_rows.shape[0]

    @property
    def dtype(self) -> torch.dtype:
        return self.direct_weights.dtype

    @property
    def device(self) -> torch.device:
        return self.direct_weights.device

    def colsums(self, self_weight: float = 1.0):
        return self.colsums_raw + self_weight

    def padded_area(self) -> int:
        return (int(np.prod(self.direct_indices.shape))
                + sum(int(np.prod(i.shape)) for i in self.ext_indices))


def _mirror_sort(idx, w_sym, code):
    """Group mirror edges by target row with one stable sort.

    Mirror edge for (i -> j = idx[i, s]): row j must carry (j, i) with the
    symmetric weight, but j's own kNN list lacks i.  Non-mirror entries
    get the sentinel key n and sort to the tail, which is cut off.
    Returns (tgt, src, w) of the m mirror edges sorted by target (ties in
    edge-list order), m, the direct weights (N, k) and their row sums.
    """
    n, k = idx.shape
    code = code.to(torch.int32)
    mir = (code & 2) > 0
    tgt = torch.where(mir, idx, torch.full_like(idx, n)).reshape(-1)
    tgt_s, perm = torch.sort(tgt, stable=True)
    m = int(scalar(mir.sum()))
    perm = perm[:m]
    src_s = (perm // k).to(torch.int32)
    w_s = w_sym.reshape(-1)[perm]
    direct_w = torch.where((code & 1) > 0, w_sym, torch.zeros_like(w_sym))
    return tgt_s[:m], src_s, w_s, m, direct_w, direct_w.sum(dim=1)


def _runpos_and_spill(tgt_s):
    """Per-entry position within its target-row run (sorted input), and
    the spill count for each candidate mirror-column width (host ints)."""
    mlen = tgt_s.shape[0]
    ar = torch.arange(mlen, device=tgt_s.device)
    change = torch.ones(mlen, dtype=torch.bool, device=tgt_s.device)
    change[1:] = tgt_s[1:] != tgt_s[:-1]
    run_start = torch.cummax(torch.where(change, ar, 0), dim=0).values
    pos = ar - run_start
    cands = torch.as_tensor(_KX_CANDS, device=tgt_s.device)
    spills = (pos[None, :] >= cands[:, None]).sum(dim=1)
    return pos, [int(v) for v in fetch(spills)]


def _empty_overflow(dtype, device):
    ids = torch.zeros((0,), dtype=torch.int32, device=device)
    return ids, ids.clone(), torch.zeros((0,), dtype=dtype, device=device)


def build_sym_ell(idx_dev, w_sym, code, dtype=None,
                  max_spill_frac=0.02, ell_max_kx=16):
    """Symmetric fuzzy-union graph, built on the device.

    idx_dev: (N, k) int32 kNN lists (self first); row coordinates and
        neighbor values in the same coordinate system.
    w_sym / code: the aligned symmetric weights and emission codes from
        ``fuzzy_union_device`` (bit 0: row owns the entry; bit 1: row
        must also mirror it to the partner).

    Returns an ``EllGraph`` (direct + mirror columns concatenated) when a
    narrow mirror width (<= ``ell_max_kx``, spill <= ``max_spill_frac`` of
    the mirror edges) suffices, else a ``SortedExtGraph`` whose mirror
    columns are in-degree-bucketed (hub-skewed graphs; see the class
    docstring).  The COO tail is applied with ``index_add_`` (atomics on
    cuda), so the width rules keep it small.
    """
    n, k = idx_dev.shape
    dev = idx_dev.device
    idx_dev = idx_dev.to(torch.int32)
    tgt_s, src_s, w_s, m, direct_w, direct_sums = _mirror_sort(
        idx_dev, w_sym, code)
    if dtype is None:
        dtype = config.default_float()
    if m == 0:
        return EllGraph(idx_dev, direct_w.to(dtype),
                        *_empty_overflow(dtype, dev),
                        colsums_raw=direct_sums.to(dtype))

    pos, spills = _runpos_and_spill(tgt_s)
    kx, spill = _KX_CANDS[-1], spills[-1]
    for cand, sp_count in zip(_KX_CANDS, spills):
        if sp_count <= max_spill_frac * m:
            kx, spill = cand, sp_count
            break
    ell_shaped = kx <= ell_max_kx
    if not ell_shaped:
        # bucketed path: wide columns are nearly free, so push the spill
        # (a per-diffusion-step scatter) to about zero instead
        for cand, sp_count in zip(_KX_CANDS, spills):
            if sp_count <= max(1024, 1e-4 * m):
                kx, spill = cand, sp_count
                break

    # one write of the grouped mirror edges into (n, kx) extra columns;
    # (row, column) pairs are unique, so the write is deterministic
    tgt_l = tgt_s.long()
    fits = pos < kx
    ext_i = torch.zeros((n, kx), dtype=torch.int32, device=dev)
    ext_w = torch.zeros((n, kx), dtype=w_s.dtype, device=dev)
    ext_i[tgt_l[fits], pos[fits]] = src_s[fits]
    ext_w[tgt_l[fits], pos[fits]] = w_s[fits]
    colsums = (direct_sums + ext_w.sum(dim=1)).to(dtype)

    if spill:
        over = ~fits
        rows, wts = tgt_s[over].to(torch.int32), w_s[over].to(dtype)
        colsums = colsums.index_add(0, rows.long(), wts)
        overflow = (rows, src_s[over], wts)
    else:
        overflow = _empty_overflow(dtype, dev)

    if ell_shaped:
        return EllGraph(
            indices=torch.cat([idx_dev, ext_i], dim=1),
            weights=torch.cat([direct_w, ext_w], dim=1).to(dtype),
            overflow_rows=overflow[0], overflow_cols=overflow[1],
            overflow_weights=overflow[2], colsums_raw=colsums)

    # --- in-degree-bucketed mirror columns ---
    indeg = fetch((ext_w > 0).sum(dim=1))
    pi = np.argsort(indeg, kind="stable")
    plan = plan_buckets(indeg[pi], max_buckets=4, pad_to=8)
    pi_dev = torch.as_tensor(pi, device=dev)
    ext_i_s = ext_i[pi_dev]
    ext_w_s = ext_w[pi_dev].to(dtype)
    buckets_i, buckets_w = [], []
    for start, end, width in plan:
        width = min(int(width), kx)
        buckets_i.append(ext_i_s[start:end, :width].contiguous())
        buckets_w.append(ext_w_s[start:end, :width].contiguous())
    inv_pi = np.empty(n, np.int64)
    inv_pi[pi] = np.arange(n)
    return SortedExtGraph(
        direct_indices=idx_dev, direct_weights=direct_w.to(dtype),
        ext_indices=tuple(buckets_i), ext_weights=tuple(buckets_w),
        inv_pi=torch.as_tensor(inv_pi, device=dev),
        overflow_rows=overflow[0], overflow_cols=overflow[1],
        overflow_weights=overflow[2], colsums_raw=colsums)


class _LazyCsr:
    """scipy-style access for a lazy face: anything beyond the face's own
    attributes materializes the host CSR (``tocsr``) and delegates."""

    def toarray(self):
        return self.tocsr().toarray()

    def __getitem__(self, key):
        return self.tocsr()[key]

    def __getattr__(self, name):
        # only called for attributes not found on self
        if name.startswith("_"):
            raise AttributeError(name)
        return getattr(self.tocsr(), name)


class DeviceConnectivities(_LazyCsr):
    """``obsp['connectivities']`` face of a device-resident graph.

    ``tl`` consumers (``get_device_graph``) use ``.ell`` / ``.ordering``
    directly; scipy-style access (``tocsr``, slicing, ``.shape``, any CSR
    attribute) materializes a host CSR in the original cell
    order once and delegates thereafter.
    """

    def __init__(self, ell, ordering, n: int):
        """``ordering=None`` means the graph is already in the caller's
        cell order: consumers skip the permutation machinery."""
        self.ell = ell
        self.ordering = ordering
        self._n = n
        self._csr = None

    @property
    def shape(self):
        return (self._n, self._n)

    @property
    def dtype(self):
        return np.dtype("float64" if self.ell.dtype == torch.float64
                        else "float32")

    def content_digest(self):
        """Cheap device-side content summary for fingerprinting, without
        materializing or pulling the (N, K) arrays (a summary, not a
        cryptographic content hash)."""
        if isinstance(self.ell, SortedExtGraph):
            w, i = self.ell.direct_weights, self.ell.direct_indices
        else:
            w, i = self.ell.weights, self.ell.indices
        i = i.to(w.dtype)
        sums = torch.stack([
            w.sum(), (w * w).sum(), (i * w).sum(),
            (w > 0).sum().to(w.dtype), self.ell.colsums_raw.sum()])
        perm_bytes = (np.ascontiguousarray(self.ordering.perm).tobytes()
                      if self.ordering is not None else b"identity")
        return [fetch(sums).tobytes(), perm_bytes,
                repr((self.shape, self.ell.max_degree,
                      self.ell.n_overflow)).encode()]

    def edges(self):
        """(rows, cols, weights) of every stored edge, on the graph's
        device, in the original cell order (rows and cols int64, in no
        particular order; an edge stored twice appears twice)."""
        ell = self.ell
        dev = ell.device
        parts = []  # (rows_compact, cols_compact, vals)

        def add(rows, idx, w):
            keep = w > 0
            parts.append((rows.expand(idx.shape)[keep], idx[keep].long(),
                          w[keep]))

        rows_all = torch.arange(self._n, device=dev)[:, None]
        if isinstance(ell, SortedExtGraph):
            add(rows_all, ell.direct_indices, ell.direct_weights)
            # a graph carried over from the TPU package may hold padded,
            # overlapping bucket slices: concat positions may exceed n; -1
            # marks positions whose row is canonical elsewhere, and their
            # copies drop
            total = sum(int(b.shape[0]) for b in ell.ext_indices)
            pi = torch.full((total,), -1, dtype=torch.int64, device=dev)
            pi[ell.inv_pi.long()] = torch.arange(self._n, device=dev)
            start = 0
            for bi, bw in zip(ell.ext_indices, ell.ext_weights):
                if bi.numel():
                    rr = pi[start:start + bi.shape[0], None]
                    add(rr, bi, torch.where(rr >= 0, bw, 0))
                start += bi.shape[0]
        else:
            add(rows_all, ell.indices, ell.weights)
        if ell.n_overflow:
            add(ell.overflow_rows.long(), ell.overflow_cols,
                ell.overflow_weights)
        r, c, v = (torch.cat([p[i] for p in parts]) for i in range(3))
        if self.ordering is not None:  # perm[compact] = original
            perm = torch.as_tensor(self.ordering.perm, device=dev).long()
            r, c = perm[r], perm[c]
        return r, c, v

    def tocsr(self):
        if self._csr is None:
            import scipy.sparse as sp

            r, c, v = (fetch(t) for t in self.edges())
            csr = sp.csr_matrix((v, (r, c)), shape=self.shape)
            csr.sum_duplicates()
            self._csr = csr
        return self._csr

    def __repr__(self):
        state = "materialized" if self._csr is not None else "device"
        return (f"<DeviceConnectivities {self._n}x{self._n}, "
                f"ELL width {self.ell.max_degree}, "
                f"{self.ell.n_overflow} overflow edges, {state}>")


class LazyDistances(_LazyCsr):
    """``obsp['distances']`` face: directed kNN distances, materialized as
    a host CSR (original cell order, self column dropped) on first
    scipy-style access, off the graph build's critical path."""

    def __init__(self, idx_dev, d_dev, order: np.ndarray):
        self._idx = idx_dev
        self._d = d_dev
        self._order = order
        self._csr = None

    @property
    def shape(self):
        n = len(self._order)
        return (n, n)

    def tocsr(self):
        if self._csr is None:
            import scipy.sparse as sp

            idx = fetch(self._idx)[:, 1:]
            d = fetch(self._d)[:, 1:]
            perm = self._order
            rows = np.broadcast_to(perm[:, None], idx.shape).ravel()
            cols = perm[idx].ravel()
            csr = sp.csr_matrix((d.ravel(), (rows, cols)), shape=self.shape)
            csr.sort_indices()
            self._csr = csr
        return self._csr
