"""Block-dense graph formats: SpMM as batched dense matmuls.

kNN graphs are cluster-structured, so after a locality reordering most
edges fall in a small set of (row-block, col-block) pairs.  Storing those
pairs as dense B x B tiles turns diffusion into:

    gather col-blocks of the state   (contiguous B-row reads)
    batched (B x B) @ (B x S) matmul
    sum over row-blocks              (``index_add_``)

The dense tiles spend operations on zeros (a few percent density is
typical) in exchange for streaming reads.  Out-of-pattern graphs degrade
gracefully: every nonzero lands in some pair; a poor ordering just yields
more pairs (more operations and memory), never wrong results.

The host packers (numpy / scipy) are the TPU package's
(``graph/blocks.py``), array for array; the packed tensors live on the
compute device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import config
from ..utils.transfer import to_device
from .ell import EllGraph, _np_float, from_scipy
from .reorder import Reordering


@dataclasses.dataclass(frozen=True)
class BlockGraph:
    """Block-sparse dense-tile graph on device.

    Attributes:
      tiles: (P, B, B) dense edge-weight tiles; tiles[p][i, j] is the
        weight of edge (pair_rows[p]*B + i, pair_cols[p]*B + j).
      pair_rows / pair_cols: int32 (P,) block coordinates, sorted by row.
      colsums_raw: (N_padded,) exact column sums of the underlying matrix
        (0 on padding rows).
      n_cells: true (unpadded) cell count.
    """

    tiles: torch.Tensor
    pair_rows: torch.Tensor
    pair_cols: torch.Tensor
    colsums_raw: torch.Tensor
    n_cells: int

    @property
    def block_size(self) -> int:
        return self.tiles.shape[1]

    @property
    def n_blocks(self) -> int:
        return self.colsums_raw.shape[0] // self.tiles.shape[1]

    @property
    def n_pairs(self) -> int:
        return self.tiles.shape[0]

    @property
    def n_rows(self) -> int:
        return self.colsums_raw.shape[0]

    @property
    def dtype(self) -> torch.dtype:
        return self.tiles.dtype

    @property
    def device(self) -> torch.device:
        return self.tiles.device

    def colsums(self, self_weight: float = 1.0):
        return self.colsums_raw + self_weight


@dataclasses.dataclass(frozen=True)
class HybridGraph:
    """Dense tiles for heavy block pairs + ELL for stray edges.

    kNN graphs under a locality ordering put most edges into a small set
    of heavy (row-block, col-block) pairs; the rest are long-range strays
    that would explode a pure block-dense pair count.  The hybrid splits
    at an edge-coverage target: heavy pairs run as batched matmuls,
    strays through the row-gather ELL path.
    """

    block: BlockGraph
    ell: EllGraph  # the stray edges over the padded rows
    colsums_raw: torch.Tensor  # (N_padded,) of the FULL matrix
    n_cells: int

    @property
    def n_rows(self) -> int:
        return self.colsums_raw.shape[0]

    @property
    def dtype(self) -> torch.dtype:
        return self.block.tiles.dtype

    @property
    def device(self) -> torch.device:
        return self.block.tiles.device

    def colsums(self, self_weight: float = 1.0):
        return self.colsums_raw + self_weight


def cluster_ordering(embedding, block_size=256, leaf_size=None, seed=0):
    """Locality ordering of cells: recursive median bisection (kd order).

    Recursively splits along the current subset's maximum-variance
    principal direction until leaves of ~``leaf_size`` cells, emitting
    leaves in traversal order.  Cells adjacent in embedding space land
    adjacent in the ordering, concentrating kNN edges near the reordered
    diagonal.  Host numpy in float64.  Returns a ``Reordering``.
    """
    emb = np.asarray(embedding, dtype=np.float64)
    n = emb.shape[0]
    if leaf_size is None:
        leaf_size = max(block_size // 4, 32)

    perm = np.empty(n, dtype=np.int64)
    out_pos = 0
    stack = [np.arange(n)]
    while stack:
        idx = stack.pop()
        if len(idx) <= leaf_size:
            perm[out_pos : out_pos + len(idx)] = idx
            out_pos += len(idx)
            continue
        sub = emb[idx]
        center = sub.mean(axis=0)
        centered = sub - center
        # leading principal direction via a few power iterations
        rng = np.random.RandomState(seed)
        v = rng.randn(sub.shape[1])
        for _ in range(4):
            v = centered.T @ (centered @ v)
            v_norm = np.linalg.norm(v)
            if v_norm == 0:
                break
            v = v / v_norm
        proj = centered @ v
        half = len(idx) // 2
        order = np.argpartition(proj, half)
        # push right half first so the left half is emitted first
        stack.append(idx[order[half:]])
        stack.append(idx[order[:half]])
    assert out_pos == n

    inv = np.empty_like(perm)
    inv[perm] = np.arange(n)
    return Reordering(perm=perm, inv=inv)


def _pack_blocks_host(a, block_size, dtype) -> dict:
    """Host-side block pack of a scipy sparse matrix (numpy arrays)."""
    import scipy.sparse as sp

    a = sp.csr_matrix(a)
    n = a.shape[0]
    b = block_size
    n_blocks = -(-n // b)
    n_pad = n_blocks * b

    coo = a.tocoo()
    br, bc = coo.row // b, coo.col // b
    pair_key = br.astype(np.int64) * n_blocks + bc
    uniq, pair_of_edge = np.unique(pair_key, return_inverse=True)
    p = len(uniq)
    pair_rows = (uniq // n_blocks).astype(np.int32)
    pair_cols = (uniq % n_blocks).astype(np.int32)

    tiles = np.zeros((p, b, b), dtype=dtype)
    tiles[pair_of_edge, coo.row % b, coo.col % b] = coo.data.astype(dtype)

    colsums = np.zeros(n_pad, dtype=dtype)
    colsums[:n] = np.asarray(a.sum(axis=0)).ravel().astype(dtype)
    return dict(tiles=tiles, pair_rows=pair_rows, pair_cols=pair_cols,
                colsums_raw=colsums, n_cells=n)


def block_graph_from_arrays(tiles, pair_rows, pair_cols, colsums_raw,
                            n_cells, device=None) -> BlockGraph:
    """A ``BlockGraph`` from host arrays or tensors, on ``device``
    (default: the configured device)."""
    dev = config.device() if device is None else torch.device(device)
    return BlockGraph(
        tiles=to_device(tiles, dev),
        pair_rows=to_device(pair_rows, dev, torch.int32),
        pair_cols=to_device(pair_cols, dev, torch.int32),
        colsums_raw=to_device(colsums_raw, dev),
        n_cells=int(n_cells))


def from_scipy_blocks(a, block_size=256, dtype=None,
                      device=None) -> BlockGraph:
    """Convert a scipy sparse matrix (already locality-ordered) to
    block-dense tiles on device."""
    parts = _pack_blocks_host(a, block_size, _np_float(dtype))
    return block_graph_from_arrays(device=device, **parts)


def from_scipy_hybrid(a, block_size=64, coverage=0.85, dtype=None,
                      min_pair_nnz=None, device=None) -> HybridGraph:
    """Convert a locality-ordered sparse matrix to the hybrid format.

    Pairs are kept dense until ``coverage`` of edges are covered (or all
    pairs with >= ``min_pair_nnz`` edges if given); the remainder goes to
    an ELL stray graph over the same padded row space.
    """
    import scipy.sparse as sp

    a = sp.csr_matrix(a)
    n = a.shape[0]
    b = block_size
    n_blocks = -(-n // b)
    n_pad = n_blocks * b

    coo = a.tocoo()
    key = (coo.row // b).astype(np.int64) * n_blocks + coo.col // b
    uniq, pair_of_edge, counts = np.unique(key, return_inverse=True,
                                           return_counts=True)
    if min_pair_nnz is None:
        order = np.argsort(counts)[::-1]
        cum = np.cumsum(counts[order]) / max(coo.nnz, 1)
        cut = int(np.searchsorted(cum, coverage)) + 1
        min_pair_nnz = counts[order][min(cut - 1, len(order) - 1)]
    dense_pair = counts >= min_pair_nnz
    dense_edge = dense_pair[pair_of_edge]

    a_dense = sp.csr_matrix(
        (coo.data[dense_edge], (coo.row[dense_edge], coo.col[dense_edge])),
        shape=(n_pad, n_pad))
    a_stray = sp.csr_matrix(
        (coo.data[~dense_edge], (coo.row[~dense_edge], coo.col[~dense_edge])),
        shape=(n_pad, n_pad))

    block = from_scipy_blocks(a_dense, block_size=b, dtype=dtype,
                              device=device)
    ell = from_scipy(a_stray, dtype=dtype, device=device)

    np_dtype = _np_float(dtype)
    colsums = np.zeros(n_pad, dtype=np_dtype)
    colsums[:n] = np.asarray(a.sum(axis=0)).ravel().astype(np_dtype)
    return HybridGraph(block=block, ell=ell,
                       colsums_raw=to_device(colsums, block.device),
                       n_cells=n)
