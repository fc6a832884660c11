"""Sparse(graph) x dense SpMM for random-walk diffusion.

The reference's compiled hot path is one line of scipy CSR matvec
(``_nam.py:33``: ``a.dot(s/colsums) + self_weight*s/colsums``).  Here the
graph lives in hybrid ELL + COO-overflow form (``graph.ell``), in
degree-sorted ELL buckets (``graph.buckets``) or, built on the device, as
a direct ELL plus in-degree-bucketed mirror columns (``graph.device``):
the bulk of edges sit in
padded neighbour lists, so SpMM is a row gather plus a small contraction;
hub-row overflow edges are applied with ``index_add_``, which on CUDA
uses atomics, so the COO tail is not bit-repeatable from run to run.
The opt-in locality formats are dense tiles (``graph.blocks``:
``block_spmm``, batched matmuls summed by ``index_add_``) and the banded
format (``ops.spmm_banded``, whose in-band product is the hand-written
CUDA kernel).

On the TPU all but the banded kernel were XLA programs, not Pallas
kernels; here they are plain torch gather + einsum (ROADMAP: a
hand-written gather SpMM waits until the port's benchmark shows where the
time goes).
"""

from __future__ import annotations

import torch

from ..graph.blocks import BlockGraph, HybridGraph
from ..graph.buckets import BucketEllGraph
from ..graph.device import SortedExtGraph
from ..graph.ell import EllGraph


def ell_spmm(indices, weights, x, block_rows: int | None = None):
    """Compute ``y[i] = sum_k weights[i, k] * x[indices[i, k]]``.

    Args:
      indices: int32 (N, K) neighbor row ids; padded entries may point
        anywhere (weight must be 0 there).
      weights: (N, K) edge weights, 0 at padding.
      x: (N, S) dense right-hand side.
      block_rows: if given, process rows in chunks of this size to bound
        the (block_rows, K, S) gather buffer.

    Returns: (N, S) dense result.
    """
    n = indices.shape[0]
    if block_rows is None or block_rows >= n:
        return _ell_spmm_block(indices, weights, x)
    return torch.cat([
        _ell_spmm_block(indices[lo:lo + block_rows],
                        weights[lo:lo + block_rows], x)
        for lo in range(0, n, block_rows)])


def _ell_spmm_block(indices, weights, x):
    gathered = x[indices.long()]  # (N, K, S)
    return torch.einsum("nk,nks->ns", weights, gathered)


def coo_spmm_add(out, rows, cols, weights, x):
    """Scatter-add COO edges in place: ``out[rows] += weights * x[cols]``.

    Padding edges must have weight 0 (they then contribute nothing
    regardless of their row/col).  Used for the hub-row overflow tail.
    Returns ``out``.
    """
    if rows.shape[0] == 0:
        return out
    contrib = weights[:, None] * x[cols.long()]  # (M, S)
    return out.index_add_(0, rows.long(), contrib)


def graph_spmm(graph: EllGraph, x, block_rows: int | None = None):
    """Full hybrid SpMM: ELL bulk + COO overflow (``y = A @ x``)."""
    y = ell_spmm(graph.indices, graph.weights, x, block_rows=block_rows)
    return coo_spmm_add(
        y, graph.overflow_rows, graph.overflow_cols, graph.overflow_weights, x
    )


def _auto_block(n, k, s, budget=1 << 28):
    """Row-block size bounding the (block, K, S) gather buffer."""
    per_row = max(k * s, 1)
    if n * per_row <= budget:
        return None
    return max(1024, budget // per_row)


def bucket_spmm(graph: BucketEllGraph, x):
    """Degree-bucketed SpMM: per-bucket gather+einsum, concatenated.

    ``graph``'s rows are degree-sorted; each bucket is padded only to its
    own width, so the gathered slots are ~nnz instead of N*K_p98
    (scatter-free: hub rows live in a small wide bucket).
    """
    return _bucket_outputs(graph.indices, graph.weights, x)


def _bucket_outputs(indices, weights, x):
    """Per-bucket gather+einsum outputs, concatenated in bucket order."""
    outs = []
    for idx, w in zip(indices, weights):
        nb, kb = idx.shape
        if kb == 0 or nb == 0:
            outs.append(x.new_zeros((nb, x.shape[1])))
        else:
            outs.append(ell_spmm(idx, w, x,
                                 block_rows=_auto_block(nb, kb, x.shape[1])))
    return torch.cat(outs, dim=0)


def sorted_ext_spmm(graph: SortedExtGraph, x):
    """SpMM of a ``graph.device.SortedExtGraph``: uniform direct ELL +
    in-degree-bucketed mirror columns + a small COO spill.

    The bucket outputs are produced in mirror-degree-sorted row order and
    restored to compact order with one (N, S) row gather; the only scatter
    is the spill, capped at about 1e-4 of the mirror edges at build time.
    """
    y = ell_spmm(graph.direct_indices, graph.direct_weights, x,
                 block_rows=_auto_block(*graph.direct_indices.shape,
                                        x.shape[1]))
    if graph.ext_indices:
        y = y + _bucket_outputs(graph.ext_indices, graph.ext_weights,
                                x)[graph.inv_pi.long()]
    return coo_spmm_add(y, graph.overflow_rows, graph.overflow_cols,
                        graph.overflow_weights, x)


def block_spmm(graph, x, pair_chunk: int = 2048):
    """Block-dense SpMM: ``y = A @ x`` from (P, B, B) dense tiles.

    Per pair p: ``y[rows[p]] += tiles[p] @ x[cols[p]]``: a contiguous
    block gather, a batched matmul (``torch.bmm``, full float32) and a
    sum by row block (``index_add_``, atomics on CUDA).  Pairs are
    processed in chunks of ``pair_chunk`` to bound the gathered buffer.
    ``x`` has ``graph.n_rows`` (padded) rows.
    """
    b = graph.block_size
    xb = x.reshape(-1, b, x.shape[1])
    out = torch.zeros_like(xb)
    rows, cols = graph.pair_rows.long(), graph.pair_cols.long()
    for lo in range(0, graph.n_pairs, pair_chunk):
        hi = lo + pair_chunk
        prod = torch.bmm(graph.tiles[lo:hi], xb[cols[lo:hi]])
        out.index_add_(0, rows[lo:hi], prod)
    return out.reshape(x.shape)


def diffusion_step(s, graph, colsums, self_weight, block_rows=None):
    """One lazy-random-walk diffusion step (format-dispatched).

    Reference ``diffuse_stepwise`` body (``_nam.py:28,33``):
    ``colsums = a.sum(axis=0) + self_weight`` and
    ``s' = a @ (s/colsums) + self_weight * s/colsums``.
    """
    from .spmm_banded import BandedGraph, banded_spmm  # imports this module

    t = s / colsums[:, None]
    if isinstance(graph, SortedExtGraph):
        return sorted_ext_spmm(graph, t) + self_weight * t
    if isinstance(graph, BucketEllGraph):
        return bucket_spmm(graph, t) + self_weight * t
    if isinstance(graph, BandedGraph):
        return banded_spmm(graph, t) + self_weight * t
    if isinstance(graph, HybridGraph):
        return (block_spmm(graph.block, t) + graph_spmm(graph.ell, t)
                + self_weight * t)
    if isinstance(graph, BlockGraph):
        return block_spmm(graph, t) + self_weight * t
    if isinstance(graph, EllGraph):
        return graph_spmm(graph, t, block_rows=block_rows) + self_weight * t
    raise TypeError(f"no diffusion SpMM for {type(graph).__name__}")
