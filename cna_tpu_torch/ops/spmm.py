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
kernels.  Here the row gather is the hand-written CUDA kernel of
``csrc/gather_spmm.cu`` (built by ``nvcc`` at first use) for a CUDA
tensor: ``ell_spmm`` and ``sorted_ext_spmm`` launch it once, and
``diffusion_step`` of a ``SortedExtGraph`` or an ``EllGraph`` launches it
once a step with the division by the column sums and the self term fused
in, so that no (N, K, S) gather and no scaled state is written; only the
COO spill stays outside it.  A CPU tensor takes the plain versions
(``ell_spmm_plain``, ``diffusion_step_plain``: a gather + einsum in row
blocks), which the tests hold the kernel to.  There is no fallback from
one to the other: a CUDA tensor the kernel does not take raises.
"""

from __future__ import annotations

import ctypes

import torch

from ..graph.blocks import BlockGraph, HybridGraph
from ..graph.buckets import BucketEllGraph
from ..graph.device import SortedExtGraph
from ..graph.ell import EllGraph
from ..utils import profiling
from ..utils.checks import kernel_outputs
from . import _build

KERNEL = "gather_spmm"
MAX_BUCKETS = 4  # mirror buckets the kernel's table holds (as built)
_MAX_VECS = 16  # column vectors a lane of the kernel holds
# elements of the plain gather's (rows, K, S) buffer, about 1 GiB of float32
_GATHER_BUDGET = 1 << 28


def ell_spmm(indices, weights, x):
    """Compute ``y[i] = sum_k weights[i, k] * x[indices[i, k]]``.

    Args:
      indices: int32 (N, K) neighbor row ids; padded entries may point
        anywhere (weight must be 0 there).
      weights: (N, K) edge weights, 0 at padding.
      x: (N, S) dense right-hand side.

    Returns: (N, S) dense result.  A CUDA tensor launches the kernel (or
    raises); a CPU tensor takes ``ell_spmm_plain``.
    """
    if x.device.type == "cpu":
        return ell_spmm_plain(indices, weights, x)
    return gather_spmm(x, indices, weights)


def ell_spmm_plain(indices, weights, x):
    """Plain PyTorch ``ell_spmm`` on any device: a row gather plus an
    einsum, in row blocks whose (rows, K, S) gather buffer holds at most
    ``_GATHER_BUDGET`` elements (one row a block at the least)."""
    n, k = indices.shape
    per_row = max(k * x.shape[1], 1)
    if n * per_row <= _GATHER_BUDGET:
        return _ell_spmm_block(indices, weights, x)
    rows = max(1, _GATHER_BUDGET // per_row)
    return torch.cat([
        _ell_spmm_block(indices[lo:lo + rows], weights[lo:lo + rows], x)
        for lo in range(0, n, rows)])


def _ell_spmm_block(indices, weights, x):
    gathered = x[indices.long()]  # (N, K, S)
    return torch.einsum("nk,nks->ns", weights, gathered)


def bucket_table(indices, weights):
    """The kernel's table of mirror buckets: for each bucket the addresses
    of its ids and weights, its first position in the concatenation of
    the buckets' rows, its rows and its width, as five lists."""
    starts, pos = [], 0
    for idx in indices:
        starts.append(pos)
        pos += int(idx.shape[0])
    return ([int(i.data_ptr()) for i in indices],
            [int(w.data_ptr()) for w in weights], starts,
            [int(i.shape[0]) for i in indices],
            [int(i.shape[1]) for i in indices])


def launch_shape(s: int, itemsize: int, x_ptr: int, ldx: int):
    """(columns a vector, vectors a lane, lanes a row) of the kernel for a
    state of ``s`` columns: the widest vector of 4, 2 or 1 elements of at
    most 16 bytes that divides ``s`` and the row stride ``ldx`` and on
    whose boundaries the state starts; 32 lanes a row, or for fewer than
    32 vectors the power of two at or above them; the vectors a lane
    needs, at most 16 (wider states loop over column chunks), rounded up
    to a power of two where a vector holds more than one column."""
    vec = 1
    for v in (4, 2):
        if v * itemsize <= 16 and s % v == 0 and ldx % v == 0 \
                and x_ptr % (v * itemsize) == 0:
            vec = v
            break
    sv = s // vec
    lanes = 32 if sv >= 32 else 1 << (sv - 1).bit_length()
    nv = min(-(-sv // lanes), _MAX_VECS)
    if vec > 1:
        nv = 1 << (nv - 1).bit_length()
    return vec, nv, lanes


def _check_kernel(x, colsums, indices, weights, ext_indices, ext_weights,
                  inv_pi):
    if x.device.type != "cuda":
        raise ValueError(f"the gather SpMM kernel takes a CUDA tensor, not "
                         f"one on {x.device} (a CPU tensor takes the plain "
                         "version)")
    if x.dim() != 2 or x.shape[0] < 1 or x.shape[1] < 1:
        raise ValueError("x must be a non-empty (N, S) matrix")
    if x.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"the gather SpMM computes in float32 or float64; "
                        f"got x of {x.dtype}")
    if x.stride(1) != 1 and x.shape[1] > 1:
        raise ValueError("x's columns must be contiguous")
    mats = [("indices", indices, weights)] + [
        (f"bucket {b}", i, w)
        for b, (i, w) in enumerate(zip(ext_indices, ext_weights))]
    for name, idx, w in mats:
        if idx.dim() != 2 or idx.shape != w.shape:
            raise ValueError(f"{name}: ids and weights must share one "
                             f"(rows, K) shape; got {tuple(idx.shape)} and "
                             f"{tuple(w.shape)}")
        if idx.dtype != torch.int32:
            raise TypeError(f"{name}: ids must be int32, not {idx.dtype}")
    for name, t in ([(n, w) for n, _, w in mats]
                    + [("colsums", colsums)] * (colsums is not None)):
        if t.dtype != x.dtype:
            raise TypeError(f"{name} is {t.dtype}, x {x.dtype}")
    if colsums is not None and colsums.shape != (x.shape[0],):
        raise ValueError(f"colsums must be ({x.shape[0]},); got "
                         f"{tuple(colsums.shape)}")
    if len(ext_indices) > MAX_BUCKETS:
        raise ValueError(f"the gather SpMM takes at most {MAX_BUCKETS} "
                         f"mirror buckets; got {len(ext_indices)}")
    if ext_indices and (inv_pi is None or inv_pi.dtype != torch.int64
                        or inv_pi.shape != (indices.shape[0],)):
        raise ValueError("mirror buckets need inv_pi, int64 (N,)")
    tensors = [t for _, i, w in mats for t in (i, w)] + [
        t for t in (colsums, inv_pi) if t is not None]
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError("the graph's arrays and colsums must be "
                             "contiguous")
        if t.device != x.device:
            raise ValueError(f"a graph array is on {t.device}, x on "
                             f"{x.device}")


def gather_spmm(x, indices, weights, ext_indices=(), ext_weights=(),
                inv_pi=None, colsums=None, self_weight=None):
    """The kernel's launch: for every row i of ``indices``

    ``y[i] = sum_k w[i, k] * x[j_k] / colsums[j_k]`` over the row's direct
    slots, then its mirror slots (row ``inv_pi[i]`` of the concatenation
    of the buckets ``ext_indices`` / ``ext_weights``), then
    ``+ self_weight * x[i] / colsums[i]``.  Without ``colsums`` nothing is
    divided; without ``self_weight`` there is no self term.  ``x`` is a
    CUDA (N_x, S) float32 or float64 matrix with contiguous columns; the
    ids are int32 and the weights of ``x``'s type, all contiguous on
    ``x``'s card.  Raises on anything else; never falls back."""
    _check_kernel(x, colsums, indices, weights, ext_indices, ext_weights,
                  inv_pi)
    n_rows, kd = indices.shape
    n_x, s = x.shape
    y = torch.empty((n_rows, s), dtype=x.dtype, device=x.device)
    if n_rows == 0:
        return y
    ldx = x.stride(0)
    vec, nv, lanes = launch_shape(s, x.element_size(), x.data_ptr(), ldx)
    b_idx, b_w, b_start, b_rows, b_width = bucket_table(ext_indices,
                                                         ext_weights)
    nb = len(b_idx)

    def longs(vals):
        return (ctypes.c_longlong * max(nb, 1))(*vals)

    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.gather_spmm_launch(
            x.data_ptr(), ldx, n_x,
            None if colsums is None else colsums.data_ptr(),
            indices.data_ptr(), weights.data_ptr(), kd, nb, longs(b_idx),
            longs(b_w), longs(b_start), longs(b_rows),
            (ctypes.c_int * max(nb, 1))(*b_width),
            None if inv_pi is None else inv_pi.data_ptr(), y.data_ptr(),
            n_rows, s, vec, nv, lanes,
            0.0 if self_weight is None else float(self_weight),
            int(self_weight is not None), int(x.dtype == torch.float64),
            stream)
    if err != 0:
        raise RuntimeError(f"gather_spmm launch failed with CUDA error {err}")
    _build.count_launch(KERNEL)
    kernel_outputs(KERNEL, y)
    return y


def kernel_slots(graph):
    """The kernel's arguments after the state for a ``SortedExtGraph``
    (direct columns, mirror buckets, ``inv_pi``) or an ``EllGraph`` (its
    columns alone)."""
    if isinstance(graph, SortedExtGraph):
        return (graph.direct_indices, graph.direct_weights,
                graph.ext_indices, graph.ext_weights, graph.inv_pi)
    return graph.indices, graph.weights, (), (), None


def _lib():
    lib = _build.load(KERNEL)
    fn = lib.gather_spmm_launch
    if fn.argtypes is None:  # first use: the C ABI
        ll, i, p = ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p
        lls = ctypes.POINTER(ctypes.c_longlong)
        fn.restype = i
        fn.argtypes = [p, ll, ll, p, p, p, i, i, lls, lls, lls, lls,
                       ctypes.POINTER(ctypes.c_int), p, p, ll, i, i, i, i,
                       ctypes.c_double, i, i, p]
    return lib


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


def graph_spmm(graph: EllGraph, x):
    """Full hybrid SpMM: ELL bulk + COO overflow (``y = A @ x``)."""
    y = ell_spmm(graph.indices, graph.weights, x)
    return coo_spmm_add(
        y, graph.overflow_rows, graph.overflow_cols, graph.overflow_weights, x
    )


def bucket_spmm(graph: BucketEllGraph, x):
    """Degree-bucketed SpMM: per-bucket gather+einsum, concatenated.

    ``graph``'s rows are degree-sorted; each bucket is padded only to its
    own width, so the gathered slots are ~nnz instead of N*K_p98
    (scatter-free: hub rows live in a small wide bucket).
    """
    return _bucket_outputs(graph.indices, graph.weights, x)


def _bucket_outputs(indices, weights, x, spmm=ell_spmm):
    """Per-bucket gather+einsum outputs, concatenated in bucket order."""
    outs = []
    for idx, w in zip(indices, weights):
        nb, kb = idx.shape
        if kb == 0 or nb == 0:
            outs.append(x.new_zeros((nb, x.shape[1])))
        else:
            outs.append(spmm(idx, w, x))
    return torch.cat(outs, dim=0)


def sorted_ext_spmm(graph: SortedExtGraph, x):
    """SpMM of a ``graph.device.SortedExtGraph``: uniform direct ELL +
    in-degree-bucketed mirror columns + a small COO spill.

    On the card one launch of the kernel reads a row's direct and mirror
    slots together; the plain version (a CPU tensor) produces the bucket
    outputs in mirror-degree-sorted row order and restores compact order
    with one (N, S) row gather.  The only scatter is the spill, capped at
    about 1e-4 of the mirror edges at build time.
    """
    y = (_sorted_ext_plain(graph, x) if x.device.type == "cpu"
         else gather_spmm(x, *kernel_slots(graph)))
    return coo_spmm_add(y, graph.overflow_rows, graph.overflow_cols,
                        graph.overflow_weights, x)


def _sorted_ext_plain(graph: SortedExtGraph, x):
    """Direct and mirror part of ``sorted_ext_spmm`` in plain PyTorch."""
    y = ell_spmm_plain(graph.direct_indices, graph.direct_weights, x)
    if graph.ext_indices:
        y = y + _bucket_outputs(graph.ext_indices, graph.ext_weights, x,
                                ell_spmm_plain)[graph.inv_pi.long()]
    return y


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


def diffusion_step(s, graph, colsums, self_weight):
    """One lazy-random-walk diffusion step (format-dispatched).

    Reference ``diffuse_stepwise`` body (``_nam.py:28,33``):
    ``colsums = a.sum(axis=0) + self_weight`` and
    ``s' = a @ (s/colsums) + self_weight * s/colsums``.

    A ``SortedExtGraph`` or an ``EllGraph`` with a CUDA state is one
    launch of the kernel (the division and the self term fused, the result
    written once) plus the COO spill, counted as ``spmm_kernel`` on the
    innermost open span; with a CPU state it takes
    ``diffusion_step_plain``.  The other formats scale the state first and
    take their own products.
    """
    from .spmm_banded import BandedGraph, banded_spmm  # imports this module

    if isinstance(graph, (SortedExtGraph, EllGraph)):
        if s.device.type == "cpu":
            return diffusion_step_plain(s, graph, colsums, self_weight)
        y = gather_spmm(s, *kernel_slots(graph), colsums, self_weight)
        profiling.count("spmm_kernel")
        return _coo_add_scaled(y, graph, s, colsums)
    t = s / colsums[:, None]
    if isinstance(graph, BucketEllGraph):
        return bucket_spmm(graph, t) + self_weight * t
    if isinstance(graph, BandedGraph):
        return banded_spmm(graph, t) + self_weight * t
    if isinstance(graph, HybridGraph):
        return (block_spmm(graph.block, t) + graph_spmm(graph.ell, t)
                + self_weight * t)
    if isinstance(graph, BlockGraph):
        return block_spmm(graph, t) + self_weight * t
    raise TypeError(f"no diffusion SpMM for {type(graph).__name__}")


def diffusion_step_plain(s, graph, colsums, self_weight):
    """The diffusion step of a ``SortedExtGraph`` or an ``EllGraph`` in
    plain PyTorch on any device: ``t = s / colsums``, a gather + einsum
    product of ``t`` in row blocks, the COO spill, then
    ``+ self_weight * t``.  The CPU path, and the kernel's oracle."""
    t = s / colsums[:, None]
    if isinstance(graph, SortedExtGraph):
        y = _sorted_ext_plain(graph, t)
    else:
        y = ell_spmm_plain(graph.indices, graph.weights, t)
    y = coo_spmm_add(y, graph.overflow_rows, graph.overflow_cols,
                     graph.overflow_weights, t)
    return y + self_weight * t


def _coo_add_scaled(out, graph, s, colsums):
    """The COO spill of a diffusion step on an unscaled state:
    ``out[rows] += weights * (s[cols] / colsums[cols])``, the scaled
    state gathered at the spill's columns only."""
    if graph.overflow_rows.shape[0] == 0:
        return out
    cols = graph.overflow_cols.long()
    t = s[cols] / colsums[cols][:, None]
    return out.index_add_(0, graph.overflow_rows.long(),
                          graph.overflow_weights[:, None] * t)
