"""Banded SpMM for locality-ordered diffusion graphs: the hand-written CUDA
kernel, its plain version and the banded graph format.

Counterpart of the TPU package's ``ops/spmm_pallas.py`` (the Pallas kernel
``_banded_kernel`` at :216, launched through ``banded_spmm``; its plain
twin there is ``_banded_spmm_xla``).

When the cell ordering has metric locality (kd / RCM ordering of a
manifold-structured atlas; ``graph.blocks.cluster_ordering``,
``graph.reorder.rcm_ordering``), most edges satisfy ``|i - j| <= W``.  The
banded format exploits that instead of gathering rows from all of ``x``:
rows come in tiles of ``row_tile`` = R rows, and tile ``t`` reads only the
*slab* ``x[slab_starts[t] : slab_starts[t] + R + 2W]``.  The contract is
the TPU package's:

* ``lidx`` (N_pad, K) int32 holds neighbour indices relative to the owning
  tile's slab start; padding and out-of-band slots point at 0 with weight
  0; ``weights`` (N_pad, K) the in-band edge weights;
* ``slab_starts`` (T,) int32 is clipped to ``[0, N_pad - slab]``;
* out-of-band edges go to a spill ELL (row gather, ``ops.spmm.ell_spmm``)
  and what exceeds its width to a COO tail (``coo_spmm_add``), both
  outside the kernel;
* the in-band product accumulates in the state's own dtype at full
  precision (float32, or float64 under x64): no TF32, no bf16.

The packed fields above are the contract (equal to the TPU package's
array for array).  What the CUDA kernel reads is a form derived from them
once per graph, on the graph's device (``compact_inband``,
``BandedGraph.compact``): the non-zero slots of each row moved together in
their original order, so that the kernel touches an in-band edge once and
an empty slot never.

``banded_inband`` is the kernel's wrapper.  A CUDA tensor goes to the
kernel in ``csrc/banded_spmm.cu`` (built by ``nvcc`` at first use) or
raises; a CPU tensor goes to ``banded_spmm_plain``.  There is no fallback
from one to the other.  What bounds the kernel on an H100, and its design,
are stated at the top of ``csrc/banded_spmm.cu``.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from .. import config
from ..graph.ell import _np_float, _pack_ell_host, _round_up
from ..utils.checks import kernel_outputs
from ..utils.transfer import fetch, to_device
from . import _build
from .spmm import _auto_block, coo_spmm_add, ell_spmm

KERNEL = "banded_spmm"
SLOT_GROUP = 4  # slots to a 16-byte load of the compacted indices


@dataclasses.dataclass(frozen=True)
class BandedCompact:
    """The in-band slots of a ``BandedGraph`` without the empty ones.

    Row ``r`` owns the slots ``[row_ptr[r], row_ptr[r + 1])`` of ``lidx``
    and ``weights``: its ``row_nnz[r]`` non-zero slots in their packed
    order, then (index 0, weight 0) slots up to a multiple of
    ``SLOT_GROUP``.

    Attributes:
      row_ptr: int32 (N_pad + 1,), every entry a multiple of SLOT_GROUP.
      lidx: int32 (row_ptr[-1],) slab-local neighbour indices.
      weights: (row_ptr[-1],) edge weights, the packed graph's dtype.
      row_nnz: int32 (N_pad,) non-zero slots of each packed row.
    """

    row_ptr: torch.Tensor
    lidx: torch.Tensor
    weights: torch.Tensor
    row_nnz: torch.Tensor


def compact_inband(lidx, weights) -> BandedCompact:
    """Derive the compacted slots from the packed (N_pad, K) arrays, by
    plain torch on their device.  The order of a row's slots is kept, so a
    sum over the compacted row adds the same terms in the same order as a
    sum over the packed row, less its exact zeros."""
    n_pad = lidx.shape[0]
    dev = lidx.device
    live = weights != 0
    row_nnz = live.sum(dim=1, dtype=torch.int64)
    padded = (row_nnz + (SLOT_GROUP - 1)) // SLOT_GROUP * SLOT_GROUP
    row_ptr = torch.zeros(n_pad + 1, dtype=torch.int64, device=dev)
    torch.cumsum(padded, 0, out=row_ptr[1:])
    total = int(row_ptr[-1])
    if total >= 2 ** 31:
        raise ValueError(f"{total} compacted slots exceed the int32 row "
                         "pointer of the banded kernel")
    rows, cols = torch.nonzero(live, as_tuple=True)  # row-major: in order
    first = torch.cumsum(row_nnz, 0) - row_nnz  # a row's first edge
    dest = row_ptr[rows] + (torch.arange(rows.shape[0], device=dev)
                            - first[rows])
    c_lidx = torch.zeros(total, dtype=torch.int32, device=dev)
    c_w = torch.zeros(total, dtype=weights.dtype, device=dev)
    c_lidx[dest] = lidx[rows, cols]
    c_w[dest] = weights[rows, cols]
    return BandedCompact(row_ptr=row_ptr.to(torch.int32), lidx=c_lidx,
                         weights=c_w, row_nnz=row_nnz.to(torch.int32))


@dataclasses.dataclass(frozen=True)
class BandedGraph:
    """ELL graph with slab-local indices for the banded kernel.

    Attributes:
      lidx: int32 (N_pad, K) neighbor indices RELATIVE to the owning row
        tile's slab start; padding/out-of-band slots point at 0 with
        weight 0.
      weights: (N_pad, K) in-band edge weights.
      slab_starts: int32 (T,) absolute start row of each tile's slab.
      spill_indices/spill_weights: (N, K_spill) ELL tail of out-of-band
        edges, executed with the row-gather SpMM; per-row spill beyond
        K_spill falls through to the COO tail.
      overflow_rows/cols/weights: COO tail for the spill's own overflow.
      colsums_raw: (N,) column sums (no self weight), as in EllGraph.
      n_rows_true / row_tile / slab_rows: geometry.
      compact: the in-band slots without the empty ones, derived from
        ``lidx`` and ``weights`` (``compact_inband``); what the CUDA
        kernel reads.
    """

    lidx: torch.Tensor
    weights: torch.Tensor
    slab_starts: torch.Tensor
    spill_indices: torch.Tensor
    spill_weights: torch.Tensor
    overflow_rows: torch.Tensor
    overflow_cols: torch.Tensor
    overflow_weights: torch.Tensor
    colsums_raw: torch.Tensor
    n_rows_true: int
    row_tile: int
    slab_rows: int
    compact: BandedCompact

    @property
    def dtype(self) -> torch.dtype:
        return self.weights.dtype

    @property
    def device(self) -> torch.device:
        return self.weights.device

    @property
    def n_rows(self) -> int:
        return self.n_rows_true

    def colsums(self, self_weight: float = 1.0):
        return self.colsums_raw + self_weight

    def band_fraction(self) -> float:
        """Fraction of edges handled in-band (vs the spill/COO tails)."""
        in_band = float((self.weights != 0).sum())
        total = (in_band + float((self.spill_weights != 0).sum())
                 + float((self.overflow_weights != 0).sum()))
        return in_band / max(total, 1.0)


def banded_from_scipy(a, row_tile: int = 256, window: int = 512,
                      dtype=None, width_percentile: float = 98.0,
                      device=None) -> BandedGraph:
    """Pack a scipy sparse matrix straight into the banded format (on the
    host throughout; the packed arrays then move to ``device``)."""
    parts = _pack_ell_host(a, dtype=dtype,
                           width_percentile=width_percentile)
    return banded_from_arrays(device=device, **_banded_pack(
        parts["indices"], parts["weights"], parts["overflow_rows"],
        parts["overflow_cols"], parts["overflow_weights"], parts["colsums"],
        row_tile, window))


def banded_from_ell(graph, row_tile: int = 256, window: int = 512,
                    dtype=None) -> BandedGraph:
    """Repack an ``EllGraph`` for the banded kernel, on its device.

    Edges with slab-local index outside ``[0, row_tile + 2*window)`` move
    to the spill ELL and the COO tail (appended after the EllGraph's own
    overflow edges).
    """
    return banded_from_arrays(device=graph.device, **_banded_pack(
        fetch(graph.indices), fetch(graph.weights),
        fetch(graph.overflow_rows), fetch(graph.overflow_cols),
        fetch(graph.overflow_weights), fetch(graph.colsums_raw),
        row_tile, window,
        dtype=None if dtype is None else _np_float(dtype)))


def _banded_pack(idx, w, ell_ov_r, ell_ov_c, ell_ov_w, colsums_raw,
                 row_tile, window, dtype=None) -> dict:
    """Host-side banded pack of ELL arrays (numpy in, numpy out): the
    fields of ``BandedGraph`` by name."""
    n, k = idx.shape
    if dtype is None:
        dtype = w.dtype
    slab = row_tile + 2 * window
    n_pad = _round_up(max(n, 1), row_tile)
    t = n_pad // row_tile

    starts = np.clip(np.arange(t) * row_tile - window, 0,
                     max(n_pad - slab, 0)).astype(np.int32)
    row_tile_of = np.arange(n) // row_tile
    start_of_row = starts[row_tile_of]  # (n,)

    lidx = idx - start_of_row[:, None]
    in_band = (lidx >= 0) & (lidx < slab) & (w != 0)
    lidx = np.where(in_band, lidx, 0).astype(np.int32)
    wb = np.where(in_band, w, 0).astype(dtype)

    # out-of-band edges spill into a gather-ELL tail (width at the 98th
    # pct of per-row spill counts); the residue beyond that goes to COO
    oob = (~in_band) & (w != 0)
    counts = oob.sum(axis=1)
    if counts.any():
        k_sp = _round_up(max(int(np.percentile(counts, 98.0)), 1), 8)
        k_sp = min(k_sp, k)
        pos = np.cumsum(oob, axis=1) - 1  # spill slot within the row
        sel = oob & (pos < k_sp)
        spill_idx = np.zeros(n * k_sp, np.int32)
        spill_w = np.zeros(n * k_sp, dtype)
        sel_rows = np.nonzero(sel)[0].astype(np.int64)
        flat = sel_rows * k_sp + pos[sel]
        spill_idx[flat] = idx[sel]
        spill_w[flat] = w[sel]
        spill_idx = spill_idx.reshape(n, k_sp)
        spill_w = spill_w.reshape(n, k_sp)
        residue = oob & (pos >= k_sp)
    else:
        spill_idx = np.zeros((n, 0), np.int32)
        spill_w = np.zeros((n, 0), dtype)
        residue = oob

    rows = np.nonzero(residue)[0].astype(np.int32)
    cols = idx[residue].astype(np.int32)
    wo = w[residue].astype(dtype)
    ov_r = np.concatenate([np.asarray(ell_ov_r, np.int32), rows])
    ov_c = np.concatenate([np.asarray(ell_ov_c, np.int32), cols])
    ov_w = np.concatenate([np.asarray(ell_ov_w, dtype), wo])
    m = _round_up(len(ov_r), 8) if len(ov_r) else 0
    if m > len(ov_r):
        pad = m - len(ov_r)
        ov_r = np.pad(ov_r, (0, pad))
        ov_c = np.pad(ov_c, (0, pad))
        ov_w = np.pad(ov_w, (0, pad))

    if n_pad > n:
        lidx = np.pad(lidx, ((0, n_pad - n), (0, 0)))
        wb = np.pad(wb, ((0, n_pad - n), (0, 0)))

    return dict(
        lidx=lidx, weights=wb, slab_starts=starts,
        spill_indices=spill_idx, spill_weights=spill_w,
        overflow_rows=ov_r, overflow_cols=ov_c, overflow_weights=ov_w,
        colsums_raw=np.asarray(colsums_raw, dtype),
        n_rows_true=n, row_tile=row_tile, slab_rows=slab)


def banded_from_arrays(lidx, weights, slab_starts, spill_indices,
                       spill_weights, overflow_rows, overflow_cols,
                       overflow_weights, colsums_raw, n_rows_true, row_tile,
                       slab_rows, device=None) -> BandedGraph:
    """A ``BandedGraph`` from packed host arrays or tensors, on ``device``
    (default: the configured device), with the compacted slots derived
    there."""
    dev = config.device() if device is None else torch.device(device)

    def ids(v):
        return to_device(v, dev, torch.int32).contiguous()

    weights = to_device(weights, dev).contiguous()
    lidx = ids(lidx)
    return BandedGraph(
        lidx=lidx, weights=weights, slab_starts=ids(slab_starts),
        spill_indices=ids(spill_indices),
        spill_weights=to_device(spill_weights, dev, weights.dtype),
        overflow_rows=ids(overflow_rows), overflow_cols=ids(overflow_cols),
        overflow_weights=to_device(overflow_weights, dev, weights.dtype),
        colsums_raw=to_device(colsums_raw, dev, weights.dtype),
        n_rows_true=int(n_rows_true), row_tile=int(row_tile),
        slab_rows=int(slab_rows), compact=compact_inband(lidx, weights))


def _check(lidx, weights, slab_starts, x, row_tile, slab_rows):
    if lidx.dim() != 2 or lidx.shape != weights.shape:
        raise ValueError("banded SpMM expects lidx and weights of one "
                         f"(N_pad, K) shape; got {tuple(lidx.shape)} and "
                         f"{tuple(weights.shape)}")
    n_pad = lidx.shape[0]
    if row_tile < 1 or n_pad % row_tile or n_pad == 0:
        raise ValueError(f"N_pad = {n_pad} is not a positive multiple of "
                         f"row_tile = {row_tile}")
    if slab_starts.shape != (n_pad // row_tile,):
        raise ValueError("slab_starts must hold one start per row tile")
    if x.dim() != 2 or x.shape[0] < 1 or x.shape[1] < 1:
        raise ValueError("x must be a non-empty (N, S) matrix")
    if slab_rows < 1:
        raise ValueError("slab_rows must be positive")
    if weights.dtype not in (torch.float32, torch.float64) \
            or x.dtype != weights.dtype:
        raise TypeError("weights and x must share float32 or float64; got "
                        f"{weights.dtype} and {x.dtype}")
    for name, t in (("lidx", lidx), ("slab_starts", slab_starts)):
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be an int32 tensor")
    for name, t in (("lidx", lidx), ("weights", weights),
                    ("slab_starts", slab_starts), ("x", x)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")


def banded_inband(graph: BandedGraph, x):
    """The in-band part of ``A @ x``: (N_pad, S), a row for every padded
    row.  ``x`` is (N, S) with N >= 1 rows; slab rows at or beyond N read
    as zeros (x is not padded).  A CUDA tensor launches the kernel or
    raises; a CPU tensor takes the plain version."""
    args = (graph.lidx, graph.weights, graph.slab_starts, x, graph.row_tile,
            graph.slab_rows)
    _check(*args)
    if x.device.type == "cpu":
        return banded_spmm_plain(*args)
    if x.device.type != "cuda":
        raise ValueError(f"banded SpMM runs on cuda or cpu, not {x.device}")
    return _banded_spmm_cuda(graph.compact, graph.slab_starts, x,
                             graph.row_tile)


def gather_vec(s: int, itemsize: int, x_ptr: int, y_ptr: int) -> int:
    """Columns a thread of the kernel owns: the most of 4, 2, 1 that
    divides ``s`` and makes 16 bytes or less, with rows of ``x`` and ``y``
    on boundaries of that many elements."""
    for vec in (4, 2):
        nbytes = vec * itemsize
        if nbytes <= 16 and s % vec == 0 and x_ptr % nbytes == 0 \
                and y_ptr % nbytes == 0:
            return vec
    return 1


def _banded_spmm_cuda(compact, slab_starts, x, row_tile):
    lib = _lib()
    n_pad = compact.row_nnz.shape[0]
    n_x, s = x.shape
    if compact.lidx.data_ptr() % 16 or compact.weights.data_ptr() % 16:
        raise ValueError("the compacted slots must start on 16-byte "
                         "boundaries")
    y = torch.empty((n_pad, s), dtype=x.dtype, device=x.device)
    vec = gather_vec(s, x.element_size(), x.data_ptr(), y.data_ptr())
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.banded_spmm_launch(
            compact.row_ptr.data_ptr(), compact.lidx.data_ptr(),
            compact.weights.data_ptr(), slab_starts.data_ptr(), x.data_ptr(),
            y.data_ptr(), n_pad // row_tile, row_tile, n_x, s, vec,
            int(x.dtype == torch.float64), stream)
    if err != 0:
        raise RuntimeError(f"banded_spmm launch failed with CUDA error {err}")
    _build.count_launch(KERNEL)
    kernel_outputs(KERNEL, y)
    return y


def banded_spmm_plain(lidx, weights, slab_starts, x, row_tile, slab_rows):
    """Plain PyTorch version of the kernel, on any device: slab-local
    indices become absolute (``slab_starts[tile] + lidx``) and the product
    is a row gather plus contraction (``ops.spmm.ell_spmm``), in row
    blocks that bound the gathered buffer.  Same contract as the kernel:
    (N_pad, S) out, slab rows beyond ``x`` read as zeros."""
    n_pad, k = lidx.shape
    n_x, s = x.shape
    if k == 0:
        return x.new_zeros((n_pad, s))
    starts = torch.repeat_interleave(slab_starts.long(), row_tile)
    gidx = starts[:, None] + lidx.long()
    inside = gidx < n_x
    w = torch.where(inside, weights, torch.zeros_like(weights))
    gidx = torch.where(inside, gidx, torch.zeros_like(gidx))
    return ell_spmm(gidx, w, x, block_rows=_auto_block(n_pad, k, s))


def banded_spmm(graph: BandedGraph, x):
    """``y = A @ x`` for a banded-packed graph; (N, S) dense in/out.

    The in-band part runs in the CUDA kernel (``banded_inband``; the plain
    version for a CPU tensor); the spill ELL is a row gather and the COO
    tail a scatter-add, as for ELL overflow."""
    n = graph.n_rows_true
    x = x[:n]
    if not x.is_contiguous():
        x = x.contiguous()
    y = banded_inband(graph, x)[:n]
    if graph.spill_indices.shape[1]:
        k_sp = graph.spill_indices.shape[1]
        y = y + ell_spmm(graph.spill_indices, graph.spill_weights, x,
                         block_rows=_auto_block(n, k_sp, x.shape[1]))
    return coo_spmm_add(y, graph.overflow_rows, graph.overflow_cols,
                        graph.overflow_weights, x)


def diffusion_step_banded(s, graph: BandedGraph, colsums, self_weight):
    """Lazy-random-walk step (reference ``_nam.py:28,33``) on the banded
    format: ``s' = A @ (s/colsums) + self_weight * s/colsums``."""
    t = s / colsums[:, None]
    return banded_spmm(graph, t) + self_weight * t


def _lib():
    lib = _build.load(KERNEL)
    if lib.banded_spmm_launch.argtypes is None:  # first use: the C ABI
        lib.banded_spmm_launch.restype = ctypes.c_int
        lib.banded_spmm_launch.argtypes = (
            [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    return lib
