"""State carried across from the TPU package as numpy arrays.

CNA has no learned parameters; the state that crosses between the two
packages is the packed graph, the IVF index and the halo plan.  These converters turn
the fields of the TPU package's objects (pulled to numpy) into the
port's, so that both packages can diffuse the very same packed graph and
search the very same index.  They import nothing of the TPU package.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import config
from ..graph.blocks import (BlockGraph, HybridGraph,
                            block_graph_from_arrays)
from ..graph.buckets import BucketEllGraph, from_bucket_arrays
from ..graph.device import SortedExtGraph
from ..graph.ell import EllGraph, from_arrays
from .transfer import to_device


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


def banded_graph_from_numpy(lidx, weights, slab_starts, spill_indices,
                            spill_weights, overflow_rows, overflow_cols,
                            overflow_weights, colsums_raw, n_rows_true,
                            row_tile, slab_rows, device=None):
    """The port's ``BandedGraph`` from the numpy fields of the TPU
    package's (``ops/spmm_pallas.py``), name for name."""
    from ..ops.spmm_banded import banded_from_arrays

    return banded_from_arrays(
        lidx, weights, slab_starts, spill_indices, spill_weights,
        overflow_rows, overflow_cols, overflow_weights, colsums_raw,
        n_rows_true, row_tile, slab_rows, device=device)


def block_graph_from_numpy(tiles, pair_rows, pair_cols, colsums_raw,
                           n_cells, device=None) -> BlockGraph:
    """The port's ``BlockGraph`` from the numpy fields of the TPU
    package's (``graph/blocks.py``), name for name."""
    return block_graph_from_arrays(tiles, pair_rows, pair_cols, colsums_raw,
                                   n_cells, device=device)


def hybrid_graph_from_numpy(block: BlockGraph, ell: EllGraph, colsums_raw,
                            n_cells, device=None) -> HybridGraph:
    """The port's ``HybridGraph`` from its two converted parts
    (``block_graph_from_numpy``, ``graph_from_numpy``) and the numpy
    column sums of the full matrix."""
    dev = block.device if device is None else torch.device(device)
    return HybridGraph(block=block, ell=ell,
                       colsums_raw=to_device(colsums_raw, dev),
                       n_cells=int(n_cells))


def sorted_ext_graph_from_numpy(direct_indices, direct_weights, ext_indices,
                                ext_weights, inv_pi, colsums_raw,
                                overflow_rows=None, overflow_cols=None,
                                overflow_weights=None,
                                device=None) -> SortedExtGraph:
    """The port's ``SortedExtGraph`` from the numpy fields of the TPU
    package's (``graph/device.py``).  The TPU package's bucket slices may
    be padded and overlap (``inv_pi`` then points into a concatenation
    longer than N); they are kept as they are, and both the SpMM and
    ``DeviceConnectivities.tocsr`` read them through ``inv_pi``."""
    dev = config.device() if device is None else torch.device(device)
    direct = from_arrays(direct_indices, direct_weights, colsums_raw,
                         overflow_rows, overflow_cols, overflow_weights,
                         device=dev)
    return SortedExtGraph(
        direct_indices=direct.indices, direct_weights=direct.weights,
        ext_indices=tuple(to_device(i, dev, torch.int32)
                          for i in ext_indices),
        ext_weights=tuple(to_device(w, dev) for w in ext_weights),
        inv_pi=to_device(inv_pi, dev, torch.int64),
        overflow_rows=direct.overflow_rows,
        overflow_cols=direct.overflow_cols,
        overflow_weights=direct.overflow_weights,
        colsums_raw=direct.colsums_raw)


def fine_index_from_numpy(x4, cents, blk_counts, blk_csum, layout_rows,
                          order, g, q_blocks, n, d_pad, f_real,
                          device=None):
    """The port's ``FineIndex`` from the numpy fields of the TPU package's
    (``pp/ivf_fine.py``).  The TPU layout is ``d_pad`` (a multiple of 128)
    wide; its zero padding columns are cut to the width the port's kernel
    takes (``ops.ivf.kernel_d_pad`` of the widest used column), which
    changes no distance."""
    from ..ops.ivf import kernel_d_pad
    from ..pp.ivf_fine import FineIndex

    dev = config.device() if device is None else torch.device(device)
    x4 = np.asarray(x4, dtype=np.float32)
    cents = np.asarray(cents, dtype=np.float32)
    used = np.flatnonzero(np.any(x4 != 0, axis=(0, 1)))
    width = kernel_d_pad(int(used[-1]) + 1 if len(used) else 1)
    if width > d_pad:
        raise ValueError(f"the layout is {d_pad} wide, narrower than the "
                         f"kernel's width {width}")
    blk_counts = np.asarray(blk_counts, dtype=np.int32)
    blk_csum = np.asarray(blk_csum, dtype=np.int64)
    return FineIndex(
        x4=to_device(np.ascontiguousarray(x4[:, :, :width]), dev),
        cents=to_device(np.ascontiguousarray(cents[:, :width]), dev),
        blk_counts=blk_counts,
        blk_counts_dev=to_device(blk_counts, dev),
        blk_csum_dev=to_device(blk_csum.astype(np.int32), dev),
        layout_rows=np.asarray(layout_rows, dtype=np.int32),
        order=np.asarray(order, dtype=np.int32),
        g=int(g), q_blocks=int(q_blocks), n=int(n), d_pad=width,
        f_real=int(f_real), _csum_host=blk_csum)


def halo_plan_from_numpy(bucket_indices, bucket_weights, row_pos,
                         send_rounds, colsums, n_cells, n_ghosts=0,
                         rounds=(), out_permuted=True):
    """The port's ``parallel.halo.HaloPlan`` from the fields of the TPU
    package's (``parallel/halo.py``), name for name, as numpy arrays and
    plain values: both packages can then diffuse over one plan.  The
    tensors stay on the CPU until ``parallel.halo.place_plan``."""
    from ..parallel.halo import HaloPlan

    def t(a):
        return torch.from_numpy(np.array(a))

    return HaloPlan(
        bucket_indices=tuple(t(i).to(torch.int32) for i in bucket_indices),
        bucket_weights=tuple(t(w) for w in bucket_weights),
        row_pos=t(row_pos).to(torch.int32),
        send_rounds=tuple(t(s).to(torch.int32) for s in send_rounds),
        colsums=t(colsums), n_cells=int(n_cells), n_ghosts=int(n_ghosts),
        rounds=tuple((int(r), tuple(int(j) for j in js))
                     for r, js in rounds),
        out_permuted=bool(out_permuted))
