"""Sharded pipeline stages over a (cells, perms) mesh.

The TPU package's ``parallel/sharded.py``, whose stages are GSPMD
programs (sharding annotations, XLA inserts the collectives).  Here each
stage runs its per-slot part on the slot's device and merges with the
collectives of ``parallel.dist``.

For DIFFUSION this module is the fallback: ``diffusion_step``
all-gathers the scaled (N, S) state every step, however few rows each
shard references.  ``association(mesh=)`` / ``nam_arrays(mesh=)``
diffuse through the halo exchange instead (``parallel.halo``, wired in
``tools._nam``); this step serves the graphs that have no halo plan.

The permutation-null stage shards the Nnull axis: each perms slot scores
its own null columns with no traffic until the gather of the per-column
results; the null neighborhood coefficients are (cells, perms) tiles.
"""

from __future__ import annotations

import torch

from ..ops import ftest, moments, spmm
from . import dist
from . import mesh as meshlib
from .mesh import Sharded, place


def shard_graph(graph, mesh) -> dict:
    """An ``EllGraph``'s rows over the ``cells`` axis: per cell slot its
    ELL rows and the overflow edges whose row it owns (re-based to the
    slot's first row), on the slot's device.  Returns {slot: (row slice,
    EllGraph)}; the column sums stay global (the gather reads any row)."""
    from ..graph.ell import EllGraph

    rows = meshlib.cell_rows(mesh)
    n = graph.n_cells
    out = {}
    for cp in rows.primaries:
        if not mesh.is_local(cp):
            continue
        sl = rows.bounds((n,), cp)[0]
        dev = mesh.device(cp)
        orow = graph.overflow_rows.long()
        mine = (orow >= sl.start) & (orow < sl.stop)
        out[cp] = (sl, EllGraph(
            indices=graph.indices[sl].to(dev),
            weights=graph.weights[sl].to(dev),
            overflow_rows=(orow[mine] - sl.start).to(torch.int32).to(dev),
            overflow_cols=graph.overflow_cols[mine].to(dev),
            overflow_weights=graph.overflow_weights[mine].to(dev),
            colsums_raw=graph.colsums_raw[sl].to(dev)))
    return out


def diffusion_step(s, graph, colsums, self_weight, mesh) -> Sharded:
    """One diffusion step with rows over the ``cells`` axis: the scaled
    state is all-gathered, each cell slot computes its own rows.

    ``s``: (N, S) state (tensor or ``Sharded`` over ``cell_rows``);
    ``graph``: ``shard_graph``'s result; ``colsums``: (N,) normalizers
    with the self weight added.  Matches ``ops.spmm.diffusion_step``."""
    rows = meshlib.cell_rows(mesh)
    if not isinstance(s, Sharded):
        s = place(s, rows)
    colsums = colsums.to(mesh.lead_device)
    t = Sharded(s.spec, s.shape, s.dtype, {
        cp: x / colsums[graph[cp][0]].to(x.device)[:, None]
        for cp, x in s.shards.items()})
    t_all = dist.gather(t)
    out = {}
    for cp, x in t.shards.items():
        y = spmm.graph_spmm(graph[cp][1], t_all.to(x.device))
        out[cp] = y + self_weight * x
    return Sharded(s.spec, s.shape, s.dtype, out)


def diffusion_stats(s_new: Sharded, old_s, c_counts, n_cells):
    """The adaptive stop's statistics of a cell-sharded state, on the lead
    device: the median over the first ``n_cells`` rows of each row's excess
    kurtosis of ``s_new / c_counts`` (the per-row values all-gathered),
    and the per-column R² of ``s_new`` against ``old_s`` (None: zeros)
    from raw sums merged by ``psum``."""
    mesh = s_new.mesh
    kurt = Sharded(meshlib.cell_rows(mesh), (s_new.shape[0],), s_new.dtype, {
        cp: moments.kurtosis(x / c_counts.to(x.device)[None, :], axis=1)
        for cp, x in s_new.shards.items()})
    medkurt = moments.median(dist.gather(kurt)[:n_cells])
    parts = []
    for cp, a in s_new.shards.items():
        b = (old_s.shards[cp] if old_s is not None
             else torch.zeros_like(a))
        parts.append(moments.column_sums(a, b))
    r2 = moments.column_r2_from_sums(
        dist.psum(mesh, parts, (5, s_new.shape[1]), s_new.dtype), n_cells)
    return medkurt, r2


def null_minp(u, m_proj, y_cols, ks, r, mesh):
    """Score permutation-null columns, sharded over the ``perms`` axis:
    each perms slot runs ``ops.ftest.minp_stats_batch`` on its column
    block.  Returns (k_sel, minps, r2s) over all columns, on the lead
    device."""
    y = place(y_cols, meshlib.perm_cols(mesh))
    res = {cp: ftest.minp_stats_batch(u.to(x.device), m_proj.to(x.device),
                                      x, ks.to(x.device), r)
           for cp, x in y.shards.items()}
    spec = meshlib.Spec(mesh, (meshlib.PERMS,))
    return tuple(
        dist.gather(Sharded(spec, (y.shape[1],), dtype,
                            {cp: v[i] for cp, v in res.items()}))
        for i, dtype in enumerate((ks.dtype, y.dtype, y.dtype)))


def _tiles(namresid, ycond, mesh, fn):
    """``fn(namresid block, ycond block)`` on every (cells, perms) slot of
    this process: cell block c of ``namresid``'s columns against perms
    block p of ``ycond``'s, on the slot's device.  Both inputs are global
    values that every process holds."""
    tiles = meshlib.cell_by_perm(mesh)
    cols = meshlib.perm_cols(mesh)
    out = {}
    for cp in mesh.local_slots:
        dev = mesh.device(cp)
        c_sl = tiles.bounds((namresid.shape[1],), cp)[0]
        p_sl = cols.bounds(tuple(ycond.shape), cp)[1]
        out[cp] = fn(namresid[:, c_sl].to(dev), ycond[:, p_sl].to(dev))
    return out


def null_ncorrs(namresid, m_proj, y_cols, mesh):
    """The dominant FLOP block ``|namresid.T @ z| / S`` (``z`` the
    standardized projected nulls): (cells x S) @ (S x Nnull) in (cells,
    perms) tiles, each on its slot, gathered to the lead device."""
    z = moments.scale_by_std(m_proj @ y_cols, ddof=1, axis=0)
    n = namresid.shape[0]
    out = _tiles(namresid, z, mesh, lambda nr, zc: torch.abs(nr.T @ zc) / n)
    return dist.gather(Sharded(meshlib.cell_by_perm(mesh),
                               (namresid.shape[1], z.shape[1]),
                               namresid.dtype, out))


def association_step(s, graph, colsums, self_weight, c_counts, u, m_proj,
                     y_cols, ks, r, mesh):
    """One whole-pipeline step for checks across the mesh: the row-sharded
    diffusion update, the stopping statistic, the sharded null min-p
    batch and the null-coefficient tiles.  ``graph`` is ``shard_graph``'s
    result.  Returns (new state, median kurtosis, null min-ps, null
    coefficients), the last three on the lead device."""
    s_new = diffusion_step(s, graph, colsums, self_weight, mesh)
    medkurt, _ = diffusion_stats(s_new, None, c_counts, s_new.shape[0])
    snormed = dist.gather(s_new) / c_counts.to(mesh.lead_device)[None, :]
    nam = snormed - snormed.mean(dim=0, keepdim=True)  # (cells, S)
    _, minps, _ = null_minp(u, m_proj, y_cols, ks, r, mesh)
    z = moments.scale_by_std(m_proj @ y_cols, ddof=1, axis=0)
    n_cells = nam.shape[0]
    tiles = _tiles(nam.T, z, mesh,
                   lambda nr, zc: torch.abs(nr.T @ zc) / n_cells)
    nullnc = dist.gather(Sharded(meshlib.cell_by_perm(mesh),
                                 (n_cells, z.shape[1]), nam.dtype, tiles))
    return s_new, medkurt, minps, nullnc


def sharded_knn(points, k, mesh, key_block: int = 8192):
    """Exact self-kNN with query rows over the mesh's ``cells`` axis and
    the keys replicated on every cell slot: blocked ``torch.matmul`` +
    ``torch.topk`` per slot (``pp.knn._knn_query_block``, whose self
    distance is exactly 0).  Returns host (indices (N, k) int32,
    distances (N, k)) in the ``knn_search`` contract."""
    from ..pp.knn import _knn_query_block
    from ..utils.transfer import as_tensor

    x = points if isinstance(points, torch.Tensor) else as_tensor(points)
    n = x.shape[0]
    rows = meshlib.cell_rows(mesh)
    ids, dists = {}, {}
    keys = {}
    for cp in rows.primaries:
        if not mesh.is_local(cp):
            continue
        dev = mesh.device(cp)
        if dev not in keys:
            xd = x.to(dev)
            keys[dev] = (xd, torch.sum(xd * xd, dim=1))
        xd, sq = keys[dev]
        sl = rows.bounds((n,), cp)[0]
        q_ids = torch.arange(sl.start, sl.stop, device=dev)
        neg_d, idx = _knn_query_block(xd, q_ids, sq, k, key_block)
        ids[cp] = idx.to(torch.int32)
        dists[cp] = torch.sqrt(torch.clamp(-neg_d, min=0.0))
    return (dist.fetch(Sharded(rows, (n, k), torch.int32, ids)),
            dist.fetch(Sharded(rows, (n, k), x.dtype, dists)))
