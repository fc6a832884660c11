"""Halo-exchange diffusion: cell-sharded SpMM with explicit collectives.

The TPU package's ``parallel/halo.py``.  The row-sharded fallback
(``parallel.sharded.diffusion_step``) all-gathers the whole (N, S)
scaled state every step, however few rows each shard references.  Here
each cell shard owns a contiguous cell block; per step it sends only the
**ghost rows** its neighbours reference, then runs a purely local
degree-bucketed ELL SpMM against [own rows ‖ received ghosts].

The exchange plan (which rows each shard pair needs) is computed once on
the host from the CSR structure in a handful of vectorized numpy passes
(one sort over the cross-shard edges), equal array for array to the TPU
package's.  The exchange is multi-round over ring offsets: round t ships
each listed producer's ghosts to the consumer ``offset`` positions ahead,
padded only to that round's size bucket (light and heavy pairs of one
offset ride separate rounds), so the padded volume stays near the true
ghost bytes on a locality-ordered partition (``graph.partition``).

The local SpMM is degree-bucketed: rows are degree-sorted within each
shard and packed into a few ELL buckets shared by every shard (chosen by
``graph.buckets.plan_buckets`` on the max-over-shards sorted-degree
profile), each padded only to its own width; one row gather per shard
(``row_pos``) restores the true row order.

The per-shard body is plain torch (gather + einsum per bucket): the TPU
package's is an XLA einsum, not a Pallas kernel.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import config
from ..ops.spmm import _bucket_outputs
from . import dist
from .mesh import Sharded, cell_rows, place


@dataclasses.dataclass(frozen=True)
class HaloPlan:
    """Per-shard exchange plan + locally remapped degree-bucketed graph.

    Shapes (D = shards, Nd = rows per shard, N_b/K_b = rows and width of
    degree bucket b with sum_b N_b = Nd, G_t = padded ghost rows of round
    t), as in the TPU package:

      bucket_indices: tuple of (D, N_b, K_b) int32 — ELL neighbour ids in
        the extended local layout [0, Nd + sum G): own rows first, then
        the ghosts of each exchange round in round order.
      bucket_weights: matching (D, N_b, K_b) edge weights (0 = padding).
      row_pos: (D, Nd) int32 — degree-sorted position of each true
        shard-local row.
      send_rounds: tuple of (D, G_t) int32 — ``send_rounds[t][j]`` = rows
        (local to shard j, true order) that the consumer
        ``(j + offset_t) % D`` needs (padding resends row 0).
      colsums: (D, Nd) column sums of the rows each shard owns (1 on the
        shard-padding rows).
      n_cells: true cell count (before shard padding).
      n_ghosts: true (unpadded) ghost rows exchanged per step.
      rounds: tuple of (offset, producers) pairs; a round moves bytes only
        for its listed producers.
      out_permuted: False when the degree sort is the identity.

    ``place_plan`` turns the tensor fields into ``mesh.Sharded`` values
    (one shard per cell slot, on its device).
    """

    bucket_indices: tuple
    bucket_weights: tuple
    row_pos: torch.Tensor
    send_rounds: tuple
    colsums: torch.Tensor
    n_cells: int
    n_ghosts: int = 0
    rounds: tuple = ()
    out_permuted: bool = True

    @property
    def n_shards(self) -> int:
        return int(self.colsums.shape[0])

    @property
    def shard_rows(self) -> int:
        return int(self.colsums.shape[1])

    @property
    def dtype(self) -> torch.dtype:
        # the column sums exist on every plan (the buckets of an empty
        # graph do not)
        return self.colsums.dtype

    def padded_area(self) -> int:
        """Per-shard gathered slots per SpMM step (rows x bucket width,
        summed over buckets): near nnz/D instead of Nd x max-degree."""
        return sum(int(i.shape[1]) * int(i.shape[2])
                   for i in self.bucket_indices)

    def ghost_fraction(self) -> float:
        """True ghost rows exchanged per step as a fraction of all cells:
        << 1 means the halo moves only boundary rows; (D-1) means the plan
        has degenerated to an all-gather."""
        return self.n_ghosts / max(self.n_cells, 1)

    def exchange_stats(self, s_cols: int, itemsize: int = 4) -> dict:
        """Per-step interconnect bytes of this plan for an (N, ``s_cols``)
        state: ``ghost_bytes`` (true boundary rows), ``padded_bytes``
        (what the rounds ship, padding included) and ``allgather_bytes``
        (the dense alternative: every shard receives every remote row)."""
        d, nd = self.n_shards, self.shard_rows
        row = s_cols * itemsize
        padded_rows = sum(int(s.shape[1]) * len(js)
                          for s, (_, js) in zip(self.send_rounds,
                                                self.rounds))
        return {
            "ghost_bytes": self.n_ghosts * row,
            "padded_bytes": padded_rows * row,
            "allgather_bytes": d * (d - 1) * nd * row,
            "ghost_fraction": self.ghost_fraction(),
            "rounds": len(self.rounds),
        }


def _round_up(x: int, m: int) -> int:
    return ((int(x) + m - 1) // m) * m


def build_halo_plan_csr(a, n_shards, colsums=None, pad_to=8,
                        max_buckets=6, dtype=None) -> HaloPlan:
    """Build the exchange plan from a scipy sparse matrix.

    ``a``: (N, N) sparse graph, rows = consumers (``a.dot(s)``
    semantics, reference ``_nam.py:33``).  The caller applies any
    locality ordering of the cell axis first: the plan blocks rows in the
    order given.  ``colsums``: (N,) normalizers (from ``a`` when
    omitted).  ``dtype``: numpy float dtype of the weights (default: the
    configured working float).  The tensors are on the CPU until
    ``place_plan``.
    """
    import scipy.sparse as sp

    from ..graph.buckets import plan_buckets

    a = sp.csr_matrix(a)
    n = a.shape[0]
    if colsums is None:
        colsums = np.asarray(a.sum(axis=0)).ravel()
    colsums = np.asarray(colsums)
    if dtype is None:
        dtype = np.float64 if config.x64_enabled() else np.float32

    d = int(n_shards)
    nd = _round_up(-(-n // d), pad_to)
    n_pad = nd * d

    deg = np.diff(a.indptr)
    nnz = a.nnz
    etype = np.int32 if d * nd < (1 << 31) else np.int64
    rows = np.repeat(np.arange(n, dtype=etype), deg)
    cols = a.indices.astype(etype, copy=False)
    vals = a.data
    pos = (np.arange(nnz, dtype=etype)
           - np.repeat(a.indptr[:-1].astype(etype), deg))

    cons = rows // nd
    prod = cols // nd
    cross = cons != prod

    # --- ghost discovery: one unique over (consumer, referenced col) ---
    ck = cons[cross].astype(np.int64) * n_pad + cols[cross]
    uk = np.unique(ck)
    n_ghosts = len(uk)
    ucons = uk // n_pad
    ucol = uk % n_pad
    uprod = ucol // nd
    pair = (ucons * d + uprod).astype(np.int64)  # non-decreasing
    counts = np.bincount(pair, minlength=d * d).reshape(d, d)  # [cons, prod]
    seg_start = np.concatenate([[0], np.cumsum(counts.ravel())[:-1]])

    # rounds: per ring offset r, pair (p -> (p+r)%d) ships p's ghosts; an
    # offset splits into a light and a heavy size bucket when that saves
    # more than d * pad_to padded rows
    jj = np.arange(d)
    rounds = []        # (offset, producers-tuple)
    round_sizes = []   # padded G per round
    bucket_of = np.zeros((d, d), dtype=np.int64)  # [offset, producer] -> t
    for r in range(1, d):
        c_r = counts[(jj + r) % d, jj]
        live = np.flatnonzero(c_r > 0)
        if len(live) == 0:
            continue
        hi = int(c_r[live].max())
        lo_cap = _round_up(int(np.percentile(c_r[live], 66)), pad_to)
        heavy = live[c_r[live] > lo_cap]
        light = live[c_r[live] <= lo_cap]
        split = (len(heavy) and len(light)
                 and len(light) * (hi - lo_cap) > d * pad_to)
        if split:
            for js, cap in ((light, lo_cap),
                            (heavy, _round_up(hi, pad_to))):
                bucket_of[r, js] = len(rounds)
                rounds.append((int(r), tuple(int(j) for j in js)))
                round_sizes.append(cap)
        else:
            bucket_of[r, live] = len(rounds)
            rounds.append((int(r), tuple(int(j) for j in live)))
            round_sizes.append(_round_up(hi, pad_to))
    rounds = tuple(rounds)
    base_of_bucket = nd + np.concatenate(
        [[0], np.cumsum(round_sizes)[:-1]]) if rounds else np.zeros(0)

    send_rounds = tuple(np.zeros((d, g), dtype=np.int32)
                        for g in round_sizes)
    u_bucket = None
    if n_ghosts:
        pos_in_seg = (np.arange(n_ghosts, dtype=np.int64)
                      - seg_start[pair])
        u_round = (ucons - uprod) % d
        u_bucket = bucket_of[u_round, uprod]
        for t in range(len(rounds)):
            in_t = u_bucket == t
            send_rounds[t][uprod[in_t], pos_in_seg[in_t]] = (
                ucol[in_t] - uprod[in_t] * nd).astype(np.int32)

    # --- remap every edge into the extended local layout ---
    ext_idx = np.empty(nnz, dtype=np.int64)
    own = ~cross
    ext_idx[own] = cols[own] - cons[own] * nd
    if n_ghosts:
        gpos = np.searchsorted(uk, ck)  # exact: every ck is in uk
        ext_idx[cross] = (base_of_bucket[u_bucket[gpos]]
                          + (gpos - seg_start[pair[gpos]]))

    # --- degree-bucketed local pack: rows degree-sorted within each
    # shard, one bucket geometry for every shard ---
    deg_pad = np.zeros(n_pad, dtype=np.int64)
    deg_pad[:n] = deg
    deg_sh = deg_pad.reshape(d, nd)
    order_in_shard = np.argsort(deg_sh, axis=1, kind="stable")  # (d, nd)
    sorted_deg = np.take_along_axis(deg_sh, order_in_shard, axis=1)
    # columnwise max of ascending rows is ascending: a valid DP profile
    profile = sorted_deg.max(axis=0)
    bplan = plan_buckets(profile, max_buckets=max_buckets, pad_to=pad_to)
    row_pos = np.empty((d, nd), dtype=np.int32)
    np.put_along_axis(row_pos, order_in_shard,
                      np.broadcast_to(np.arange(nd, dtype=np.int32),
                                      (d, nd)), axis=1)
    out_permuted = bool(
        (order_in_shard != np.arange(nd, dtype=order_in_shard.dtype)).any())

    # per edge: sorted position of its row, then its bucket; one flat
    # scatter for all buckets
    s0_arr = np.asarray([s0 for s0, _, _ in bplan], dtype=np.int64)
    nb_arr = np.asarray([e0 - s0 for s0, e0, _ in bplan], dtype=np.int64)
    wb_arr = np.asarray([wb for *_, wb in bplan], dtype=np.int64)
    area = d * nb_arr * wb_arr
    total_area = int(area.sum())
    base = np.concatenate([[0], np.cumsum(area)[:-1]])
    itype = np.int32 if total_area < (1 << 31) else np.int64
    pos_sorted = row_pos.reshape(-1)[rows]
    be = np.searchsorted(s0_arr, pos_sorted, side="right") - 1
    dest = (rows // nd).astype(itype, copy=False)
    dest *= nb_arr.astype(itype)[be]
    dest += pos_sorted.astype(itype, copy=False)
    dest -= s0_arr.astype(itype)[be]
    dest *= wb_arr.astype(itype)[be]
    dest += base.astype(itype)[be]
    dest += pos.astype(itype, copy=False)
    li_flat = np.zeros(total_area, dtype=np.int32)
    lw_flat = np.zeros(total_area, dtype=dtype)
    li_flat[dest] = ext_idx
    lw_flat[dest] = vals.astype(dtype)
    b_idx, b_w = [], []
    for b, (s0, e0, wb) in enumerate(bplan):
        sl = slice(int(base[b]), int(base[b] + area[b]))
        b_idx.append(torch.from_numpy(li_flat[sl].reshape(d, e0 - s0, wb)))
        b_w.append(torch.from_numpy(lw_flat[sl].reshape(d, e0 - s0, wb)))

    colsums_pad = np.ones(n_pad, dtype=dtype)
    colsums_pad[:n] = colsums.astype(dtype)

    return HaloPlan(
        bucket_indices=tuple(b_idx),
        bucket_weights=tuple(b_w),
        row_pos=torch.from_numpy(row_pos),
        send_rounds=tuple(torch.from_numpy(s) for s in send_rounds),
        colsums=torch.from_numpy(colsums_pad.reshape(d, nd)),
        n_cells=n,
        n_ghosts=n_ghosts,
        rounds=rounds,
        out_permuted=out_permuted,
    )


def build_halo_plan(indices, weights, colsums, n_shards, pad_to=8) -> HaloPlan:
    """Build the exchange plan from host ELL arrays (``indices`` /
    ``weights`` (N, K), ``colsums`` (N,)): a wrapper over
    ``build_halo_plan_csr``."""
    import scipy.sparse as sp

    indices = np.asarray(indices)
    weights = np.asarray(weights)
    n, k = indices.shape
    rows = np.repeat(np.arange(n), k)
    mask = weights.ravel() != 0
    a = sp.csr_matrix(
        (weights.ravel()[mask], (rows[mask], indices.ravel()[mask])),
        shape=(n, n))
    return build_halo_plan_csr(a, n_shards, colsums=np.asarray(colsums),
                               pad_to=pad_to, dtype=weights.dtype)


def place_plan(plan: HaloPlan, mesh) -> HaloPlan:
    """The plan with every (D, ...) tensor split over the mesh's ``cells``
    axis: each cell slot holds its shard's buckets, row positions, send
    lists (it is their producer) and column sums, on its device.  Index
    tensors become int64 there (what the row gathers take)."""
    if mesh.shape["cells"] != plan.n_shards:
        raise ValueError(f"the plan has {plan.n_shards} shards and the mesh "
                         f"{mesh.shape['cells']} cell slots")
    rows = cell_rows(mesh)

    def put(x, long=False):
        return place(x.long() if long else x, rows)

    return dataclasses.replace(
        plan,
        bucket_indices=tuple(put(i, True) for i in plan.bucket_indices),
        bucket_weights=tuple(put(w) for w in plan.bucket_weights),
        row_pos=put(plan.row_pos, True),
        send_rounds=tuple(put(s, True) for s in plan.send_rounds),
        colsums=put(plan.colsums),
    )


def _is_placed(plan: HaloPlan) -> bool:
    return isinstance(plan.colsums, Sharded)


def halo_diffusion_step(s, plan: HaloPlan, mesh, self_weight=1.0) -> Sharded:
    """One diffusion step over the cells axis with explicit halo exchange.

    ``s``: the (D*Nd, S) state in shard-padded layout (rows beyond
    ``plan.n_cells`` are zero padding), as a tensor or as a ``Sharded``
    over ``cell_rows(mesh)``; ``plan``: placed or not.  Returns the new
    state as a ``Sharded``; its true rows equal ``ops.spmm.diffusion_step``
    of the same graph.
    """
    if not _is_placed(plan):
        plan = place_plan(plan, mesh)
    if not isinstance(s, Sharded):
        s = place(s, cell_rows(mesh))
    d = plan.n_shards
    mine = list(s.shards)
    t = {cp: s.shards[cp] / (plan.colsums.shards[cp][0]
                             + self_weight)[:, None] for cp in mine}
    width = s.shape[1]
    exchange = []
    for sidx, (r, js) in zip(plan.send_rounds, plan.rounds):
        sends = {cp: t[cp][sidx.shards[cp][0]] for cp in mine if cp[0] in js}
        pairs = [((j, 0), ((j + r) % d, 0)) for j in js]
        exchange.append((sends, pairs, (int(sidx.shape[1]), width), s.dtype))
    received = dist.ppermute(mesh, exchange)
    out = {}
    for cp in mine:
        parts = [t[cp]]
        for (_, _, shape, dtype), got in zip(exchange, received):
            parts.append(got[cp] if cp in got else torch.zeros(
                shape, dtype=dtype, device=t[cp].device))
        ext = torch.cat(parts)
        y = _bucket_outputs([i.shards[cp][0] for i in plan.bucket_indices],
                            [w.shards[cp][0] for w in plan.bucket_weights],
                            ext)
        if plan.out_permuted:
            # sorted position p holds the result of true row order[p];
            # true row r's result therefore sits at position row_pos[r]
            y = y[plan.row_pos.shards[cp][0]]
        out[cp] = y + self_weight * t[cp]
    return Sharded(s.spec, s.shape, s.dtype, out)
