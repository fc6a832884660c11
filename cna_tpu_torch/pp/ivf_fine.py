"""Two-level IVF-flat kNN: fine-block probe ranking, device-resident.

The TPU package's ``pp/ivf_fine.py``.  IVF recall on atlas data is limited
by probe selection, not scoring, and finer ranking granularity needs less
candidate coverage for the same recall.  The module therefore decouples
two granularities:

* **candidates** live in fine g-row blocks (k-means clusters of about 96
  points, padded up to block multiples): the probe-selection granularity;
* **queries** are scored one slot (``q_blocks`` blocks) at a time by the
  scoring kernel (``ops.ivf.score_blocks``);
* probe lists rank all fine blocks per query block by **own-centroid
  distance**: one (F, F) centroid matmul and a top-k for the whole index,
  computed once per probe count on the device and read directly by the
  scoring kernel.

Results stay on the device in compact layout coordinates (cells sorted by
kd-ordered fine cluster): the kernel emits compact neighbor ids through
the per-block offset table, and ``_finalize`` produces (indices, dists)
device tensors plus the ``order`` permutation, which ``pp.neighbors``
consumes in place.  Only the pilot's small samples reach the host.

Recall is measured, not assumed: a pilot on a slot subsample calibrates
the probe count ``u`` against exact-kNN truth, with the truth sample split
into calibrate and verify halves so the final check is not biased by the
calibration's choice.

What differs from the TPU package, on purpose: the layout width
(``FineIndex.d_pad``) is the kernel's (``ops.ivf.kernel_d_pad``), not a
multiple of 128; the probe table uses an exact ``torch.topk`` (there is
no ``approx_max_k``); a whole search is one kernel launch (see
``_score_slots``), or one per device with ``devices=``.
"""

from __future__ import annotations

import dataclasses
import sys
import warnings

import numpy as np
import torch

from ..ops.ivf import CANDS_PER_STEP, kernel_d_pad, score_blocks
from ..utils.profiling import global_profiler
from ..utils.transfer import as_tensor, fetch
from .ivf import _recall_against, exact_knn_sample, measured_recall

_DUMMY_CENTROID = 1e15  # squared distance ~1e30 stays finite in float32
# rows of the (rows, F_pad) centroid-distance tile ranked at a time
_RANK_ROW_BLOCK = 2048
# elements of one launch's (slots, rows, k) outputs: a 1M-cell search
# (about 0.25 GB of float32 + int32 results) is a single launch
_MAX_LAUNCH_ELEMS = 1 << 28


def _round_up(v: int, m: int) -> int:
    return ((int(v) + m - 1) // m) * m


def _pow2_up(v: int) -> int:
    return 1 << max(int(v) - 1, 0).bit_length()


def _bucket16(v: int) -> int:
    """Quarter-octave size bucket rounded to a CANDS_PER_STEP multiple.
    The TPU package buckets probe counts and F_pad to reuse compiled
    programs; the port keeps the same grid so that both packages lay an
    index out identically and walk the same probe counts."""
    step = max(_pow2_up(v) // 4, CANDS_PER_STEP)
    step = _round_up(step, CANDS_PER_STEP)
    return _round_up(v, step)


# ---------------------------------------------------------------------------
# k-means with a matmul update (deterministic: no atomics)
# ---------------------------------------------------------------------------


def _kmeans_fit_matmul(x, valid, init_idx, n_clusters, iters, chunk):
    """Lloyd's algorithm at fine cluster counts.

    The centroid update is a one-hot matmul per row chunk (d2 -> argmin ->
    exact 0/1 one-hot -> ``oh.T @ x`` accumulated in the working dtype).
    A scatter-add (``index_add_``) would use atomics on cuda, whose sum
    order changes from run to run: the centroids, and with them the whole
    index, would not be repeatable for one seed.

    ``x``: (n_pad, d) rows, zero-padded to a multiple of ``chunk``;
    ``valid``: (n_pad,) row mask; ``init_idx``: (n_clusters,) row ids of
    the initial centroids.
    """
    cent = x[init_idx]
    iot = torch.arange(n_clusters, device=x.device)[None, :]
    for _ in range(iters):
        cn = torch.sum(cent * cent, dim=1)[None, :]
        sums = torch.zeros_like(cent)
        cnts = torch.zeros(n_clusters, dtype=x.dtype, device=x.device)
        for lo in range(0, x.shape[0], chunk):
            xb = x[lo:lo + chunk]
            d2 = cn - 2.0 * (xb @ cent.T)
            cid = torch.argmin(d2, dim=1)
            oh = ((cid[:, None] == iot)
                  & valid[lo:lo + chunk, None]).to(x.dtype)
            sums = sums + oh.T @ xb
            cnts = cnts + oh.sum(dim=0)
        new = sums / torch.clamp(cnts, min=1.0)[:, None]
        cent = torch.where(cnts[:, None] > 0, new, cent)
    return cent


def _assign_chunked(x, cent, chunk):
    """argmin-distance cluster of every row (int64), in row chunks so the
    (chunk, C) distance tile stays bounded at fine cluster counts."""
    cn = torch.sum(cent * cent, dim=1)[None, :]
    return torch.cat([
        torch.argmin(cn - 2.0 * (x[lo:lo + chunk] @ cent.T), dim=1)
        for lo in range(0, x.shape[0], chunk)])


def _kd_order(pts: np.ndarray, leaf: int = 8) -> np.ndarray:
    """Spatial ordering of points by recursive widest-axis median
    bisection: consecutive entries are spatial neighbors, so consecutive
    fine blocks (and the slots that group them) stay tight."""
    n = len(pts)
    out = np.empty(n, dtype=np.int64)
    pos = 0
    stack = [np.arange(n)]
    while stack:
        seg = stack.pop()
        if len(seg) <= leaf:
            out[pos:pos + len(seg)] = seg
            pos += len(seg)
            continue
        sub = pts[seg]
        ax = int(np.argmax(sub.var(axis=0)))
        half = len(seg) // 2
        part = np.argpartition(sub[:, ax], half)
        stack.append(seg[part[half:]])
        stack.append(seg[part[:half]])
    return out


# ---------------------------------------------------------------------------
# index build
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class FineIndex:
    """Device fine-block layout + host bookkeeping.

    Compact coordinates: cells sorted by (kd-ordered fine cluster,
    within-cluster position); ``order[r]`` is the original id of compact
    row r; ``layout_rows[r]`` its row in the padded (F_pad*g) layout.
    """

    x4: torch.Tensor              # (F_pad, g, d_pad) float32
    cents: torch.Tensor           # (F_pad, d_pad) block centroids
    blk_counts: np.ndarray        # (F_pad,) live rows per block
    blk_counts_dev: torch.Tensor  # the same, int32 on the device
    blk_csum_dev: torch.Tensor    # (F_pad,) exclusive cumsum = compact offsets
    layout_rows: np.ndarray       # (N,) layout row of compact row r
    order: np.ndarray             # (N,) original id of compact row r
    g: int
    q_blocks: int
    n: int
    d_pad: int
    f_real: int                   # real (non-dummy) blocks
    _csum_host: np.ndarray = None

    @property
    def f_pad(self) -> int:
        return int(self.x4.shape[0])

    @property
    def n_slots(self) -> int:
        return self.f_pad // self.q_blocks

    def slot_compact_range(self, s: int) -> tuple:
        """Compact row range [lo, hi) covered by slot ``s``."""
        b0 = s * self.q_blocks
        lo = int(self._csum_host[b0])
        hi = lo + int(self.blk_counts[b0:b0 + self.q_blocks].sum())
        return lo, hi


def _build_x4(x_dev, gather_idx, f_pad, g, d_pad):
    """Block layout built on the device: one row gather of the resident
    points, zero-padded to the kernel's layout width."""
    rows = x_dev[gather_idx]
    if d_pad > rows.shape[1]:
        rows = torch.nn.functional.pad(rows, (0, d_pad - rows.shape[1]))
    return rows.reshape(f_pad, g, d_pad).to(torch.float32).contiguous()


def _block_centroids(x4, counts_dev):
    """Masked per-block centroid; count-0 (dummy) blocks are pushed to
    ``_DUMMY_CENTROID`` so ranking places them last."""
    g = x4.shape[1]
    live = (torch.arange(g, device=x4.device)[None, :]
            < counts_dev[:, None])  # (F, g)
    s = torch.sum(x4 * live[:, :, None], dim=1)
    c = s / torch.clamp(counts_dev, min=1)[:, None].to(x4.dtype)
    return torch.where((counts_dev > 0)[:, None], c,
                       torch.full_like(c, _DUMMY_CENTROID))


def _layout(cid, kd_perm, c, n, g):
    """Host layout arithmetic from cluster assignments ``cid`` (N,) and
    the kd rank -> cluster permutation: returns (order, layout_rows,
    blk_counts, blk_csum (int64), f_real, f_pad)."""
    rank_of = np.empty(c, dtype=np.int64)
    rank_of[kd_perm] = np.arange(c)
    order = np.argsort(rank_of[cid], kind="stable").astype(np.int32)

    sizes_r = np.bincount(rank_of[cid], minlength=c)  # by rank
    nblk = -(-sizes_r // g)                    # 0 for empty clusters
    f_real = int(nblk.sum())
    f_pad = _bucket16(f_real + 1)
    blk0 = np.concatenate([[0], np.cumsum(nblk)[:-1]])

    # per sorted row: block + intra position
    starts = np.concatenate([[0], np.cumsum(sizes_r)[:-1]])
    p = np.arange(n, dtype=np.int64)
    row_rank = rank_of[cid[order]]             # nondecreasing
    within_cluster = p - starts[row_rank]
    blk = blk0[row_rank] + within_cluster // g
    intra = within_cluster % g
    layout_rows = (blk * g + intra).astype(np.int32)

    blk_cluster = np.repeat(np.arange(c), nblk)        # (f_real,)
    within_blk = np.arange(f_real) - blk0[blk_cluster]
    blk_counts = np.zeros(f_pad, np.int32)
    blk_counts[:f_real] = np.clip(
        sizes_r[blk_cluster] - within_blk * g, 0, g)
    blk_csum = np.zeros(f_pad, np.int64)
    np.cumsum(blk_counts[:-1], out=blk_csum[1:])
    return order, layout_rows, blk_counts, blk_csum, f_real, f_pad


def _index_from_assignments(x_dev, cid, cent_host, g, q_blocks,
                            profiler=None) -> FineIndex:
    """The index of points ``x_dev`` (N, d) given their cluster ids and
    the cluster centroids (host arrays): kd-order the clusters, lay the
    points out in g-row blocks on the device."""
    prof = profiler or global_profiler()
    n, d = x_dev.shape
    c = len(cent_host)
    with prof.phase("ivf_layout_host", cells=n):
        # kd-order clusters so consecutive blocks (and the slots that
        # group them) are spatial neighbors
        kd_perm = _kd_order(cent_host)             # rank -> cluster
        order, layout_rows, blk_counts, blk_csum, f_real, f_pad = _layout(
            np.asarray(cid), kd_perm, c, n, g)
        gather_idx = np.zeros(f_pad * g, np.int64)
        gather_idx[layout_rows] = order
    d_pad = kernel_d_pad(d)
    dev = x_dev.device
    x4 = _build_x4(x_dev, torch.as_tensor(gather_idx, device=dev), f_pad, g,
                   d_pad)
    blk_counts_dev = torch.as_tensor(blk_counts, device=dev)
    cents = _block_centroids(x4, blk_counts_dev)
    return FineIndex(
        x4=x4, cents=cents, blk_counts=blk_counts,
        blk_counts_dev=blk_counts_dev,
        blk_csum_dev=torch.as_tensor(blk_csum.astype(np.int32), device=dev),
        layout_rows=layout_rows, order=order, g=g, q_blocks=q_blocks,
        n=n, d_pad=d_pad, f_real=f_real, _csum_host=blk_csum)


def build_fine_index(x_dev, n, d, seed=0, g=128, q_blocks=1,
                     target_rows=96, n_clusters=None,
                     kmeans_sample=524_288, kmeans_iters=8,
                     profiler=None) -> FineIndex:
    """Fit fine k-means, lay the points out in kd-ordered g-row blocks."""
    prof = profiler or global_profiler()
    if n_clusters is None:
        n_clusters = int(np.clip(n // target_rows, 4, 65536))
    c = int(min(n_clusters, max(n // 4, 1)))
    rng = np.random.RandomState(seed)
    dev = x_dev.device

    with prof.phase("ivf_kmeans", cells=n):
        n_fit = min(n, kmeans_sample)
        sub = (np.sort(rng.choice(n, n_fit, replace=False))
               if n_fit < n else None)
        fit_x = (x_dev[torch.as_tensor(sub, device=dev)]
                 if sub is not None else x_dev)
        # chunk so the (chunk, C) float32 distance tile stays <= ~1.4 GB
        chunk = int(np.clip(_pow2_up(int(3.5e8 // max(c, 1)) + 1) // 2,
                            256, 32_768))
        n_pad = _round_up(n_fit, chunk)
        if n_pad > n_fit:
            fit_x = torch.nn.functional.pad(fit_x, (0, 0, 0, n_pad - n_fit))
        valid = torch.arange(n_pad, device=dev) < n_fit
        init_idx = torch.as_tensor(rng.choice(n_fit, c, replace=False),
                                   device=dev)
        with prof.phase("ivf_kmeans_fit", cells=n_fit):
            cent = _kmeans_fit_matmul(fit_x, valid, init_idx, c,
                                      kmeans_iters, chunk)
        with prof.phase("ivf_kmeans_assign", cells=n):
            cid = fetch(_assign_chunked(x_dev, cent, chunk))
            cent_host = fetch(cent)

    with prof.phase("ivf_layout", cells=n):
        return _index_from_assignments(x_dev, cid, cent_host, g, q_blocks,
                                       profiler=prof)


# ---------------------------------------------------------------------------
# probe ranking (on device)
# ---------------------------------------------------------------------------


def _rank_blocks_centroid(cents, u):
    """(F_pad, u) int32 probe table: every block's u nearest blocks by
    centroid distance, one (F, F) matmul and an exact top-k for the whole
    index, a few thousand rows at a time.

    Each block's own id ranks first: its diagonal entry is set below every
    real distance instead of relying on the expansion
    ``|a|^2 - 2 a.b + |b|^2`` to round to the row's minimum.  Dummy blocks
    sit at ``_DUMMY_CENTROID`` and rank last; a distance that is not a
    number (an overflowed dummy against a dummy) is taken as +inf, so
    every id in the table is in range.
    """
    f_pad = cents.shape[0]
    cn = torch.sum(cents * cents, dim=1)
    rows = torch.arange(f_pad, device=cents.device)
    out = []
    for lo in range(0, f_pad, _RANK_ROW_BLOCK):
        hi = min(lo + _RANK_ROW_BLOCK, f_pad)
        d2 = cn[lo:hi, None] - 2.0 * (cents[lo:hi] @ cents.T) + cn[None, :]
        d2 = torch.nan_to_num(d2, nan=torch.inf, posinf=torch.inf,
                              neginf=-torch.inf)
        d2[rows[:hi - lo], rows[lo:hi]] = -torch.inf
        out.append(torch.topk(d2, u, dim=1, largest=False,
                              sorted=True).indices)
    return torch.cat(out).to(torch.int32)


# ---------------------------------------------------------------------------
# search
# ---------------------------------------------------------------------------


def _index_replicas(index: FineIndex, devices):
    """Per-device copies of the scoring operands (x4 / counts / csum),
    built once and cached on the index.  Slot scoring has no cross-slot
    communication, so a search over several devices is pure data
    parallelism over slot batches, each device scoring against a full
    replica."""
    key = tuple(str(torch.device(d)) for d in devices)
    cache = getattr(index, "_replicas", None)
    if cache is not None and cache[0] == key:
        return cache[1]
    reps = {d: (index.x4.to(d), index.blk_counts_dev.to(d),
                index.blk_csum_dev.to(d))
            for d in {torch.device(d) for d in devices}}
    index._replicas = (key, reps)
    return reps


def _score_slots(index: FineIndex, u: int, slot_ids: np.ndarray, k: int,
                 probe_cache: dict, devices=None):
    """Score a set of query slots at probe count ``u``; returns a list of
    (negd, idx, slot count) batches of device tensors on the index's
    device.

    The (F_pad, u) probe table is computed once per ``u`` on the device
    (``probe_cache`` spans pilot rounds and the full search) and sliced
    per batch.  A batch is one kernel launch with one thread block per
    query block, so the launch is sized to the card by the grid itself;
    batches only bound the output buffers (``_MAX_LAUNCH_ELEMS`` elements
    each of distances and ids), which makes a 1M-cell search one launch.
    With ``devices`` the slots are cut into at least one batch per device
    and the batches dealt round-robin, each launched on its device
    against that device's index replica (``_index_replicas``); a query
    block's result does not depend on its batch.
    """
    sel = np.asarray(slot_ids, np.int64)
    ns_real = len(sel)
    mq = index.q_blocks * index.g
    batch = max(1, _MAX_LAUNCH_ELEMS // (mq * k))
    if devices:
        batch = min(batch, max(1, -(-ns_real // len(devices))))
        reps = _index_replicas(index, devices)
    if u not in probe_cache:
        table = _rank_blocks_centroid(index.cents, u)
        if index.q_blocks > 1:
            # probe list of a multi-block slot: its first block's table
            # row (blocks in a slot are kd-adjacent, lists nearly equal)
            table = table[::index.q_blocks][: index.n_slots]
        probe_cache[u] = table
    table = probe_cache[u]
    home = index.x4.device
    out = []
    for bi, lo in enumerate(range(0, ns_real, batch)):
        sel_dev = torch.as_tensor(sel[lo:lo + batch], device=home)
        probe_b = table[sel_dev].contiguous()
        x4, counts, csum = (index.x4, index.blk_counts_dev,
                            index.blk_csum_dev)
        if devices:
            dev = torch.device(devices[bi % len(devices)])
            x4, counts, csum = reps[dev]
            sel_dev, probe_b = sel_dev.to(dev), probe_b.to(dev)
        negd, idx = score_blocks(
            x4, sel_dev.to(torch.int32), probe_b, counts, csum, k,
            g=index.g, q_blocks=index.q_blocks)
        out.append((negd.to(home), idx.to(home), len(sel_dev)))
    return out


def _cat(parts):
    return parts[0] if len(parts) == 1 else torch.cat(parts)


def _finalize(negd_flat, idx_flat, layout_rows, n):
    """Compact-row extraction + the self-neighbor contract, on the device.

    Row-gathers the N live layout rows (neighbor ids are already compact,
    emitted by the kernel), then enforces "self first at distance 0": the
    results are distance-sorted (descending neg-d2) and the self entry is
    at distance 0, so swapping it into column 0 exchanges equal keys and
    preserves sortedness.  Returns (indices (N, k) int32, dists (N, k)).
    """
    negd = negd_flat[layout_rows]
    idx = idx_flat[layout_rows]
    d = torch.sqrt(torch.clamp(-negd, min=0.0))
    rr = torch.arange(n, dtype=idx.dtype, device=idx.device)[:, None]
    col = torch.arange(idx.shape[1], device=idx.device)[None, :]
    selfcol = idx == rr
    has_self = selfcol.any(dim=1, keepdim=True)
    fi = torch.sum(torch.where(selfcol, col, 0), dim=1, keepdim=True)
    idx0 = idx[:, :1]
    d0 = d[:, :1]
    swap = (col == fi) & has_self & (fi > 0)
    out_i = torch.where(col == 0, rr, torch.where(swap, idx0, idx))
    out_d = torch.where(col == 0, torch.zeros_like(d),
                        torch.where(swap, d0, d))
    return out_i.to(torch.int32), out_d


def _pull_sample_rows(batches, sel_slots: np.ndarray, index: FineIndex,
                      q_compact: np.ndarray, k: int):
    """Neighbor ids (host, compact coords) for the sampled compact rows,
    pulled from per-batch device outputs: a few kilobytes.

    ``sel_slots`` is the (sorted) slot-id list the batches were launched
    over; every sampled row must belong to one of those slots."""
    lr = index.layout_rows[q_compact]
    mq = index.q_blocks * index.g
    slot_of = lr // mq
    within = lr % mq
    pos_of = np.searchsorted(sel_slots, slot_of)  # position in launch order
    got = np.empty((len(q_compact), k), np.int64)
    starts = np.cumsum([0] + [cnt for _, _, cnt in batches])
    for bi, (_, idx_dev, cnt) in enumerate(batches):
        in_b = (pos_of >= starts[bi]) & (pos_of < starts[bi] + cnt)
        if not in_b.any():
            continue
        qi = np.flatnonzero(in_b)
        rows = (pos_of[qi] - starts[bi]) * mq + within[qi]
        rows_dev = torch.as_tensor(rows, device=idx_dev.device)
        got[qi] = fetch(idx_dev.reshape(-1, k)[rows_dev])
    return got


@dataclasses.dataclass
class FineSearchResult:
    """Device-resident kNN in compact coordinates + the permutation."""

    indices: torch.Tensor  # (N, k) int32, compact coords
    dists: torch.Tensor    # (N, k) float32 ascending, self first
    order: np.ndarray      # (N,) original id of compact row r
    index: FineIndex
    u: int                 # final probe count (fine blocks)
    recall: float          # held-out verify-sample recall (-1 if unmeasured)
    history: tuple = ()    # pilot (u, calibration-recall) points


def ivf_knn_fine(points, k, seed=0, min_recall=0.9, recall_sample=512,
                 g=128, q_blocks=1, n_clusters=None, target_rows=96,
                 kmeans_sample=524_288, kmeans_iters=8, u0=None,
                 devices=None, profiler=None) -> FineSearchResult:
    """Two-level IVF self-kNN; returns device results (module docstring).

    ``points``: a tensor (kept on its device) or an array (moved to the
    configured device); the search computes in float32.  ``u0`` seeds the
    probe count (fine blocks); the pilot calibrates it against a measured
    exact-truth sample whose held-out half also verifies the full search
    (``min_recall=None`` disables both).  ``devices``: score the slots
    over these devices (names may repeat), each batch on its device
    against a replica of the index; the results equal a one-device
    search bit for bit.
    """
    prof = profiler or global_profiler()
    x_dev = (points if isinstance(points, torch.Tensor)
             else as_tensor(points)).to(torch.float32)
    n, d = x_dev.shape
    index = build_fine_index(
        x_dev, n, d, seed=seed, g=g, q_blocks=q_blocks,
        n_clusters=n_clusters, target_rows=target_rows,
        kmeans_sample=kmeans_sample, kmeans_iters=kmeans_iters,
        profiler=prof)
    f = index.f_real
    s = index.n_slots
    probe_cache = {}  # u -> (F_pad, u) device probe table
    u_max = min(_bucket16(f), index.f_pad - index.f_pad % CANDS_PER_STEP)
    u_max = max(u_max, CANDS_PER_STEP)
    if u0 is None:
        u0 = int(0.08 * f)  # a starting point; the pilot moves it
    u = int(np.clip(_bucket16(max(u0, CANDS_PER_STEP)), CANDS_PER_STEP,
                    u_max))

    # ---- pilot: calibrate u on a slot subsample; truth split in half so
    # verification is independent of calibration ----
    truth_ver = None
    pilot_stop = None
    history = []
    if min_recall is not None and s >= 96:
        rng_p = np.random.RandomState(seed + 17)
        n_pilot = min(s, max(24, s // 16))
        ps_ids = np.sort(rng_p.choice(s, n_pilot, replace=False))
        ranges = [index.slot_compact_range(int(si)) for si in ps_ids]
        pilot_cells = np.concatenate(
            [np.arange(lo, hi) for lo, hi in ranges if hi > lo])
        n_q = min(recall_sample, len(pilot_cells))
        q_compact = rng_p.choice(pilot_cells, n_q, replace=False)
        with prof.phase("ivf_exact_truth"):
            true_idx = exact_knn_sample(x_dev, index.order[q_compact], k,
                                        exact=False)
        half = n_q // 2
        cal_q, ver_q = q_compact[:half], q_compact[half:]
        truth_cal, truth_ver = true_idx[:half], true_idx[half:]

        while True:
            with prof.phase(f"ivf_pilot(u={u})"):
                batches = _score_slots(index, u, ps_ids, k, probe_cache,
                                       devices)
                got_c = _pull_sample_rows(batches, ps_ids, index, cal_q, k)
            rec = _recall_against(index.order[got_c], truth_cal, k)
            history.append((u, rec))
            if rec >= min_recall or u >= u_max:
                if rec < min_recall:
                    pilot_stop = "cap"
                print(f"# pp.ivf pilot: recall@{k} = {rec:.3f} at "
                      f"u={u} fine blocks ({u * g / n:.1%} coverage); "
                      "searching", file=sys.stderr)
                break
            if len(history) >= 2:
                (u0_, r0), (u1_, r1) = history[-2], history[-1]
                if r1 - r0 < 0.005:
                    pilot_stop = "plateau"
                    break
                alpha = np.log(r1 / max(r0, 1e-9)) / np.log(u1_ / u0_)
                alpha = float(np.clip(alpha, 0.15, 1.0))
            else:
                alpha = 0.37
            jump = (min_recall / max(rec, 1e-9)) ** (1.0 / alpha)
            min_jump = 1.15 if rec >= min_recall - 0.05 else 1.5
            new_u = int(min(u_max,
                            max(u * min(max(jump, min_jump), 4.0), u + 1)))
            new_u = min(_bucket16(new_u), u_max)
            print(f"# pp.ivf pilot: recall@{k} = {rec:.3f} < {min_recall}"
                  f" at u={u}; trying {new_u}", file=sys.stderr)
            u = new_u

    # ---- full search, verified on the held-out half ----
    layout_rows_dev = torch.as_tensor(index.layout_rows.astype(np.int64),
                                      device=x_dev.device)
    prev_rec = -1.0
    while True:
        with prof.phase(f"ivf_search(u={u})", cells=n):
            batches = _score_slots(index, u, np.arange(s), k, probe_cache,
                                   devices)
            negd_flat = _cat([b[0] for b in batches]).reshape(-1, k)
            idx_flat = _cat([b[1] for b in batches]).reshape(-1, k)
            del batches
            indices_dev, dists_dev = _finalize(negd_flat, idx_flat,
                                               layout_rows_dev, n)
            del negd_flat, idx_flat
        if min_recall is None:
            return FineSearchResult(indices_dev, dists_dev, index.order,
                                    index, u, -1.0, tuple(history))
        with prof.phase("ivf_recall_check"):
            if truth_ver is not None and len(truth_ver):
                got = fetch(indices_dev[torch.as_tensor(
                    ver_q, device=indices_dev.device)])
                rec = _recall_against(index.order[got], truth_ver, k)
            else:
                # small index (no pilot): materialize to the host and
                # measure on a fresh sample
                idx_host = np.empty((n, k), np.int32)
                idx_host[index.order] = index.order[fetch(indices_dev)]
                rec = measured_recall(x_dev, idx_host, k,
                                      sample=recall_sample, seed=seed,
                                      exact=False)
        if rec >= min_recall:
            return FineSearchResult(indices_dev, dists_dev, index.order,
                                    index, u, rec, tuple(history))
        plateaued = (prev_rec >= 0 and (rec - prev_rec) < 0.005) or \
            pilot_stop == "plateau"
        if u >= u_max or plateaued:
            reason = ("recall has plateaued (expander-regime data)"
                      if plateaued else
                      f"the probe count is at its cap ({u} of {f} fine "
                      "blocks)")
            warnings.warn(
                f"pp.ivf: measured recall@{k} = {rec:.3f} < min_recall = "
                f"{min_recall} and {reason}. Use method='pallas' (exact) "
                "if this matters for your analysis.")
            return FineSearchResult(indices_dev, dists_dev, index.order,
                                    index, u, rec, tuple(history))
        new_u = min(_bucket16(int(min(2 * u, u_max))), u_max)
        print(f"# pp.ivf: measured recall@{k} = {rec:.3f} < {min_recall}; "
              f"escalating u {u} -> {new_u}", file=sys.stderr)
        prev_rec = rec
        u = new_u
