"""Neighborhood Abundance Matrix (NAM) pipeline on one device.

Reimplements the reference's L2/L3 layers (``_nam.py``), following the
TPU package's ``tools/_nam.py``:

* graph diffusion of the cells-by-samples one-hot matrix (the hot SpMM,
  reference ``_nam.py:21-41``) with the adaptive kurtosis stopping rule
  (``_nam.py:56-71``);
* batch-kurtosis QC of neighborhoods (``_nam.py:78-99``);
* Gram-trick SVD of the standardized NAM (``_nam.py:102-115``);
* covariate/batch residualization with the cumulative ridge sweep
  (``_nam.py:118-177``).

The data-dependent loops (the diffusion stop and the ridge-sweep early
exit) are host loops with one scalar read per step; the per-step
diagnostic trails (kurtosis, R²) stay in device buffers and are printed
afterwards.  Only shape-changing decisions (QC column drops) sync a
small mask to the host.

Under a mesh (``mesh=``, ``parallel.make_mesh``) the diffusion is
sharded over the cell slots: through the halo exchange
(``parallel.halo``) on a locality-partitioned graph when the mesh splits
the cells and the format is the default or 'ell', else through the
row-sharded fallback (``parallel.sharded.diffusion_step``).  The NAM is
then gathered to the lead device, where the residualization runs.

Graph formats: 'bucketed' (the default) and 'ell'; a device-resident
graph (``graph.device.DeviceConnectivities``, what ``pp.neighbors`` stores
on cuda and on the IVF path) serves both as it is.  'block', 'hybrid' and
'banded' are opt-in (``set_graph_format``): the graph is locality-ordered
and packed once on the host, and 'banded' diffuses through the
hand-written CUDA kernel of ``ops.spmm_banded``.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Callable

import numpy as np
import pandas as pd
import torch

from ..core.results import Result
from ..graph.device import DeviceConnectivities
from ..graph.ell import EllGraph, from_scipy
from ..ops import linalg, moments, spmm
from ..utils.profiling import global_profiler
from ..utils.transfer import as_tensor, fetch, scalar, to_device
from ._out import select_output

_ELL_CACHE_KEY = "_cna_tpu_torch_ell_graph"
_FORMAT_KEY = "_cna_tpu_torch_graph_format"
_HALO_PLAN_KEY = "_cna_tpu_torch_halo_plan"
_DIFFUSION_PATH_KEY = "_cna_tpu_torch_diffusion_path"
_LOCALITY_FORMATS = ("block", "hybrid", "banded")
_FORMATS = ("ell", "bucketed") + _LOCALITY_FORMATS


def get_connectivity(data):
    """Fetch the cell-cell connectivity graph from an AnnData-like object.

    Accepts ``data.obsp['connectivities']`` (modern layout) or
    ``data.uns['neighbors']['connectivities']`` (pre-0.7.2 anndata layout),
    mirroring reference ``get_connectivity`` (``_nam.py:12-19``) without
    the package-version sniff: both locations are simply probed.
    """
    obsp = getattr(data, "obsp", None)
    if obsp is not None and "connectivities" in obsp:
        return obsp["connectivities"]
    uns = getattr(data, "uns", None)
    if uns is not None and "neighbors" in uns and "connectivities" in uns["neighbors"]:
        return uns["neighbors"]["connectivities"]
    raise KeyError(
        "no cell-cell graph found: expected data.obsp['connectivities'] "
        "(or data.uns['neighbors']['connectivities']); run a neighbors/"
        "graph-construction step first (e.g. cna_tpu_torch.pp.neighbors)"
    )


def set_graph_format(data, fmt: str) -> None:
    """Choose the device SpMM format for ``data``:

    * 'bucketed' (pipeline default) — degree-sorted per-width ELL buckets
      (``graph.buckets``): exact gather SpMM over ~nnz slots instead of
      N*K_p98, a win whenever the degree distribution is skewed;
    * 'ell' — single-width row-gather SpMM with a COO overflow tail.
    * 'block' / 'hybrid' — cluster-reordered dense tiles
      (``graph.blocks``; batched matmuls).
    * 'banded' — the slab kernel of ``ops.spmm_banded`` on a locality
      ordering (kd order of ``obsm['X_pca']``, else reverse
      Cuthill-McKee).  It can pay only when the ordered graph is actually
      banded; check ``BandedGraph.band_fraction()`` before committing a
      long run to it.  On the 1,000,000-cell synthetic manifold data
      (50 samples, 15 neighbours; NVIDIA H100 80GB HBM3, 700.00 W,
      ``chip_smoke.py``) the band fraction was 0.43, a diffusion step
      took 14.1 ms against 12.1 ms under the default format (the kernel's
      in-band product 0.48 ms of it, the rest the out-of-band spill
      gather in plain torch), and the one-time host packing 18.5 s.

    The three locality formats materialize a device-resident graph as a
    host CSR and pack it on the host once (profiling phase
    ``graph_pack``); the packed graph is cached in ``data.uns`` until the
    format is set again.
    """
    if fmt not in _FORMATS:
        raise ValueError(
            f"unknown graph format {fmt!r}; use 'ell', 'bucketed', "
            "'block', 'hybrid' or 'banded'")
    data.uns[_FORMAT_KEY] = fmt
    for key in [k for k in data.uns
                if isinstance(k, str) and k.startswith(_ELL_CACHE_KEY)]:
        del data.uns[key]


def get_device_graph(data, fmt=None):
    """Device graph for ``data`` in the configured format, cached in
    ``data.uns``.

    Returns (graph, reordering): None for 'ell'; for 'bucketed' the
    degree ``Reordering`` and for 'block' / 'hybrid' / 'banded' the
    locality ``Reordering`` whose permuted axes the graph is built on
    (callers permute the diffusion state in and out once per pipeline).
    A ``DeviceConnectivities`` is packed already and returns its own graph
    and cell ordering (the IVF compact order, or None) for 'ell' and
    'bucketed'; an explicit locality format materializes its host CSR.
    """
    conn = get_connectivity(data)
    if isinstance(conn, EllGraph):
        return conn, None
    uns = getattr(data, "uns", None)
    if fmt is None:
        fmt = uns.get(_FORMAT_KEY, "ell") if uns is not None else "ell"
    if isinstance(conn, DeviceConnectivities) \
            and fmt not in _LOCALITY_FORMATS:
        # packed on the device already; 'bucketed' is satisfied by the
        # device graph too (its mirror columns are width-fitted)
        return conn.ell, conn.ordering
    cache_key = f"{_ELL_CACHE_KEY}:{fmt}"
    if uns is not None:
        cached = uns.get(cache_key)
        if cached is not None and cached[0] is conn:
            return cached[1], cached[2]

    if fmt in _LOCALITY_FORMATS:
        from ..graph.blocks import (cluster_ordering, from_scipy_blocks,
                                    from_scipy_hybrid)
        from ..graph.reorder import permute_graph, rcm_ordering
        from ..ops.spmm_banded import banded_from_scipy

        prof = global_profiler()
        with prof.phase("graph_pack", cells=conn.shape[0]):
            csr = conn
            if isinstance(conn, DeviceConnectivities):
                # an explicit locality format: materialize the host CSR
                with prof.phase("graph_pack_csr"):
                    csr = conn.tocsr()
            obsm = getattr(data, "obsm", {})
            with prof.phase("graph_pack_ordering"):
                ordering = (cluster_ordering(obsm["X_pca"])
                            if "X_pca" in obsm else rcm_ordering(csr))
            with prof.phase("graph_pack_permute"):
                permuted = permute_graph(csr, ordering)
            with prof.phase("graph_pack_pack"):
                if fmt == "banded":
                    graph = banded_from_scipy(permuted)
                elif fmt == "hybrid":
                    graph = from_scipy_hybrid(permuted)
                else:
                    graph = from_scipy_blocks(permuted)
    elif fmt == "bucketed":
        from ..graph.buckets import degree_ordering, from_scipy_buckets
        from ..graph.reorder import permute_graph

        ordering = degree_ordering(conn)
        graph = from_scipy_buckets(permute_graph(conn, ordering))
    else:
        ordering = None
        graph = from_scipy(conn)
    if uns is not None:
        uns[cache_key] = (conn, graph, ordering)
    return graph, ordering


def get_halo_plan(data, n_shards):
    """Halo-exchange plan over ``n_shards`` cell shards, cached in uns.

    The cell axis is locality-ordered first (``graph.partition``: k-means
    clusters of ``obsm['X_pca']`` grown into graph-connected shards;
    reverse Cuthill-McKee without an embedding), so each shard owns a
    graph-clustered block and only true boundary rows enter the exchange.
    A device-resident graph is materialized as a host CSR for the
    planning (profiling phases ``halo_partition`` and ``halo_plan``).

    Returns ``(plan, ordering)``; ``ordering`` is the applied
    ``Reordering`` (None for an imported ``EllGraph``, planned in its own
    order).  ``(None, None)`` when a plan cannot represent the graph (an
    ``EllGraph`` carrying COO overflow edges): callers fall back to the
    row-sharded path.
    """
    from ..graph.reorder import permute_graph_unsorted
    from ..parallel.halo import build_halo_plan, build_halo_plan_csr

    graph = get_connectivity(data)
    uns = getattr(data, "uns", None)
    key = f"{_HALO_PLAN_KEY}:{n_shards}"
    if uns is not None:
        cached = uns.get(key)
        if cached is not None and cached[0] is graph:
            return cached[1], cached[2]

    prof = global_profiler()
    conn = graph
    if isinstance(conn, DeviceConnectivities):
        with prof.phase("halo_partition_csr"):
            conn = conn.tocsr()  # cached on the object
    ordering = None
    if isinstance(conn, EllGraph):
        if conn.n_overflow:
            return None, None
        with prof.phase("halo_plan", cells=conn.n_cells):
            plan = build_halo_plan(fetch(conn.indices), fetch(conn.weights),
                                   fetch(conn.colsums_raw), n_shards)
    else:
        obsm = getattr(data, "obsm", None) or {}
        with prof.phase("halo_partition", cells=conn.shape[0]):
            if "X_pca" in obsm:
                from ..graph.partition import partition_ordering
                from ..pp.pca import device_rep

                ordering = partition_ordering(
                    conn, device_rep(data, obsm["X_pca"]), n_shards)
            else:
                from ..graph.reorder import rcm_ordering

                ordering = rcm_ordering(conn)
        with prof.phase("halo_plan", cells=conn.shape[0]):
            # unsorted permute: the plan walks the edges in storage
            # order, so scipy's per-row column sort is skipped
            plan = build_halo_plan_csr(
                permute_graph_unsorted(conn, ordering), n_shards)
    if uns is not None:
        uns[key] = (graph, plan, ordering)
    return plan, ordering


def _adaptive_loop(s0, step, stats, maxnsteps, nsteps):
    """The adaptive diffusion loop, generic over the step.

    Replicates reference ``_nam``'s stepping (``_nam.py:56-71``): after
    each step compute the median (across cells) excess kurtosis of the
    count-normalized state over samples, and the 20th-percentile
    step-to-step R²; stop when the kurtosis drop is < 3 after >= 3 steps
    (or after exactly ``nsteps``), capped at ``maxnsteps``.  The host
    reads one scalar per step, and only once the stopping rule can fire.

    ``step``: callable s -> s' (one diffusion update); ``stats``:
    callable (s', s or None for the all-zero start) -> (median kurtosis,
    per-column R²), both on ``s0.device``: ``_local_stats`` for a
    tensor state, ``parallel.sharded.diffusion_stats`` for a sharded one.

    Returns (s_final, steps_taken, medkurt trail, R² trail); the trails
    are (maxnsteps,) device buffers whose entries past ``steps_taken``
    hold an inf sentinel.  The span ``diffusion`` counts the ``steps`` and,
    as ``spmm_kernel``, the steps whose ``ops.spmm.diffusion_step`` launched
    the gather SpMM kernel (every step on the card, none on the CPU).
    """
    prof = global_profiler()
    opts = dict(dtype=s0.dtype, device=s0.device)
    mk_buf = torch.full((maxnsteps,), torch.inf, **opts)
    r2_buf = torch.full((maxnsteps,), torch.inf, **opts)
    s, old_s = s0, None
    prevmedkurt = torch.tensor(torch.inf, **opts)
    i = 0
    with prof.phase("diffusion"):
        prof.count("spmm_kernel", 0)  # the steps add to it
        while i < maxnsteps:
            s_new = step(s)
            medkurt, r2 = stats(s_new, old_s)
            # +inf marks zero-variance columns; numpy's percentile would be
            # NaN if any column were NaN, so propagate the sentinel the
            # same way
            inf_r2 = torch.isinf(r2)
            r2p20 = torch.where(
                inf_r2.any(), torch.inf,
                moments.quantile(torch.where(inf_r2, 2.0, r2), 0.2))
            mk_buf[i] = medkurt
            r2_buf[i] = r2p20
            i += 1
            if nsteps is None:
                done = i >= 3 and bool(scalar(prevmedkurt - medkurt < 3))
            else:
                done = i >= nsteps
            s, old_s, prevmedkurt = s_new, s_new, medkurt
            if done:
                break
        prof.count("steps", i)
    return s, i, mk_buf, r2_buf


def _local_stats(c_counts, n_cells):
    """The loop's statistics of a tensor state whose rows past
    ``n_cells`` are padding."""
    def stats(s_new, old_s):
        kurt = moments.kurtosis(s_new / c_counts[None, :], axis=1)[:n_cells]
        old = torch.zeros_like(s_new) if old_s is None else old_s
        return (moments.median(kurt),
                moments.column_r2_counted(s_new, old, n_cells))
    return stats


def _sharded_stats(c_counts, n_cells):
    """The loop's statistics of a cell-sharded state whose rows past
    ``n_cells`` are padding."""
    from ..parallel.sharded import diffusion_stats

    def stats(s_new, old_s):
        return diffusion_stats(s_new, old_s, c_counts, n_cells)
    return stats


@dataclasses.dataclass
class _Diffusion:
    """A diffusion set up on the path ``_diffusion`` chose.

    The state's rows are the cells in the order ``order`` (a
    ``Reordering``; None: the caller's order), then all-zero padding up to
    ``n_rows``.  ``onehot`` places the one-hot of such padded sample codes
    as the state, ``step`` takes one diffusion step of a state,
    ``stats(c_counts, n_cells)`` gives ``_adaptive_loop``'s statistics and
    ``gather`` brings a final state to ``device`` as a tensor; ``device``
    and ``dtype`` are those of the sample counts and the NAM.  ``note``
    is a line on the path for the progress output, or None."""

    path: str
    order: object
    n_rows: int
    dtype: torch.dtype
    device: torch.device
    onehot: Callable
    step: Callable
    stats: Callable
    gather: Callable
    note: str | None = None

    def pad(self, codes):
        """Per-cell sample codes in the state's row order, padded with -1
        (an all-zero one-hot row) to ``n_rows``."""
        if self.order is not None:
            codes = codes[self.order.perm]
        return np.pad(codes, (0, self.n_rows - codes.shape[0]),
                      constant_values=-1)

    def restore(self, s, n_cells):
        """The ``n_cells`` cells of a tensor state, in the caller's
        order."""
        if self.order is None:
            return s[:n_cells]
        return s[torch.as_tensor(self.order.inv, device=s.device).long()]


def _diffusion(data, mesh, n_samples, self_weight, fmt=None):
    """Choose the diffusion's path for ``data`` and set it up.

    'halo' when ``mesh`` splits the cells and no format other than 'ell'
    is set (``get_halo_plan``; a graph without a plan falls through);
    'gspmd' under any other mesh, which shards the rows of an ``EllGraph``
    (``parallel.sharded``) and runs any other graph unsharded, as the TPU
    package's GSPMD program runs a graph it does not shard; 'local'
    without one.  A local graph is the format ``fmt`` (default: the one
    set, else 'bucketed', or 'ell' under a mesh, whose row split keeps
    plain ELL rows) or a device graph as it is."""
    uns = getattr(data, "uns", None)
    user_fmt = uns.get(_FORMAT_KEY) if uns is not None else None
    if mesh is not None:
        from ..parallel import dist, sharded
        from ..parallel.mesh import CELLS, Sharded, cell_rows, place

        rows = cell_rows(mesh)
        cell_shards = mesh.shape[CELLS]
        plan = None
        if cell_shards > 1 and user_fmt in (None, "ell"):
            plan, order = get_halo_plan(data, cell_shards)
        if plan is not None:
            from ..parallel.halo import halo_diffusion_step, place_plan

            placed = place_plan(plan, mesh)
            n_pad = plan.n_shards * plan.shard_rows

            def onehot(codes):
                # each cell slot builds its own rows on its device
                return Sharded(rows, (n_pad, n_samples), plan.dtype, {
                    cp: _onehot_device(codes[rows.bounds((n_pad,), cp)],
                                       n_samples, plan.dtype,
                                       mesh.device(cp))
                    for cp in rows.primaries if mesh.is_local(cp)})

            return _Diffusion(
                "halo", order, n_pad, plan.dtype, mesh.lead_device, onehot,
                lambda s: halo_diffusion_step(s, placed, mesh, self_weight),
                _sharded_stats, dist.gather,
                f"\thalo diffusion over {cell_shards} cell shards: ghost "
                f"fraction {plan.ghost_fraction():.3f}")
    if fmt is None and user_fmt is None:
        fmt = "ell" if mesh is not None else "bucketed"
    graph, ordering = get_device_graph(data, fmt=fmt)
    dtype, dev = graph.dtype, graph.device
    colsums = graph.colsums(self_weight)
    if mesh is None or ordering is not None \
            or not isinstance(graph, EllGraph):
        return _Diffusion(
            "local" if mesh is None else "gspmd", ordering, graph.n_rows,
            dtype, dev,
            lambda codes: _onehot_device(codes, n_samples, dtype, dev),
            lambda s: spmm.diffusion_step(s, graph, colsums, self_weight),
            _local_stats, lambda s: s)
    # an EllGraph's rows over the cell slots, the scaled state all-gathered
    # every step
    graph_sh = sharded.shard_graph(graph, mesh)
    return _Diffusion(
        "gspmd", None, graph.n_rows, dtype, mesh.lead_device,
        lambda codes: place(_onehot_device(codes, n_samples, dtype, dev),
                            rows),
        lambda s: sharded.diffusion_step(s, graph_sh, colsums, self_weight,
                                         mesh),
        _sharded_stats, dist.gather)


def diffuse_stepwise(data, s, maxnsteps=15, show_progress=False, self_weight=1):
    """Generator over lazy-random-walk diffusion steps of ``s``.

    Public low-level primitive (reference ``_nam.py:21-34``).  ``s`` may be
    a pandas DataFrame (cells x anything) or an array; a DataFrame input
    yields DataFrames with its labels, any other input yields tensors.
    """
    out = select_output(show_progress)
    labels = None
    if isinstance(s, pd.DataFrame):
        labels = (s.index, s.columns)
        s = s.to_numpy()
    # the 'ell' graph of the local path; a device graph may live in a
    # permuted (compact) cell order: step in that order, yield every step
    # in the caller's order
    diff = _diffusion(data, None, None, self_weight, fmt="ell")
    s = to_device(s, diff.device, diff.dtype)
    n_cells = s.shape[0]
    if diff.order is not None:
        s = s[torch.as_tensor(diff.order.perm, device=s.device).long()]
    for i in range(maxnsteps):
        out("\ttaking step", i + 1)
        s = diff.step(s)
        s_out = diff.restore(s, n_cells)
        if labels is not None:
            yield pd.DataFrame(fetch(s_out), index=labels[0],
                               columns=labels[1])
        else:
            yield s_out


def diffuse(data, s, nsteps, show_progress=False, self_weight=1):
    """Run exactly ``nsteps`` diffusion steps (reference ``_nam.py:36-41``)."""
    for s in diffuse_stepwise(
        data, s, maxnsteps=nsteps, show_progress=show_progress,
        self_weight=self_weight,
    ):
        pass
    return s


@dataclasses.dataclass
class NamArrays:
    """Device-resident NAM with its labels.

    ``nam``: (n_samples, n_cells) — sample s's relative abundance in each
    cell's diffused neighborhood (the transpose at reference ``_nam.py:73``).
    """

    nam: torch.Tensor
    samples: pd.Index
    cells: pd.Index
    nsteps: int = 0

    def to_df(self) -> pd.DataFrame:
        return pd.DataFrame(fetch(self.nam), index=self.samples,
                            columns=self.cells)


def _onehot_device(codes, n_samples, dtype, device):
    """(N,) int sample codes -> (N, n_samples) one-hot on the device.

    Code -1 (filtered/padding cell) produces an all-zero row.
    """
    codes = torch.as_tensor(codes, device=device)
    samples = torch.arange(n_samples, device=device)
    return (codes[:, None] == samples[None, :]).to(dtype)


def _nam(data, sid_name, sids=None, nsteps=None, maxnsteps=15, self_weight=1,
         show_progress=False, mesh=None) -> NamArrays:
    """Build the NAM via diffusion with the adaptive kurtosis stop.

    Mirrors reference ``_nam`` (``_nam.py:44-76``): one-hot cells->samples,
    diffuse until the median per-cell excess kurtosis (across samples, on
    count-normalized state) drops by <3 between steps (minimum 3 steps),
    or exactly ``nsteps`` if given; normalize by per-sample cell counts and
    transpose.  Records the diffusion path taken in
    ``uns['_cna_tpu_torch_diffusion_path']``: 'halo', 'gspmd' (the
    row-sharded fallback under a mesh) or 'local'.
    """
    out = select_output(show_progress)

    # cells->samples one-hot (reference ``_nam.py:51`` pd.get_dummies):
    # column order is sorted uniques, or the category order (including
    # unused categories) for categorical dtype.  Only the code vector
    # crosses to the device; the (N, S) one-hot is built there.
    obs_sids = data.obs[sid_name]
    if isinstance(obs_sids.dtype, pd.CategoricalDtype):
        codes = obs_sids.cat.codes.to_numpy().astype(np.int64)
        samples = pd.Index(obs_sids.cat.categories)
    else:
        codes64, cats = pd.factorize(obs_sids, sort=True)
        codes = codes64.astype(np.int64)
        samples = pd.Index(cats)
    if sids is not None:
        sids = pd.Index(sids)
        col_pos = samples.get_indexer(sids)
        if (col_pos < 0).any():
            raise KeyError(list(sids[col_pos < 0][:5]))
        code_map = np.full(len(samples) + 1, -1, dtype=np.int64)
        code_map[col_pos] = np.arange(len(sids), dtype=np.int64)
        codes = code_map[codes]  # codes==-1 (NaN sid) stays -1 via [-1]
        samples = sids
    n_samples = len(samples)
    cells = data.obs.index
    n_cells = len(cells)
    c_counts_host = np.bincount(codes[codes >= 0], minlength=n_samples)

    diff = _diffusion(data, mesh, n_samples, self_weight)
    s0 = diff.onehot(diff.pad(codes))
    c_counts = torch.as_tensor(c_counts_host, dtype=diff.dtype,
                               device=diff.device)
    s, steps_taken, mk_buf, r2_buf = _adaptive_loop(
        s0, diff.step, diff.stats(c_counts, n_cells), maxnsteps, nsteps)
    uns = getattr(data, "uns", None)
    if uns is not None:
        uns[_DIFFUSION_PATH_KEY] = diff.path
    if out.enabled:
        if diff.note is not None:
            out(diff.note)
        _print_diffusion_trail(out, mk_buf, r2_buf, steps_taken, nsteps,
                               maxnsteps)
    s = diff.restore(diff.gather(s), n_cells)
    nam = (s / c_counts[None, :]).T  # (samples, cells)
    return NamArrays(nam=nam, samples=samples, cells=cells, nsteps=steps_taken)


def _print_diffusion_trail(out, mk_buf, r2_buf, steps_taken, nsteps,
                           maxnsteps):
    """Print the per-step kurtosis/R² diagnostic trail (the reference's
    documented UX — its demo tells users to read this, ``_nam.py:62-66``)."""
    mk = fetch(mk_buf)
    # render the zero-variance sentinel (+inf) as the nan the reference
    # prints for the same situation (step 1, ``_nam.py:56-61``)
    r2 = fetch(r2_buf).copy()
    r2[np.isinf(r2)] = np.nan
    for i in range(steps_taken):
        out("\ttaking step", i + 1)
        out("\tmedian kurtosis:", mk[i] + 3)
        out("\t20th percentile R2(t,t-1):", r2[i])
    if nsteps is None and steps_taken < maxnsteps:
        out("stopping after", steps_taken, "steps")


def _encode_batches(batches: pd.Series, samples: pd.Index, device):
    """Align sample-level batch labels to ``samples`` and encode as int ids
    in sorted-unique order (matching ``np.unique`` iteration at reference
    ``_nam.py:81``)."""
    aligned = batches.reindex(samples)
    uniq, ids = np.unique(aligned.to_numpy(), return_inverse=True)
    return uniq, torch.as_tensor(ids.astype(np.int64), device=device), len(uniq)


def _qc_nam_arrays(nam_arrays: NamArrays, batches: pd.Series, show_progress=False):
    """Drop batchy neighborhoods (reference ``_qc_nam``, ``_nam.py:85-99``).

    Returns (filtered NamArrays, keep bool array over cells).
    """
    out = select_output(show_progress)
    _, ids, nb = _encode_batches(batches, nam_arrays.samples,
                                 nam_arrays.nam.device)
    if nb == 1:
        keep = np.repeat(True, nam_arrays.nam.shape[1])
        return nam_arrays, keep

    prof = global_profiler()
    with prof.phase("batch_qc"):
        kurt = fetch(moments.batch_kurtosis(nam_arrays.nam, ids, nb))
        threshold = max(6, 2 * np.median(kurt))
        out("throwing out neighborhoods with batch kurtosis >=", threshold)
        keep = kurt < threshold
        out("keeping", keep.sum(), "neighborhoods")
        prof.count("dropped", int(keep.size - keep.sum()))

        keep_idx = torch.as_tensor(np.nonzero(keep)[0],
                                   device=nam_arrays.nam.device)
        filtered = NamArrays(
            nam=nam_arrays.nam[:, keep_idx],
            samples=nam_arrays.samples,
            cells=nam_arrays.cells[keep],
            nsteps=nam_arrays.nsteps,
        )
    return filtered, keep


def svd_nam(NAM):
    """SVD of a (samples x neighborhoods) NAM via the S x S Gram matrix.

    Mirrors reference ``svd_nam`` (``_nam.py:102-115``): center and
    standardize columns (pandas ddof=1), then eigen-decompose the Gram.
    Returns labeled (U DataFrame, squared-singular-value Series, V
    DataFrame) with PC1.. columns.
    """
    if isinstance(NAM, pd.DataFrame):
        index, columns = NAM.index, NAM.columns
        arr = as_tensor(NAM.to_numpy())
    else:
        arr = NAM if isinstance(NAM, torch.Tensor) else as_tensor(NAM)
        index = pd.RangeIndex(arr.shape[0])
        columns = pd.RangeIndex(arr.shape[1])
    _, u, svs, v = linalg.standardize_and_gram_svd(arr)
    pcs = ["PC" + str(i) for i in range(1, u.shape[1] + 1)]
    return (
        pd.DataFrame(fetch(u), index=index, columns=pcs),
        pd.Series(fetch(svs), index=pcs),
        pd.DataFrame(fetch(v), index=columns, columns=pcs),
    )


_DEFAULT_RIDGES = (1e5, 1e4, 1e3, 1e2, 1e1, 1e0, 1e-1, 1e-2, 1e-3, 1e-4, 0)


def _ridge_sweep(nam_c, c, ridges, batch_ids, n_batch_cols, num_batches):
    """The cumulative ridge residualization sweep.

    Applies the projectors of reference ``_nam.py:141-156``, with its
    compounding across iterations and last-M-wins: for each ridge in the
    schedule build ``M = I - C (C'C + ridge*n*L)^-1 C'``, apply it on top
    of the earlier ones, and stop once the median batch kurtosis of the
    running NAM is <= 6.  The projectors are composed on the sample axis
    (``M_cum = M_i @ ... @ M_1``, S x S), each step reads the running
    NAM's per-batch means as ``(G @ M_cum) @ nam_c`` (``G`` the B x S
    averaging matrix), and the NAM is multiplied once, ``M_cum @ nam_c``,
    after the stop; float64 rounding is the only difference from the
    reference's ``NAM_ = M @ NAM_`` at every step.

    Returns (nam_resid, M_last, n_ridges_used, median-kurtosis trail);
    trail entries past the exit hold an inf sentinel.  Profiling span
    ``ridge_sweep``, counters ``ridges`` (the steps taken) and
    ``nam_products`` (the S x S by S x N products: the one after the stop).
    """
    prof = global_profiler()
    nridges = ridges.shape[0]
    opts = dict(dtype=nam_c.dtype, device=nam_c.device)
    medk_buf = torch.full((nridges,), torch.inf, **opts)
    g = moments.group_mean_weights(batch_ids, num_batches, nam_c.dtype)
    m_proj = torch.eye(nam_c.shape[0], **opts)
    m_cum = m_proj
    i = 0
    with prof.phase("ridge_sweep"):
        while i < nridges:
            m_proj = linalg.residual_projector(c, ridge=ridges[i],
                                               n_batch_cols=n_batch_cols)
            m_cum = m_proj @ m_cum
            kurt = moments.pearson_kurtosis_of_means((g @ m_cum) @ nam_c)
            medk = moments.median(kurt)
            medk_buf[i] = medk
            i += 1
            if bool(scalar(medk <= 6)):
                break
        nam_r = m_cum @ nam_c
        prof.count("ridges", i)
        prof.count("nam_products", 1)
    return nam_r, m_proj, i, medk_buf


def _resid_nam_core(arr, covs_arr, batches, samples, ridges=None,
                    show_progress=False):
    """Device core of the residualization: returns a dict of tensors.

    ``arr``: (n, cells) NAM rows aligned to ``samples``.  Profiling span
    ``gram_svd``: the standardization and Gram eigendecomposition.
    """
    out = select_output(show_progress)
    n = arr.shape[0]
    single_batch = batches is None or len(np.unique(batches)) == 1
    # the ridge sweep runs in float64 whatever the NAM's dtype.  A ridge
    # shrinks near-equal batches' means alike, which leaves their kurtosis
    # as it was, so the stop comes at small ridges, where the batch means
    # are small enough for float32 rounding to move the kurtosis across 6
    # (a float32 sweep can stop a ridge early); and the last projector may
    # come from a singular system (the centred dummies sum to zero), which
    # float32 solves about 1e-6 off
    wide = arr.dtype if single_batch else torch.float64
    opts = dict(dtype=wide, device=arr.device)

    nam_c = arr.to(wide)
    nam_c = nam_c - nam_c.mean(dim=0)
    if covs_arr is None:
        covs_arr = torch.zeros((n, 0), **opts)
    else:
        covs_arr = moments.standardize(torch.as_tensor(np.array(covs_arr),
                                                       **opts),
                                       ddof=1, axis=0)

    if single_batch:
        c = covs_arr
        m_proj = linalg.residual_projector(c)
        nam_r = m_proj @ nam_c
    else:
        b_dummies = pd.get_dummies(batches)
        b_arr = moments.standardize(
            torch.as_tensor(np.array(b_dummies, dtype=float), **opts),
            ddof=1, axis=0)
        c = torch.cat([b_arr, covs_arr], dim=1)
        nbcols = b_arr.shape[1]
        _, ids, nb = _encode_batches(batches, samples, arr.device)

        ridge_schedule = torch.as_tensor(
            ridges if ridges is not None else _DEFAULT_RIDGES, **opts)
        nam_r, m_proj, nridges, medk_buf = _ridge_sweep(
            nam_c, c, ridge_schedule, ids, nbcols, nb)
        del nam_c  # one float64 NAM alive beside the cast, not two
        nam_r, m_proj = nam_r.to(arr.dtype), m_proj.to(arr.dtype)
        if out.enabled:
            medk = fetch(medk_buf)
            sched = fetch(ridge_schedule)
            for i in range(nridges):
                out("\twith ridge", sched[i], "median batch kurtosis = ",
                    medk[i])

    # standardize (pandas ddof=1, no recentering — reference ``_nam.py:159``;
    # the exposed namresid is THIS matrix, while svd_nam additionally
    # centers+standardizes its own local copy, reference ``:103-104,163``)
    nam_r = nam_r / moments.colstd(nam_r, ddof=1, axis=0)[None, :]
    with global_profiler().phase("gram_svd"):
        _, u, svs, v = linalg.standardize_and_gram_svd(nam_r)
    return dict(m=m_proj, r=int(c.shape[1]), namresid=nam_r, u=u, svs=svs,
                v=v)


def _resid_nam(NAM, covs, batches, ridges=None, npcs=None, show_progress=False):
    """Residualize covariates/batches out of the NAM, standardize, SVD.

    Mirrors reference ``_resid_nam`` (``_nam.py:118-177``): the ridge
    sweep applies the same projectors, composed on the sample axis (so
    float64 rounding is the only difference from the reference's
    cumulative ``NAM_ = M @ NAM_``), with the last-M-wins coupling into
    the association test.

    ``NAM`` may be a DataFrame (samples x cells) or a ``NamArrays``.
    Returns a ``Result`` with the reference's fields (large DataFrames
    materialized lazily from device tensors) plus the device ``_dev``
    tensors used by the association core.
    """
    if isinstance(NAM, NamArrays):
        samples, cells = NAM.samples, NAM.cells
        arr = NAM.nam
    else:
        samples, cells = NAM.index, NAM.columns
        arr = as_tensor(NAM.to_numpy(dtype=float))

    covs_arr = None if covs is None else covs.to_numpy(dtype=float)
    dev = _resid_nam_core(arr, covs_arr, batches, samples, ridges=ridges,
                          show_progress=show_progress)
    n = arr.shape[0]
    if npcs is None:
        npcs = int(dev["v"].shape[1])

    pcs = ["PC" + str(i) for i in range(1, dev["u"].shape[1] + 1)]
    res = Result()
    res._dev = Result(samples=samples, cells=cells, **dev)
    res.r = dev["r"]
    res.set_lazy("M", lambda: pd.DataFrame(
        fetch(dev["m"]), index=samples, columns=samples))
    res.set_lazy("namresid", lambda: pd.DataFrame(
        fetch(dev["namresid"]), index=samples, columns=cells))
    res.set_lazy("namresid_sampleXpc", lambda: pd.DataFrame(
        fetch(dev["u"]), index=samples, columns=pcs))
    res.set_lazy("namresid_nbhdXpc", lambda: pd.DataFrame(
        fetch(dev["v"]), index=cells, columns=pcs))
    res.set_lazy("namresid_svs", lambda: pd.Series(
        fetch(dev["svs"]), index=pcs)[:npcs])
    res.set_lazy("namresid_varexp", lambda: pd.Series(
        fetch(dev["svs"]), index=pcs) / n / len(cells))
    return res


def nam(data, sid_name, batches=None, nsteps=None, self_weight=1,
        max_frac_pcs=0.15, suffix="", ks=None, show_progress=False,
        mesh=None, **kwargs):
    """Compute and QC the NAM (public wrapper, reference ``_nam.py:179-193``).

    ``max_frac_pcs``/``ks``/``**kwargs`` are accepted and ignored so that
    ``association`` can forward one kwargs bag to both pipeline stages,
    exactly as the reference does.  ``mesh``: diffuse over its cell slots
    (``nam_arrays``).

    Returns (NAM DataFrame [samples x kept-cells] as float, keep bool array).
    """
    nam_qc, keep = nam_arrays(data, sid_name, batches=batches, nsteps=nsteps,
                              self_weight=self_weight,
                              show_progress=show_progress, mesh=mesh)
    return nam_qc.to_df().astype(float), keep


def nam_arrays(data, sid_name, batches=None, nsteps=None, self_weight=1,
               show_progress=False, mesh=None, nam_savepoint=None, **kwargs):
    """Device-resident variant of ``nam``: returns (NamArrays, keep).

    ``nam_savepoint``: optional path to a fingerprint-keyed diffusion
    savepoint (see ``utils.checkpoint``).  The reference deliberately
    never caches the NAM (its README.md:22, v0.2.0), so this is opt-in;
    a changed graph/sample-assignment/step-count misses rather than
    serving a stale matrix.  ``mesh``: a ``parallel.make_mesh`` mesh whose
    cell slots share the diffusion (``_nam``); the NAM comes back on its
    lead device.
    """
    out = select_output(show_progress)

    if batches is None:
        sids = data.obs[sid_name].unique()
        batches = pd.Series(np.ones(len(sids)), index=sids)

    arrays = None
    fingerprint = None
    if nam_savepoint is not None:
        from ..utils import checkpoint as ckpt

        fingerprint = ckpt.nam_fingerprint(data, sid_name, nsteps=nsteps,
                                           self_weight=self_weight)
        hit = ckpt.load_nam(nam_savepoint, fingerprint)
        if hit is not None:
            out("loading NAM from savepoint")
            nam_df, _, saved_nsteps = hit
            arrays = NamArrays(nam=as_tensor(nam_df.to_numpy()),
                               samples=pd.Index(nam_df.index),
                               cells=pd.Index(nam_df.columns),
                               nsteps=saved_nsteps)

    if arrays is None:
        out("computing NAM")
        arrays = _nam(data, sid_name, nsteps=nsteps, self_weight=self_weight,
                      show_progress=show_progress, mesh=mesh)
        if nam_savepoint is not None:
            ckpt.save_nam(nam_savepoint, arrays.to_df(), fingerprint,
                          nsteps=arrays.nsteps)
    return _qc_nam_arrays(arrays, batches, show_progress=show_progress)
