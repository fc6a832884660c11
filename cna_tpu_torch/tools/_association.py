"""Global and local (neighborhood) association testing on one device.

Reimplements reference ``_association.py`` (following the TPU package's
``tools/_association.py``) with the three host hot loops replaced by
batched tensor programs:

* HOT LOOP 2 (null min-p F-tests, reference ``_association.py:84``): all
  Nnull permutations scored in one projector-matmul + cumsum batch
  (``ops.ftest.minp_stats_batch``).
* HOT LOOP 3 (null neighborhood coefficients, ``:96-99``): a single
  (cells x S) @ (S x Nnull) matmul, fused with the FDR histogram above
  ``_FUSED_FDR_MIN_ELEMENTS``.
* The empirical-FDR histogram trick (``_stats.py:34-83``) as a collapsed
  histogram on the device (``ops.fdr``).

Under a mesh (``mesh=``) the diffusion is sharded over the cell slots
(``tools._nam``), the null min-p columns over the perms slots and the
null coefficients (or their fused tail counts) over (cells, perms) tiles
(``parallel.sharded``).
"""

from __future__ import annotations

import warnings

import numpy as np
import pandas as pd
import torch

from ..core.results import Result
from ..ops import fdr as fdr_ops
from ..ops import ftest, moments, permutations
from ..parallel import dist, sharded
from ..utils import checks
from ..utils.profiling import global_profiler
from ..utils.transfer import as_tensor, fetch, fetch_many
from ._nam import NamArrays, _resid_nam, nam, nam_arrays
from ._out import select_output

# local-test size (cells x local nulls) above which the FDR histogram is
# fused with the null-coefficient matmul instead of materializing the
# (cells x Nnull) matrix; module-level so tests can force either branch
_FUSED_FDR_MIN_ELEMENTS = 250_000_000


def _assoc_observed(u, m_proj, namresid, y, ks, r):
    """Observed-phenotype stage.

    Standardize y (numpy ddof=0, reference ``:22``), min-p F-test over the
    PC grid (``:50-64``), conditional-model coefficients (``:70-74`` —
    with the reference's pandas ddof=1 scaling of ycond, to which the
    F-test is invariant but beta/yresid are not), and neighborhood
    coefficients from the FULL-RANK residualized NAM vs standardized y
    (``:77``).

    beta is returned over ALL PCs; the caller slices the first k.
    """
    y = (y - y.mean()) / y.std(correction=0)
    n = y.shape[0]
    k_arr, p_arr, r2_arr = ftest.minp_stats_batch(u, m_proj, y[:, None], ks, r)
    k = k_arr[0]
    ycond = m_proj @ y
    ycond = ycond / moments.colstd(ycond[:, None], ddof=1, axis=0)[0]
    beta_full = u.T @ ycond
    pcs = torch.arange(u.shape[1], device=u.device)
    beta_masked = torch.where(pcs < k, beta_full, torch.zeros_like(beta_full))
    yhat = u @ beta_masked
    r2_perpc_full = (beta_full / torch.sqrt(ycond @ ycond)) ** 2
    ncorrs = (namresid.T @ y) / n
    # scalar pulled early by the caller to build the FDR threshold grid
    # (reference ``:101`` floor incl.)
    maxcorr = torch.clamp(torch.max(torch.abs(ncorrs)), min=0.001)
    return (k, p_arr[0], r2_arr[0], ycond, yhat, beta_full, r2_perpc_full,
            ncorrs, maxcorr)


def _assoc_null(u, m_proj, y_, ks, r, n_local, local_test):
    """Null-scoring stage: min-p F-tests over all null columns (HOT LOOP
    2, ``:84``) and, when ``local_test``, the standardized projected
    nulls that drive the local test (the null coefficient matmul itself,
    HOT LOOP 3, happens downstream with the FDR histogram)."""
    _, nullminps, nullr2s = ftest.minp_stats_batch(u, m_proj, y_, ks, r)
    if not local_test:
        return nullminps, nullr2s, None
    return nullminps, nullr2s, _null_ycond(m_proj, y_, n_local)


def _null_ycond(m_proj, y_, n_local):
    """The standardized projected nulls of the local test: pandas ddof=1
    std (reference's M.dot(y_) is a DataFrame); the null coefficient
    scale feeds the FDR thresholds directly."""
    return moments.scale_by_std(m_proj @ y_[:, :n_local], ddof=1, axis=0)


def _null_ncorrs(namresid, ycond_):
    """Materialized null neighborhood coefficients (cells x n_local)."""
    return torch.abs(namresid.T @ ycond_) / ycond_.shape[0]


def _association(NAMsvd, NAMresid, M, r, y, batches, donorids, ks=None,
                 Nnull=1000, force_permute_all=False, local_test=True,
                 seed=None, show_progress=False, null_y=None, mesh=None):
    """Core association test given a residualized NAM decomposition.

    Mirrors reference ``_association`` (``_association.py:10-129``).
    Inputs may be numpy arrays or tensors; ``NAMsvd = (U, svs, V)``.

    ``null_y``: optional precomputed (n, Nnull) matrix of permuted
    phenotypes, for exact regression tests (no random stream can be
    replicated across frameworks) and externally generated nulls.
    ``seed`` seeds the ``torch.Generator`` of the permutations.  ``mesh``:
    score the null columns over its perms slots and the null coefficients
    over its (cells, perms) slots; every process of the mesh runs this with
    the same inputs.
    """
    out = select_output(show_progress)

    if force_permute_all:
        batches = np.ones(len(y))

    u = NAMsvd[0]
    u = u if isinstance(u, torch.Tensor) else as_tensor(u)
    dev, dtype = u.device, u.dtype
    namresid = torch.as_tensor(NAMresid, device=dev)
    m_proj = torch.as_tensor(M, device=dev)
    y = torch.as_tensor(np.array(y), dtype=dtype, device=dev)
    n = int(y.shape[0])

    if ks is None:
        incr = max(int(0.02 * n), 1)
        maxnpcs = max(min(4 * incr, int(n / 5)), 1)
        ks = np.arange(incr, maxnpcs + 1, incr)
    ks = np.asarray(ks)
    if max(ks) + r >= n:
        raise ValueError(
            "the largest candidate PC count plus the number of covariates "
            f"must be below n-1; got {max(ks) + r} with n = {n}. Reduce "
            "covariates or pass a smaller grid via ks=[...]."
        )
    ks_dev = torch.as_tensor(ks, dtype=torch.int64, device=dev)

    # observed stage
    (k_dev, p_dev, r2_dev, ycond, yhat, beta_full, r2_perpc_full,
     ncorrs_dev, maxcorr_dev) = _assoc_observed(u, m_proj, namresid, y,
                                                ks_dev, r)

    # permutation null (reference ``:80-84``)
    ystd = (y - y.mean()) / y.std(correction=0)
    if null_y is not None:
        y_ = torch.as_tensor(np.array(null_y), dtype=dtype, device=dev)
        if tuple(y_.shape) != (n, Nnull):
            raise ValueError(
                f"null_y must have shape {(n, Nnull)}, got {tuple(y_.shape)}")
    else:
        if seed is None:
            seed = int(np.random.randint(0, 2**31 - 1))
            if mesh is not None:
                # every process must draw the same nulls
                seed = dist.broadcast_object(mesh, seed)
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(seed))
        if donorids is not None:
            y_ = permutations.grouplevel_permutation(gen, donorids, ystd,
                                                     Nnull)
        else:
            y_ = permutations.conditional_permutation(gen, batches, ystd,
                                                      Nnull)

    n_local = min(1000, Nnull)
    if mesh is None:
        nullminps_dev, nullr2s_dev, ycond_null = _assoc_null(
            u, m_proj, y_, ks_dev, r, n_local, bool(local_test))
    else:
        _, nullminps_dev, nullr2s_dev = sharded.null_minp(
            u, m_proj, y_, ks_dev, r, mesh)

    fdr_dev, fdr_thresholds = None, None
    if local_test:
        out("computing neighborhood-level FDRs")
        # threshold grid (reference ``:101-102``): float() yields a
        # float64 arange, which the empirical-FDR code detects as exactly
        # uniform (its collapsed-histogram fast path)
        maxcorr = float(maxcorr_dev)
        fdr_thresholds = np.arange(maxcorr / 4, maxcorr, maxcorr / 400)
        n_cells = namresid.shape[1]
        if n_cells * n_local > _FUSED_FDR_MIN_ELEMENTS:
            # big problems: fuse HOT LOOP 3's matmul with the tail-count
            # histogram, O(block x Nnull) memory instead of the
            # (cells x Nnull) null-coefficient matrix
            t0, dt = float(fdr_thresholds[0]), float(
                fdr_thresholds[1] - fdr_thresholds[0])
            nb = len(fdr_thresholds)
            if mesh is not None:
                # every (cells, perms) slot fuses its own tile
                tails = fdr_ops.null_coef_tail_counts_mesh(
                    namresid, _null_ycond(m_proj, y_, n_local), n, t0, dt,
                    nb, mesh)
            else:
                tails = fdr_ops.null_coef_tail_counts(
                    namresid, ycond_null, n, t0, dt, nb)
            ranks = fdr_ops._tail_hist_uniform(
                ncorrs_dev, t0, dt, nb, 1e-8, 1e-5)
            fdr_dev = ("fused", tails, ranks)
        else:
            nullncorrs = (
                _null_ncorrs(namresid, ycond_null) if mesh is None else
                sharded.null_ncorrs(namresid, m_proj, y_[:, :n_local], mesh))
            fdr_dev = ("dense", fdr_ops.empirical_fdrs(
                ncorrs_dev, nullncorrs, fdr_thresholds), None)

    (k_h, p_h, r2_h, ncorrs, nullminps, nullr2s, yhat_h, ycond_h,
     beta_h, r2pc_h) = fetch_many(
        k_dev, p_dev, r2_dev, ncorrs_dev, nullminps_dev, nullr2s_dev,
        yhat, ycond, beta_full, r2_perpc_full)
    k, p, r2 = int(k_h), float(p_h), float(r2_h)

    # post-conditions: a NaN/Inf in any of these is always a pipeline bug
    # or degenerate input; fail here rather than write poison into obs
    checks.assert_finite(minp=p_h, r2=r2_h, ncorrs=ncorrs,
                         nullminps=nullminps, nullr2s=nullr2s)

    if k == max(ks):
        warnings.warn(
            f"data supported use of {k} NAM PCs, which is the maximum "
            "considered. Consider allowing more PCs via the ks argument."
        )

    pfinal = ((nullminps <= p + 1e-8).sum() + 1) / (Nnull + 1)
    if (nullminps <= p + 1e-8).sum() == 0:
        warnings.warn(
            "global association p-value attained the minimal possible "
            "value; consider increasing Nnull"
        )

    # local neighborhood-level test (reference ``:91-118``)
    fdrs, fdr_5p_t, fdr_10p_t = None, None, None
    if local_test:
        abs_ncorrs = np.abs(ncorrs)
        if fdr_dev[0] == "fused":
            fdr_vals = fetch(fdr_dev[1]) / (n_local * fetch(fdr_dev[2]))
        else:
            fdr_vals = fetch(fdr_dev[1])

        # num_detected[t] = #{|ncorr| > t} (reference ``:105-108``), as one
        # sort + searchsorted instead of a 400-threshold host loop
        sorted_abs = np.sort(abs_ncorrs)
        num_detected = sorted_abs.size - np.searchsorted(
            sorted_abs, fdr_thresholds, side="right")
        fdrs = pd.DataFrame({
            "threshold": fdr_thresholds,
            "fdr": fdr_vals,
            "num_detected": num_detected,
        })

        # maximal FDR<5% / FDR<10% sets (reference ``:110-118``)
        if np.min(fdrs.fdr) > 0.05:
            fdr_5p_t = None
        else:
            fdr_5p_t = fdrs[fdrs.fdr <= 0.05].iloc[0].threshold
        if np.min(fdrs.fdr) > 0.1:
            fdr_10p_t = None
        else:
            fdr_10p_t = fdrs[fdrs.fdr <= 0.1].iloc[0].threshold

    return Result(
        p=pfinal, nullminps=nullminps, k=k, ncorrs=ncorrs,
        fdrs=fdrs, fdr_5p_t=fdr_5p_t, fdr_10p_t=fdr_10p_t,
        yresid_hat=yhat_h, yresid=ycond_h, ks=ks,
        beta=beta_h[:k], r2=r2,
        r2_perpc=r2pc_h[:k],
        nullr2_mean=nullr2s.mean(), nullr2_std=nullr2s.std(),
    )


def check_inputs(data, y, sid_name, batches, covs, donorids,
                 allow_low_sample_size):
    """Validate inputs and derive the valid-sample filter.

    Mirrors reference ``check_inputs`` (``_association.py:131-173``): type
    checks, index containment, batch/donor mutual exclusion, default
    all-ones batches, NaN-based sample filtering, minimum-sample gate.
    """
    def _require(name, value, kind):
        if value is not None and not isinstance(value, kind):
            raise TypeError(
                f"expected {name} as a pandas {kind.__name__} "
                f"(sample-indexed); received {type(value).__name__}")

    _require("y", y, pd.Series)
    _require("batches", batches, pd.Series)
    _require("covs", covs, pd.DataFrame)
    _require("donorids", donorids, pd.Series)
    if y is None:
        raise TypeError("expected y as a pandas Series; received None")
    if not set(y.index).issubset(set(data.obs[sid_name])):
        print("WARNING: the index of 'y' has entries that never appear in "
              "data.obs[sid_name]; those samples will be ignored.")
    if not set(data.obs[sid_name]).issubset(set(y.index)):
        raise ValueError(
            "data.obs[sid_name] contains sample ids missing from the index of 'y'."
        )

    if batches is not None and donorids is not None:
        raise ValueError(
            "conditioning on batch while also modeling multiple samples "
            "per donor is not currently supported"
        )

    if batches is None:
        batches = pd.Series(np.ones(len(y)), index=y.index)

    if covs is not None:
        filter_samples = (
            ~(y.isna() | covs.isna().any(axis=1))
            & y.index.isin(data.obs[sid_name].unique())
        )
        if donorids is not None:
            print("WARNING: covariate conditioning does not currently account "
                  "for multiple samples per donor; the adjustment may be "
                  "incomplete (expected to matter little in most cases).")
    else:
        filter_samples = ~np.isnan(y) & y.index.isin(data.obs[sid_name].unique())

    n_valid = filter_samples.sum()
    if n_valid < 10 and not allow_low_sample_size:
        raise ValueError(
            "phenotype information was supplied for fewer than 10 samples; "
            "the sample-label permutation null has poor power at this size. "
            "Pass allow_low_sample_size=True to proceed anyway."
        )

    return batches, filter_samples


def compute_nam_and_reindex(data, y, sid_name, batches, covs, donorids,
                            filter_samples, nsteps, show_progress, **kwargs):
    """Compute the NAM and align it to the phenotype's sample order.

    Mirrors reference ``compute_nam_and_reindex`` (``_association.py:
    175-191``): reindex NAM rows to ``y.index``, filter samples, drop
    zero-variance columns (updating the cell-level ``kept`` mask).
    """
    NAM, kept = nam(data, sid_name, batches=batches, nsteps=nsteps,
                    show_progress=show_progress, **kwargs)
    NAM = NAM.reindex(y.index)[filter_samples]

    # after the sample filter some neighborhoods may be constant; they
    # carry no signal and would break standardization: drop them and
    # clear their cells from the QC-survivor mask
    constant = (NAM.std(axis=0) == 0).to_numpy()
    surviving_cells = np.flatnonzero(kept)
    kept[surviving_cells[constant]] = False
    NAM = NAM.loc[:, ~constant]

    return (NAM, kept,
            batches.reindex(y.index),
            covs.reindex(y.index) if covs is not None else None,
            donorids.reindex(y.index) if donorids is not None else None,
            filter_samples.reindex(y.index))


def _compute_nam_arrays_and_reindex(data, y, sid_name, batches, covs,
                                    donorids, filter_samples, nsteps,
                                    show_progress, mesh=None,
                                    nam_savepoint=None, **kwargs):
    """Device-resident variant of ``compute_nam_and_reindex``.

    Same semantics (row reindex to y's order, sample filter, zero-variance
    column drop updating ``kept``) but the NAM stays on the device; only
    the small per-column variance mask syncs to the host.
    """
    arrays, kept = nam_arrays(data, sid_name, batches=batches, nsteps=nsteps,
                              show_progress=show_progress, mesh=mesh,
                              nam_savepoint=nam_savepoint, **kwargs)

    valid_samples = y.index[filter_samples]
    row_idx = arrays.samples.get_indexer(valid_samples)
    if (row_idx < 0).any():
        missing = list(valid_samples[row_idx < 0][:5])
        raise ValueError(f"samples {missing} absent from the computed NAM")
    dev = arrays.nam.device
    nam_f = arrays.nam[torch.as_tensor(row_idx, device=dev)]

    stds = moments.colstd(nam_f, ddof=1, axis=0)
    zero_var = fetch(stds) == 0
    surviving_cells = np.flatnonzero(kept)
    kept[surviving_cells[np.nonzero(zero_var)[0]]] = False
    cells = arrays.cells
    if zero_var.any():
        nam_f = nam_f[:, torch.as_tensor(np.nonzero(~zero_var)[0],
                                         device=dev)]
        cells = cells[~zero_var]

    filtered = NamArrays(nam=nam_f, samples=pd.Index(valid_samples),
                         cells=cells, nsteps=arrays.nsteps)
    return (filtered, kept,
            batches.reindex(y.index),
            covs.reindex(y.index) if covs is not None else None,
            donorids.reindex(y.index) if donorids is not None else None,
            filter_samples.reindex(y.index))


def association(data, y, sid_name, batches=None, covs=None, donorids=None,
                ks=None, key_added="coef", max_frac_pcs=0.15, nsteps=None,
                show_progress=False, allow_low_sample_size=False,
                return_full=False, ridges=None, mesh=None,
                nam_savepoint=None, **kwargs):
    """Main entry point: test association of a sample-level phenotype with
    neighborhood abundance (reference ``association``, ``_association.py:
    193-242``).

    Writes per-cell neighborhood coefficients into ``data.obs[key_added]``
    and per-cell FDRs into ``data.obs[f'{key_added}_fdr']``; returns the
    global permutation p-value (or the full result if ``return_full``).
    ``nam_savepoint`` names an opt-in NAM savepoint file
    (``utils.checkpoint``).  ``mesh``: a ``parallel.make_mesh`` mesh (or
    ``parallel.launch.global_mesh`` across processes) over which the
    diffusion, the null scoring and the local test are sharded.
    """
    out = select_output(show_progress)

    prof = global_profiler()
    batches, filter_samples = check_inputs(
        data, y, sid_name, batches, covs, donorids, allow_low_sample_size)

    with prof.phase("nam", cells=data.n_obs):
        NAM, kept, batches, covs, donorids, filter_samples = (
            _compute_nam_arrays_and_reindex(
                data, y, sid_name, batches, covs, donorids, filter_samples,
                nsteps, show_progress, mesh=mesh,
                nam_savepoint=nam_savepoint, **kwargs))

    n_valid = filter_samples.sum()
    npcs = min(
        n_valid,
        max([10, int(max_frac_pcs * n_valid)] + (list(ks) if ks is not None else [])),
    )
    with prof.phase("residualize"):
        res = _resid_nam(
            NAM,
            covs[filter_samples] if covs is not None else covs,
            batches[filter_samples] if batches is not None else batches,
            npcs=npcs, ridges=ridges, show_progress=show_progress)

    out("performing association test")
    dev = res._dev
    with prof.phase("test", permutations=kwargs.get("Nnull", 1000)):
        res_ = _association(
            (dev.u, dev.svs, dev.v),
            dev.namresid, dev.m, dev.r,
            y[filter_samples].values, batches[filter_samples].values,
            donorids[filter_samples].values if donorids is not None else None,
            show_progress=show_progress, ks=ks, mesh=mesh, **kwargs)
    res.update(res_)
    res.set_lazy("nam", NAM.to_df)
    res.kept = kept

    # per-cell write-back (reference ``:228-237``)
    if key_added in data.obs:
        warnings.warn(
            f"data.obs already has a column named '{key_added}'; its "
            "contents will be replaced with this run's coefficients.")
    data.obs[key_added] = np.nan
    data.obs.loc[kept, key_added] = res.ncorrs

    if res.fdrs is not None:  # local_test=False produces no FDR curve
        # vectorized equivalent of the reference's per-cell apply
        # (``_association.py:233-237``): each cell gets the minimum FDR
        # among thresholds <= |coef|, else 1 (incl. non-kept NaN cells)
        thresholds = res.fdrs.threshold.to_numpy()
        prefix_min_fdr = np.minimum.accumulate(res.fdrs.fdr.to_numpy())
        coefs = data.obs[key_added].to_numpy(dtype=float)
        abs_coefs = np.abs(coefs)
        pos = np.searchsorted(thresholds, np.nan_to_num(abs_coefs, nan=-1.0),
                              side="right")
        fdr_col = np.where(pos > 0,
                           prefix_min_fdr[np.maximum(pos - 1, 0)], 1.0)
        fdr_col = np.where(np.isnan(coefs), 1.0, fdr_col)
        data.obs[f"{key_added}_fdr"] = fdr_col

    if return_full:
        return res
    return res.p
