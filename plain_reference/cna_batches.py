"""A plain reference of CNA's association with batches and covariates.

Plain ``torch`` in float64 (TF32 off for every product), no kernels,
nothing blocked or fused.  It imports neither ``jax``, ``cna_tpu`` nor
``cna_tpu_torch``.  It follows upstream ``cna`` v0.2.3 (Reshef et al.,
Nat. Biotechnol. 2022; ``src/cna/tools/_nam.py``, ``_association.py``,
``_stats.py``), from the cell graph to the per-cell write-back:

* the NAM: diffuse the cells-by-samples one-hot through the graph,
  ``s <- A (s / c) + s / c`` with ``c`` the column sums of ``A`` plus 1,
  until the median over cells of the excess kurtosis of ``s / C`` falls by
  less than 3 between steps (at least 3 steps, at most 15);
* the batch-kurtosis QC: per neighbourhood the Pearson kurtosis of the
  per-batch means; drop where it is >= max(6, 2 median) (one batch: no QC);
  then drop the neighbourhoods left constant;
* the residualization: centre the NAM; covariates and the batch dummies
  standardized (ddof 1); one batch: ``M = I - C (C'C)^-1 C'`` once;
  several: for each ridge of ``RIDGES``,
  ``M = I - C (C'C + ridge n L)^-1 C'`` (``L`` selects the dummies),
  ``NAM_ = M NAM_`` cumulatively, stopping once the median batch kurtosis of
  ``NAM_`` is <= 6; the last ``M`` goes on to the test;
* re-standardize the columns (ddof 1), centre and standardize again,
  eigen-decompose the samples-by-samples Gram;
* the F-test min-p over the PC grid ``ks`` of ``z = M y / std`` with
  ``d2 = n - (1 + r + k)``, ``r`` the columns of ``C``;
* the global p from the nulls' min-p; the neighbourhood coefficients
  ``namresid' y / n``; the null coefficients from ``M y_`` (ddof 1), their
  tail counts over the threshold grid, the FDR curve; the write-back.

Departures from upstream, each kept in the program too:

* (SURVEY row 5) the QC's kurtosis is scipy's, as upstream; the median is
  numpy's (mean of the two middle values).
* (row 7) upstream's ridge list also has 1e-5; this list ends at 1e-4
  then 0, as the program's does.
* (row 9) the nulls are given (``nulls``), drawn by the caller within
  batches: no random stream is shared with upstream's ``np.random``.
* (row 11) ``ssefull`` is ``ssered - sum_{i<=k} beta_i^2`` as upstream,
  in float64, where the cancellation at R^2 near 1 costs nothing; the
  local test takes the first ``min(1000, Nnull)`` nulls as upstream, and
  its FDR is the collapsed histogram (total null tail count over nulls
  times the observed tail count), which equals upstream's mean of per-null
  FDPs because the denominator is shared.
"""

from __future__ import annotations

import numpy as np
import scipy.stats as st
import torch

F64 = torch.float64
RIDGES = (1e5, 1e4, 1e3, 1e2, 1e1, 1e0, 1e-1, 1e-2, 1e-3, 1e-4, 0.0)
ATOL, RTOL = 1e-8, 1e-5


def no_tf32():
    """Every float32 product of the process in full float32 (the
    reference itself is float64; a caller's float32 tensors are not)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def kurtosis(x, dim):
    """Excess kurtosis with biased moments (scipy's default)."""
    d = x - x.mean(dim=dim, keepdim=True)
    m2 = (d * d).mean(dim=dim)
    return (d ** 4).mean(dim=dim) / (m2 * m2) - 3.0


def median(x):
    """numpy's median of every entry."""
    s = torch.sort(x.reshape(-1)).values
    m = s.shape[0]
    return (s[(m - 1) // 2] + s[m // 2]) / 2.0


def standardize(x, ddof):
    return (x - x.mean(dim=0)) / x.std(dim=0, correction=ddof)


def diffuse(conn, codes, n_samples, maxnsteps=15):
    """(NAM (samples, cells), steps) of a scipy CSR graph and each cell's
    sample code."""
    coo = conn.tocoo()
    n = conn.shape[0]
    a = torch.sparse_coo_tensor(np.vstack([coo.row, coo.col]), coo.data,
                                (n, n), dtype=F64,
                                check_invariants=True).coalesce()
    colsums = torch.as_tensor(np.asarray(conn.sum(axis=0)).ravel(),
                              dtype=F64) + 1.0
    codes = torch.as_tensor(codes).long()
    counts = torch.bincount(codes, minlength=n_samples).to(F64)
    s = torch.zeros((n, n_samples), dtype=F64)
    s[torch.arange(n), codes] = 1.0
    prev = float("inf")
    steps = 0
    for steps in range(1, maxnsteps + 1):
        t = s / colsums[:, None]
        s = torch.sparse.mm(a, t) + t
        medk = float(median(kurtosis(s / counts, dim=1)))
        if steps >= 3 and prev - medk < 3:
            break
        prev = medk
    return (s / counts).T.contiguous(), steps


def batch_kurtosis(nam, bcodes):
    """Pearson kurtosis of each column's per-batch means (batches in
    sorted order)."""
    means = torch.stack([nam[bcodes == b].mean(dim=0)
                         for b in torch.unique(bcodes)])
    return kurtosis(means, dim=0) + 3.0


def qc(nam, bcodes):
    """Boolean keep of each neighbourhood (all kept for one batch)."""
    if torch.unique(bcodes).numel() == 1:
        return torch.ones(nam.shape[1], dtype=torch.bool)
    kurt = batch_kurtosis(nam, bcodes)
    return kurt < max(6.0, 2.0 * float(median(kurt)))


def projector(c, ridge=0.0, nbcols=0):
    """``I - C (C'C + ridge n L)^-1 C'``, ``L`` the first ``nbcols``."""
    n, r = c.shape
    eye = torch.eye(n, dtype=F64)
    if r == 0:
        return eye
    pen = torch.zeros(r, dtype=F64)
    pen[:nbcols] = ridge * n
    return eye - c @ torch.linalg.solve(c.T @ c + torch.diag(pen), c.T)


def design(bcodes, covs):
    """(C, number of batch columns): the standardized batch dummies
    (none for one batch), then the standardized covariates."""
    n = bcodes.shape[0]
    parts, nb = [], 0
    if torch.unique(bcodes).numel() > 1:
        dummies = (bcodes[:, None] == torch.unique(bcodes)[None, :]).to(F64)
        parts.append(standardize(dummies, 1))
        nb = dummies.shape[1]
    if covs is not None and covs.shape[1]:
        parts.append(standardize(covs, 1))
    c = torch.cat(parts, dim=1) if parts else torch.zeros((n, 0), dtype=F64)
    return c, nb


def residualize(nam, bcodes, covs, ridges=RIDGES, steps=None):
    """The residualized NAM and its decomposition: dict of ``namresid``
    (samples, cells), ``M``, ``r``, ``steps`` (ridge steps; 0 for one
    batch), ``trail`` (median batch kurtosis after each), ``u``, ``svs``.
    ``steps``: take exactly that many ridge steps instead of the rule."""
    nam_c = nam - nam.mean(dim=0)
    c, nb = design(bcodes, covs)
    trail = []
    if nb == 0:
        m = projector(c)
        nam_r = m @ nam_c
    else:
        nam_r = nam_c
        for ridge in ridges:
            m = projector(c, ridge, nb)
            nam_r = m @ nam_r
            trail.append(float(median(batch_kurtosis(nam_r, bcodes))))
            if (len(trail) == steps if steps is not None
                    else trail[-1] <= 6):
                break
    namresid = nam_r / nam_r.std(dim=0, correction=1)
    z = standardize(namresid, 1)
    evals, evecs = torch.linalg.eigh(z @ z.T)
    return dict(namresid=namresid, M=m, r=c.shape[1], steps=len(trail),
                trail=trail, u=evecs.flip(1), svs=evals.flip(0).abs())


def ks_grid(n):
    incr = max(int(0.02 * n), 1)
    maxnpcs = max(min(4 * incr, int(n / 5)), 1)
    return np.arange(incr, maxnpcs + 1, incr)


def minp(u, m, cols, ks, r):
    """Per column: (chosen k, least p, every p (|ks|, columns))."""
    n = cols.shape[0]
    z = m @ cols
    z = z / z.std(dim=0, correction=0)
    beta = u.T @ z
    cum = torch.cumsum(beta * beta, dim=0)
    kk = torch.as_tensor(ks).long()
    delta = cum[kk - 1]
    full = (z * z).sum(dim=0) - delta
    kf = kk.to(F64)[:, None]
    f = ((delta / kf) / (full / n)).numpy()
    ksn = np.asarray(ks, dtype=np.float64)[:, None]
    ps = st.f.sf(f, ksn, n - (1.0 + r + ksn))
    sel = np.nanargmin(ps, axis=0)
    return np.asarray(ks)[sel], ps[sel, np.arange(ps.shape[1])], ps


def tail_counts(values, thresholds):
    """``#{x : x^2 >= t^2 (1 - RTOL) - ATOL}`` for each threshold t."""
    t = torch.as_tensor(np.asarray(thresholds), dtype=F64)
    edges = t * t - ATOL - RTOL * t * t
    x2 = (values.reshape(-1) ** 2)[:, None]
    return (x2 >= edges[None, :]).sum(dim=0)


def association(nam, y, bcodes, covs, nulls, thresholds=None, ridges=RIDGES,
                keep=None, steps=None):
    """The test of phenotype ``y`` (n,) on the raw NAM (n, cells) whose
    rows are ``y``'s samples, with batch codes ``bcodes`` (n,), covariates
    ``covs`` (n, q) or None, and null phenotypes ``nulls`` (n, Nnull) of
    the standardized ``y``.  ``thresholds``: the FDR grid to evaluate
    (default the reference's own); ``keep`` / ``steps``: the kept
    neighbourhoods and the ridge steps to use instead of the rules'.
    Returns a dict of host values; ``coef`` / ``coef_fdr`` over every
    cell."""
    no_tf32()
    nam = torch.as_tensor(nam, dtype=F64)
    y = torch.tensor(np.asarray(y, dtype=np.float64))
    bcodes = torch.as_tensor(bcodes).long()
    covs = None if covs is None else torch.as_tensor(covs, dtype=F64)
    nulls = torch.as_tensor(nulls, dtype=F64)
    n = y.shape[0]
    qc_keep = qc(nam, bcodes)
    kept = qc_keep.clone() if keep is None else torch.as_tensor(keep)
    cols = torch.nonzero(kept).reshape(-1)
    constant = nam[:, cols].std(dim=0) == 0
    kept[cols[constant]] = False
    res = residualize(nam[:, kept], bcodes, covs, ridges, steps)
    ks = ks_grid(n)
    ystd = (y - y.mean()) / y.std(correction=0)
    m, u, r = res["M"], res["u"], res["r"]
    k, p_obs, ps = minp(u, m, ystd[:, None], ks, r)
    _, nullminps, _ = minp(u, m, nulls, ks, r)
    p_obs = float(p_obs[0])
    p = (float((nullminps <= p_obs + 1e-8).sum()) + 1) / (nulls.shape[1] + 1)
    ncorrs = res["namresid"].T @ ystd / n
    if thresholds is None:
        maxcorr = max(float(ncorrs.abs().max()), 0.001)
        thresholds = np.arange(maxcorr / 4, maxcorr, maxcorr / 400)
    n_local = min(1000, nulls.shape[1])
    ycond = m @ nulls[:, :n_local]
    ycond = ycond / ycond.std(dim=0, correction=1)
    tails = tail_counts(res["namresid"].T @ ycond / n, thresholds)
    ranks = tail_counts(ncorrs, thresholds)
    fdr = tails.to(F64) / (n_local * ranks.to(F64))
    coef = torch.full((nam.shape[1],), float("nan"), dtype=F64)
    coef[kept] = ncorrs
    return dict(qc_keep=qc_keep.numpy(), kept=kept.numpy(),
                steps=res["steps"], trail=res["trail"], M=m.numpy(), r=r,
                svs=res["svs"].numpy(), k=int(k[0]), p_obs=p_obs,
                ps_obs=ps[:, 0], ks=ks, nullminps=nullminps, p=p,
                ncorrs=ncorrs.numpy(), thresholds=np.asarray(thresholds),
                fdr=fdr.numpy(), ranks=ranks.numpy(), coef=coef.numpy(),
                coef_fdr=cell_fdrs(coef.numpy(), thresholds, fdr.numpy()))


def cell_fdrs(coefs, thresholds, fdr):
    """Each cell's FDR: the least FDR over thresholds at or below |coef|,
    1 where there is none or the coefficient is NaN."""
    a = np.abs(coefs)
    out = np.full(coefs.shape[0], np.inf)
    for t, f in zip(thresholds, fdr):
        out = np.where(a >= t, np.minimum(out, f), out)
    return np.where(np.isinf(out) | np.isnan(coefs), 1.0, out)
