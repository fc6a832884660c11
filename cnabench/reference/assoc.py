"""The association, plainly: the CNA method (Reshef et al., Nat.
Biotechnol. 2022) as its reference implementation defines it, for one
batch and no covariates.

* NAM: diffuse the cells-by-samples one-hot through the graph,
  ``s <- A (s / c) + s / c`` with ``c`` the column sums of ``A`` plus 1,
  until the median over cells of the excess kurtosis (biased moments) of
  ``s / C`` across samples falls by less than 3 between steps, after at
  least 3 steps and at most 15 (``C``: the cells of each sample); the NAM
  is ``(s / C)'``.
* Residualize and decompose: centre each NAM column, divide by its
  standard deviation (ddof 1), standardize again, eigen-decompose the
  samples-by-samples Gram.
* Global test: for each phenotype column, ``z / std(z)`` (ddof 0), the F
  test of the top-k PC regression for each k of the grid, the smallest p.
  The global p counts the null phenotypes whose smallest p is at most the
  observed one (plus 1e-8), plus one, over the nulls plus one.
* Local test: neighbourhood coefficients ``namresid' y / n`` (y
  standardized, ddof 0); null coefficients of the first ``min(1000,
  Nnull)`` nulls, each scaled to unit standard deviation (ddof 1); at each
  threshold t the tail counts ``#{x : x^2 >= t^2 (1 - 1e-5) - 1e-8}``;
  FDR = null tail count / (nulls x observed tail count).
"""

from __future__ import annotations

import numpy as np
import scipy.stats as st
import torch

from . import Precision, mm

MAX_STEPS = 15
ATOL, RTOL = 1e-8, 1e-5


def median(x: torch.Tensor) -> torch.Tensor:
    """numpy's median (the mean of the two middle values at even length)."""
    s = torch.sort(x.reshape(-1)).values
    m = s.shape[0]
    return (s[(m - 1) // 2] + s[m // 2]) / 2.0


def kurtosis_rows(x: torch.Tensor) -> torch.Tensor:
    """Excess kurtosis with biased moments of each row."""
    d = x - x.mean(dim=1, keepdim=True)
    d2 = d * d
    m2 = d2.mean(dim=1)
    return (d2 * d2).mean(dim=1) / (m2 * m2) - 3.0


def adjacency(keys, vals, n, prec: Precision):
    """CSR of a symmetric graph from its sorted keys."""
    rows, cols = keys // n, keys % n
    crow = torch.zeros(n + 1, dtype=torch.int64, device=keys.device)
    crow[1:] = torch.cumsum(torch.bincount(rows, minlength=n), 0)
    return torch.sparse_csr_tensor(crow, cols, vals.to(prec.dtype),
                                   size=(n, n))


def diffuse(keys, vals, n, codes, n_samples, prec: Precision, watch=None):
    """The NAM (samples x cells) and the steps taken.  ``watch(step,
    nam)`` is called after every step with that step's NAM."""
    a = adjacency(keys, vals, n, prec)
    colsums = torch.zeros(n, dtype=prec.dtype, device=keys.device)
    colsums.index_add_(0, keys % n, vals.to(prec.dtype))
    colsums += 1.0
    codes = torch.as_tensor(codes, device=keys.device).long()
    counts = torch.bincount(codes, minlength=n_samples).to(prec.dtype)
    s = torch.zeros((n, n_samples), dtype=prec.dtype, device=keys.device)
    s[torch.arange(n, device=keys.device), codes] = 1.0
    prev = torch.tensor(float("inf"), dtype=prec.dtype)
    steps = 0
    for steps in range(1, MAX_STEPS + 1):
        t = s / colsums[:, None]
        s = torch.sparse.mm(a, t) + t
        del t
        norm = s / counts[None, :]
        medk = median(kurtosis_rows(norm)).cpu()
        if watch is not None:
            watch(steps, norm)
        del norm
        if steps >= 3 and bool(prev - medk < 3):
            break
        prev = medk
    return (s / counts[None, :]).T.contiguous(), steps


def resid_svd(nam: torch.Tensor, prec: Precision):
    """(namresid (S, C), U (S, S), squared singular values (S,)) of the
    NAM with no covariates and one batch."""
    c = nam - nam.mean(dim=0, keepdim=True)
    namresid = c / c.std(dim=0, correction=1, keepdim=True)
    del c
    z = namresid - namresid.mean(dim=0, keepdim=True)
    z = z / z.std(dim=0, correction=1, keepdim=True)
    gram = mm(z, z.T.contiguous(), prec)
    del z
    evals, evecs = np.linalg.eigh(gram.cpu().numpy())
    svs = np.abs(evals[::-1]).copy()
    u = torch.as_tensor(np.ascontiguousarray(evecs[:, ::-1]),
                        device=nam.device, dtype=prec.dtype)
    return namresid, u, svs


def ks_grid(n):
    incr = max(int(0.02 * n), 1)
    maxnpcs = max(min(4 * incr, int(n / 5)), 1)
    return np.arange(incr, maxnpcs + 1, incr)


def minp(u, cols: torch.Tensor, ks, prec: Precision, r=0):
    """Per phenotype column: (chosen k, smallest p, all p (|ks|, m))."""
    n = cols.shape[0]
    z = cols / cols.std(dim=0, correction=0, keepdim=True)
    beta = mm(u.T.contiguous(), z, prec)
    cum = torch.cumsum(beta * beta, dim=0)
    ssered = (z * z).sum(dim=0)
    kk = torch.as_tensor(ks, device=cols.device).long()
    delta = cum[kk - 1]
    full = ssered[None, :] - delta
    kf = kk.to(cols.dtype)[:, None]
    f = ((delta / kf) / (full / n)).double().cpu().numpy()
    ksn = np.asarray(ks, dtype=np.float64)[:, None]
    ps = st.f.sf(f, ksn, n - (1.0 + r + ksn))
    sel = np.nanargmin(ps, axis=0)
    m = np.arange(ps.shape[1])
    return np.asarray(ks)[sel], ps[sel, m], ps


def tail_edges(thresholds):
    t = np.asarray(thresholds, dtype=np.float64)
    return t * t - ATOL - RTOL * t * t


def tail_counts(values: torch.Tensor, edges: torch.Tensor):
    """``#{x : x^2 >= edge_i}`` for each edge (ascending), int64."""
    pos = torch.searchsorted(edges, (values.double() ** 2).reshape(-1),
                             right=True)
    counts = torch.bincount(pos, minlength=edges.shape[0] + 1)
    return counts.flip(0).cumsum(0).flip(0)[1:]


def null_tail_counts(namresid, nulls, edges, prec: Precision,
                     block=32_768):
    """Tail counts of ``|namresid' ycond| / n`` over every cell and null,
    ``ycond`` the nulls scaled to unit standard deviation (ddof 1)."""
    n = nulls.shape[0]
    ycond = nulls / nulls.std(dim=0, correction=1, keepdim=True)
    tails = torch.zeros(edges.shape[0], dtype=torch.int64,
                        device=edges.device)
    for lo in range(0, namresid.shape[1], block):
        coefs = mm(namresid[:, lo:lo + block].T.contiguous(), ycond,
                   prec).abs() / n
        tails += tail_counts(coefs, edges)
    return tails


def association(namresid, u, y, nulls, prec: Precision, thresholds=None):
    """The test of one phenotype ``y`` (n,) with null phenotypes ``nulls``
    (n, Nnull), on the device of ``namresid``.  ``thresholds``: the FDR
    grid to evaluate (default: the reference's own, from its
    coefficients).  Returns a dict of host values."""
    dev = namresid.device
    n = y.shape[0]
    ks = ks_grid(n)
    y = torch.as_tensor(y, device=dev, dtype=prec.dtype)
    nulls = torch.as_tensor(nulls, device=dev, dtype=prec.dtype)
    ystd = (y - y.mean()) / y.std(correction=0)
    k, p_obs, ps_obs = minp(u, ystd[:, None], ks, prec)
    _, nullminps, _ = minp(u, nulls, ks, prec)
    p_obs = float(p_obs[0])
    pfinal = (float((nullminps <= p_obs + 1e-8).sum()) + 1) / (
        nulls.shape[1] + 1)
    ncorrs = (mm(namresid.T.contiguous(), ystd[:, None], prec)[:, 0]
              / n)
    if thresholds is None:
        maxcorr = max(float(ncorrs.abs().max()), 0.001)
        thresholds = np.arange(maxcorr / 4, maxcorr, maxcorr / 400)
    edges = torch.as_tensor(tail_edges(thresholds), device=dev)
    n_local = min(1000, nulls.shape[1])
    tails = null_tail_counts(namresid, nulls[:, :n_local], edges, prec)
    ranks = tail_counts(ncorrs, edges)
    fdr = tails.double() / (n_local * ranks.double())
    return dict(k=int(k[0]), p_obs=p_obs, ps_obs=ps_obs[:, 0], ks=ks,
                nullminps=nullminps, p=pfinal,
                ncorrs=ncorrs.double().cpu().numpy(),
                thresholds=np.asarray(thresholds),
                fdr=fdr.cpu().numpy(), ranks=ranks.cpu().numpy())


def cell_fdrs(coefs, thresholds, fdr):
    """Each cell's FDR: the least FDR over thresholds at or below |coef|,
    1 where there is none or the coefficient is NaN."""
    coefs = np.asarray(coefs, dtype=np.float64)
    out = np.full(coefs.shape[0], np.inf)
    a = np.abs(coefs)
    for t, f in zip(thresholds, fdr):
        out = np.where(a >= t, np.minimum(out, f), out)
    return np.where(np.isinf(out) | np.isnan(coefs), 1.0, out)
