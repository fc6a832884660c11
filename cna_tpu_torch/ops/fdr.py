"""Empirical FDR / FWER over permutation nulls.

Replaces reference ``_stats.py:34-105``.  The reference's ``tail_counts``
builds, for each null instantiation, a histogram whose bin edges are the
(tolerance-shifted) sorted squared observed statistics, then reverse-
cumsums it into tail counts.  That is equivalent to, for each threshold t,
counting statistics with ``x^2 >= t^2*(1 - rtol) - atol``, computed here
with searchsorted + bincount, vectorized over null columns.

The association path uses a uniform threshold grid, for which the
threshold index of every statistic has a closed form (``_bucketize``) and
all nulls collapse into one histogram.  On the TPU that histogram was a
compare-and-reduce (its scatter was slow); on a GPU it is a ``bincount``
followed by a reverse cumulative sum (integer counts, so the atomics give
the same result every run).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import config


def _adjusted_edges(thresholds, atol, rtol):
    t2 = thresholds * thresholds
    return t2 - atol - rtol * t2


def _as_tensor(x, like=None):
    if isinstance(x, torch.Tensor):
        return x
    dev = like.device if like is not None else config.device()
    return torch.as_tensor(np.asarray(x), device=dev)


def tail_counts(z, znull, atol=1e-8, rtol=1e-5):
    """Count, per null column, the null stats >= each |z| threshold.

    Matches reference ``tail_counts`` (``_stats.py:34-62``): thresholds are
    the entries of ``z`` (order preserved in the output), comparisons use
    squared magnitudes with a small tolerance slack.

    Args:
      z: (T,) statistics whose magnitudes act as thresholds.
      znull: (C,) or (C, m) null statistics.

    Returns int64 tensor (m, T): tail counts per null instantiation.
    """
    z = _as_tensor(z)
    znull = _as_tensor(znull, like=z)
    if znull.dim() == 1:
        znull = znull[:, None]
    z2 = z * z
    order = torch.argsort(z2)
    inv = torch.argsort(order)
    edges = _adjusted_edges(z[order], atol, rtol).contiguous()  # ascending
    t = edges.shape[0]
    m = znull.shape[1]
    pos = torch.searchsorted(edges, (znull * znull).to(edges.dtype),
                             right=True)  # (C, m) in [0, T]
    col = torch.arange(m, device=z.device)[None, :]
    counts = torch.bincount((col * (t + 1) + pos).reshape(-1),
                            minlength=m * (t + 1)).reshape(m, t + 1)
    # tails_i = #{x : pos_x >= i+1} = reversed cumulative sum beyond i
    tails_sorted = counts.flip(1).cumsum(1).flip(1)[:, 1:]
    return tails_sorted[:, inv]


def _uniform_spacing(thresholds):
    """(t0, dt) if ``thresholds`` is an arithmetic progression, else None.

    The tolerance is dtype-aware: a float64 ``np.arange`` grid that went
    through a float32 round trip deviates from an exact progression by a
    few f32 ulps (~1e-7 relative), still "uniform" for every practical
    purpose; without that tolerance the fast path is silently skipped.
    """
    t_in = np.asarray(thresholds)
    t = t_in.astype(np.float64)
    if len(t) < 2:
        return None
    dt = t[1] - t[0]
    if dt <= 0:
        return None
    eps = np.finfo(t_in.dtype).eps if t_in.dtype.kind == "f" else 1e-12
    ideal = t[0] + dt * np.arange(len(t))
    if np.max(np.abs(t - ideal)) > 8 * eps * max(abs(t[-1]), dt):
        return None
    return float(t[0]), float(dt)


def _bucketize(values, t0, dt, n_bins, atol, rtol):
    """Closed-form threshold index of each value on the uniform grid
    ``t_i = t0 + i dt``: ``c(x) = #{i : t_i <= sqrt((x^2 + atol) /
    (1-rtol))}``, the reference comparison solved for i.  In the widest
    float the configuration allows (float64 under x64, where the rounding
    sits ~8 orders below the tolerance slack; float32 otherwise, fuzzy at
    the boundary at the same ~1e-7 scale as the rest of the f32
    pipeline)."""
    wide = config.default_float()
    x2 = values.to(wide) ** 2
    v = torch.sqrt((x2 + atol) / (1.0 - rtol))
    return torch.clamp(torch.floor((v - t0) / dt) + 1.0, 0, n_bins).long()


def _tails_from_buckets(c, n_bins):
    """``tails_i = #{x : c(x) >= i+1}`` for i < n_bins (int64)."""
    counts = torch.bincount(c.reshape(-1), minlength=n_bins + 1)
    return counts.flip(0).cumsum(0).flip(0)[1:]


def _tail_hist_uniform(values, t0, dt, n_bins, atol, rtol):
    """Tail counts of all entries of ``values`` against the uniform grid,
    collapsed over null columns."""
    return _tails_from_buckets(
        _bucketize(values.reshape(-1), t0, dt, n_bins, atol, rtol), n_bins)


def null_coef_tail_counts(namresid, ycond, n, t0, dt, n_bins, atol=1e-8,
                          rtol=1e-5, block=32_768):
    """Tail counts of ``|namresid.T @ ycond| / n`` without materializing it.

    The null neighborhood-coefficient matrix (reference ``_association.py:
    99``) is (cells x Nnull): 4 GB at 1M cells x 1000 nulls.  This fuses
    HOT LOOP 3's matmul with the tail-count accumulation: loop over cell
    blocks, compute the (block x Nnull) coefficient tile, bucketize
    against the uniform grid, accumulate the tails.

    namresid: (S, C); ycond: (S, m) standardized projected nulls.
    Returns (n_bins,) total tail counts over all cells x nulls.
    """
    c = namresid.shape[1]
    tails = torch.zeros(n_bins, dtype=torch.int64, device=namresid.device)
    inv_n = 1.0 / n
    for lo in range(0, c, block):
        coefs = torch.abs(namresid[:, lo:lo + block].T @ ycond) * inv_n
        tails += _tail_hist_uniform(coefs, t0, dt, n_bins, atol, rtol)
    return tails


def empirical_fdrs(z, znull, thresholds, atol=1e-8, rtol=1e-5):
    """FDR curve over magnitude thresholds from permutation nulls.

    Reference ``empirical_fdrs`` (``_stats.py:64-83``): for each threshold,
    FDP per null = (#null stats past threshold) / (#observed stats past
    threshold); FDR = mean FDP over nulls.

    Fast path (the association default, where thresholds are an
    ``np.arange`` grid): the denominator is shared across nulls, so the
    mean of per-null FDPs is (total null tail counts) / (m * observed
    tail counts), one collapsed histogram.

    Args:
      z: (C,) observed statistics (e.g. neighborhood coefficients).
      znull: (C, m) null statistics.
      thresholds: (T,) increasing magnitude thresholds (host array).

    Returns (T,) FDR values (tensor in the default float).
    """
    ftype = config.default_float()
    z = _as_tensor(z)
    znull = _as_tensor(znull, like=z)
    spacing = _uniform_spacing(thresholds)
    if spacing is not None:
        t0, dt = spacing
        m = znull.shape[1] if znull.dim() == 2 else 1
        n_bins = len(np.asarray(thresholds))
        tails_total = _tail_hist_uniform(znull, t0, dt, n_bins, atol, rtol)
        ranks = _tail_hist_uniform(z, t0, dt, n_bins, atol, rtol)
        return tails_total.to(ftype) / (m * ranks.to(ftype))

    thr = _as_tensor(thresholds, like=z)
    tails = tail_counts(thr, znull, atol=atol, rtol=rtol)  # (m, T)
    ranks = tail_counts(thr, z, atol=atol, rtol=rtol)  # (1, T)
    fdp = tails.to(ftype) / ranks.to(ftype)
    return fdp.mean(dim=0)


def empirical_fwers(z, n_max_z2, atol=1e-8, rtol=1e-5):
    """Permutation FWER for each entry of ``z``.

    Reference ``_stats.py:85-88``: ``n_max_z2`` holds the max squared null
    statistic per null instantiation.
    """
    z = _as_tensor(z)
    n_max_z2 = _as_tensor(n_max_z2, like=z)
    tc = tail_counts(z, torch.sqrt(n_max_z2), atol=atol, rtol=rtol)[0]
    return (tc + 1).to(config.default_float()) / (len(n_max_z2) + 1)


def minfwer_loo(n_max_z2, atol=1e-8, rtol=1e-5):
    """Leave-one-out minimal attainable FWER (reference ``_stats.py:90-92``).

    ``atol``/``rtol`` are accepted for signature parity with the reference
    and ignored, exactly as the reference ignores them.
    """
    del atol, rtol
    n_max_z2 = _as_tensor(n_max_z2)
    tc = (n_max_z2[None, :] >= n_max_z2[:, None]).sum(dim=1)
    return (tc + 1).to(config.default_float()) / len(n_max_z2)


def _chi2_sf_1dof(x):
    """Survival function of chi-square with 1 degree of freedom."""
    return torch.special.erfc(torch.sqrt(x / 2.0))


def _numtests_rows(maxs_desc):
    """``numtests`` of each row of a (R, M) descending-sorted tensor."""
    j, k = 0, 10
    m = maxs_desc.shape[1]
    fwers = (torch.arange(j, k, dtype=maxs_desc.dtype,
                          device=maxs_desc.device) + 1) / (m + 1)
    ps = _chi2_sf_1dof(maxs_desc[:, j:k])
    return 1.0 / ((ps @ fwers) / (fwers @ fwers))


def numtests(n_max_z2):
    """Effective-number-of-tests estimator (reference ``_stats.py:94-99``)."""
    n_max_z2 = _as_tensor(n_max_z2)
    maxs = torch.sort(n_max_z2, descending=True).values
    return _numtests_rows(maxs[None, :])[0]


def numtests_loo(n_max_z2):
    """Leave-one-out effective-number-of-tests (reference ``_stats.py:101-105``)."""
    n_max_z2 = _as_tensor(n_max_z2)
    n = len(n_max_z2)
    # row i holds every value but the i-th: put +inf at the diagonal and
    # drop the largest entry after sorting
    rows = n_max_z2[None, :].repeat(n, 1)
    rows.fill_diagonal_(torch.inf)
    rest = torch.sort(rows, dim=1).values[:, : n - 1]
    return _numtests_rows(rest.flip(1))
