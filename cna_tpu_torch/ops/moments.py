"""Moment statistics (kurtosis, standardization, correlation, medians).

These replace the scipy/pandas statistic calls the reference makes on
host numpy arrays:

* Fisher kurtosis with biased moments (``scipy.stats.kurtosis``
  defaults), used by the diffusion stopping rule (reference
  ``_nam.py:59``) and the batch-QC / ridge-sweep checks
  (``_nam.py:80-82,150``).
* Column standardization with explicit ``ddof``: the reference mixes
  pandas (ddof=1, e.g. ``_nam.py:104,126,159``) and numpy (ddof=0, e.g.
  ``_association.py:22,52,97``) conventions, and ``torch.std`` defaults
  to ddof=1, so every call site here states its ddof.
* Squared column correlation R², the step-to-step diffusion diagnostic
  (``_nam.py:47-49``).
* ``quantile`` / ``median`` with numpy's linear interpolation
  (``torch.median`` returns the lower middle value instead).
"""

from __future__ import annotations

import torch

_QUANTILE_MAX_ELEMENTS = 1 << 24  # torch.quantile refuses larger inputs


def quantile(x, q: float):
    """The ``q``-quantile of all entries of ``x`` with linear
    interpolation (numpy's default; ``np.median`` at q=0.5).  NaN if any
    entry is NaN.  A 0-d tensor on ``x``'s device."""
    flat = x.reshape(-1)
    if flat.numel() <= _QUANTILE_MAX_ELEMENTS:
        return torch.quantile(flat, q)
    s = torch.sort(flat).values
    pos = q * (s.numel() - 1)
    lo = int(pos)
    hi = min(lo + 1, s.numel() - 1)
    val = s[lo] + (s[hi] - s[lo]) * (pos - lo)
    return torch.where(torch.isnan(flat).any(), torch.nan, val)


def median(x):
    """Median of all entries; the mean of the two middle values at even
    length, as ``np.median`` / ``jnp.median`` give."""
    return quantile(x, 0.5)


def kurtosis(x, axis=0):
    """Fisher (excess) kurtosis with biased moment estimators.

    Matches ``scipy.stats.kurtosis(x, axis=axis)`` defaults
    (fisher=True, bias=True): ``m4 / m2**2 - 3`` with population moments.
    Zero-variance slices yield NaN (0/0), as scipy's default propagates.
    """
    m = x.mean(dim=axis, keepdim=True)
    d = x - m
    d2 = d * d
    m2 = d2.mean(dim=axis)
    m4 = (d2 * d2).mean(dim=axis)
    return m4 / (m2 * m2) - 3.0


def colstd(x, ddof=0, axis=0):
    """Standard deviation along ``axis`` with explicit ddof.

    ddof=0 reproduces ``np.std``; ddof=1 reproduces ``pandas.std``.
    """
    n = x.shape[axis]
    m = x.mean(dim=axis, keepdim=True)
    ss = ((x - m) ** 2).sum(dim=axis)
    return torch.sqrt(ss / (n - ddof))


def standardize(x, ddof=0, axis=0):
    """(x - mean) / std along ``axis``."""
    m = x.mean(dim=axis, keepdim=True)
    s = colstd(x, ddof=ddof, axis=axis)
    return (x - m) / s.unsqueeze(axis)


def scale_by_std(x, ddof=0, axis=0):
    """x / std(x) along ``axis`` WITHOUT centering.

    This is what ``zcond / zcond.std()`` does in the reference
    (``_association.py:52,71,97``): the std is computed about the mean but
    the vector itself is not recentered.
    """
    s = colstd(x, ddof=ddof, axis=axis)
    return x / s.unsqueeze(axis)


def column_r2(a, b, ddof=1):
    """Squared Pearson correlation of matching columns of ``a`` and ``b``.

    Mirrors the diffusion diagnostic ``R(A, B)**2`` at reference
    ``_nam.py:47-49``: a mean-normalized cross moment divided by ddof=1
    (pandas) stds.  Constant columns give NaN.
    """
    am = a - a.mean(dim=0)
    bm = b - b.mean(dim=0)
    cov = (am * bm).mean(dim=0)
    r = cov / colstd(a, ddof=ddof) / colstd(b, ddof=ddof)
    return r * r


def column_r2_counted(a, b, n_true, ddof=1):
    """``column_r2`` for arrays whose rows beyond ``n_true`` are zero padding.

    Computed from raw sums with divisor ``n_true``.  Zero-variance columns
    (e.g. the all-zero "previous state" on the first diffusion step) give
    +inf instead of the reference's NaN (real R^2 <= 1, so the sentinel is
    unambiguous; the diagnostics printer renders it back as nan).  The
    zero test is RELATIVE to each column's magnitude: cancellation in
    ``saa - n*ma*ma`` can leave a varying column with a tiny negative
    variance, which must not trip the sentinel.
    """
    return column_r2_from_sums(column_sums(a, b), n_true, ddof)


def column_sums(a, b):
    """The raw column sums ``column_r2_counted`` needs, stacked (5, S):
    sum a, sum b, sum a*a, sum b*b, sum a*b.  Row blocks of a sharded
    state add up to the whole's."""
    return torch.stack([a.sum(dim=0), b.sum(dim=0), (a * a).sum(dim=0),
                        (b * b).sum(dim=0), (a * b).sum(dim=0)])


def column_r2_from_sums(sums, n_true, ddof=1):
    """``column_r2_counted`` from ``column_sums`` (5, S)."""
    n = n_true
    sa, sb, saa, sbb, sab = sums
    ma, mb = sa / n, sb / n
    cov = sab / n - ma * mb
    var_a = (saa - n * ma * ma) / (n - ddof)
    var_b = (sbb - n * mb * mb) / (n - ddof)
    eps = 16 * torch.finfo(sums.dtype).eps
    safe = ((var_a > eps * torch.abs(saa / n))
            & (var_b > eps * torch.abs(sbb / n)))
    denom = var_a * var_b
    r2 = (cov * cov) / torch.where(safe, denom, torch.ones_like(denom))
    return torch.where(safe, r2, torch.full_like(r2, torch.inf))


def _group_onehot(group_ids, num_groups, dtype):
    """(n, num_groups): 1 where row j of the data is in group g."""
    groups = torch.arange(num_groups, device=group_ids.device)
    return (group_ids[:, None] == groups[None, :]).to(dtype)


def grouped_mean(x, group_ids, num_groups):
    """Mean of rows of ``x`` within each group.

    ``group_ids``: int tensor (n,) with values in [0, num_groups).
    Returns (num_groups, x.shape[1]).  Used for per-batch neighborhood
    abundance means (reference ``_batch_kurtosis``, ``_nam.py:80-82``).
    """
    onehot = _group_onehot(group_ids, num_groups, x.dtype)
    counts = onehot.sum(dim=0)
    sums = onehot.T @ x
    return sums / counts[:, None]


def group_mean_weights(group_ids, num_groups, dtype):
    """(num_groups, n) averaging matrix ``G``: row g holds 1/count_g at the
    rows of group g, so ``G @ x`` is ``grouped_mean(x, ...)`` up to
    rounding, and ``(G @ A) @ x`` the group means of ``A @ x``."""
    onehot = _group_onehot(group_ids, num_groups, dtype)
    return onehot.T / onehot.sum(dim=0)[:, None]


def pearson_kurtosis_of_means(means):
    """Pearson kurtosis (Fisher + 3) of each column of per-batch means
    (num_batches, C): ``batch_kurtosis`` from means computed elsewhere."""
    return kurtosis(means, axis=0) + 3.0


def batch_kurtosis(nam, batch_ids, num_batches):
    """Pearson kurtosis (Fisher + 3) across per-batch mean abundances.

    Reference ``_batch_kurtosis`` (``_nam.py:78-82``): for each NAM column
    (neighborhood), take the mean abundance within each batch, then the
    kurtosis of those ``num_batches`` values, plus 3 (Pearson convention).
    """
    return pearson_kurtosis_of_means(grouped_mean(nam, batch_ids, num_batches))
