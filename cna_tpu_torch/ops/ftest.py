"""Batched F-test / min-p machinery for the global association test.

The reference scores each candidate PC count ``k`` with an F statistic and
takes the minimum p over the grid, then repeats that whole computation in
a Python loop over every permuted phenotype (``_association.py:35-61,84``
— HOT LOOP 2).  Because the PC basis ``U`` is orthonormal, the sums of
squares for *all* ``k`` at once are cumulative sums of squared PC
loadings, so the entire (Nnull x |ks|) grid collapses into two matmuls and
a cumsum.

Math (per phenotype column z, with zcond = M z scaled to unit std):
  beta   = U' zcond                       (all npc loadings)
  ssered = zcond' zcond
  deltasse(k) = sum_{i<=k} beta_i^2       (orthonormal U => exact)
  ssefull(k)  = sum_{k<i<=npc} beta_i^2 + |zcond - U beta|^2
  F(k)   = (deltasse/k) / (ssefull/n)     ref ``_association.py:41-48``
  p(k)   = F_sf(F, k, n-(1+r+k))
  r2(k)  = deltasse/(deltasse + ssefull)  (= deltasse/ssered, at most 1)

The reference writes ``ssefull = ssered - deltasse``, equal in exact
arithmetic.  Here it is a sum of squares, non-negative by construction:
at an R^2 near 1 the subtraction cancels, and a float32 U from ``eigh``
is orthonormal only to a few 1e-5, which moves ``sum beta^2`` by more than
the residual (1M cells x 200 samples: ``sum beta^2`` 200.008 for
``ssered`` 200 and a residual of 0.006, so ``ssefull`` read negative and
p read 1).  The tail sum over the same U carries that error only through
the few loadings past k.  Summing in float64 instead does not help: the
error is in U, not in the sums.

The F survival function goes through the regularized incomplete beta
identity ``F_sf(f; d1, d2) = I_{d2/(d2+d1 f)}(d2/2, d1/2)``.
``torch.special`` has no incomplete beta, so ``betainc`` below evaluates
it in float64 by Lentz's continued fraction.
"""

from __future__ import annotations

import torch

from ..utils.transfer import scalar
from . import moments

_BETAINC_MAX_ITER = 1000
_BETAINC_EPS = 1e-15
_TINY = 1e-300


def betainc(a, b, x):
    """Regularized incomplete beta ``I_x(a, b)`` for tensors (broadcast),
    computed in float64 and returned in float64.

    Continued fraction (Lentz) on the side of the symmetry point
    ``x < (a+1)/(a+b+2)`` where it converges fast, using
    ``I_x(a, b) = 1 - I_{1-x}(b, a)`` on the other.  ``x`` must lie in
    [0, 1] and ``a, b > 0``; NaN inputs give NaN.
    """
    a, b, x = torch.broadcast_tensors(*(torch.as_tensor(v).double()
                                        for v in (a, b, x)))
    swap = x > (a + 1.0) / (a + b + 2.0)
    aa = torch.where(swap, b, a)
    bb = torch.where(swap, a, b)
    xx = torch.where(swap, 1.0 - x, x)

    lbeta = torch.lgamma(aa) + torch.lgamma(bb) - torch.lgamma(aa + bb)
    front = torch.exp(aa * torch.log(xx) + bb * torch.log1p(-xx) - lbeta) / aa

    def guard(v):
        return torch.where(v.abs() < _TINY, torch.full_like(v, _TINY), v)

    qab, qap, qam = aa + bb, aa + 1.0, aa - 1.0
    c = torch.ones_like(xx)
    d = 1.0 / guard(1.0 - qab * xx / qap)
    h = d
    for m in range(1, _BETAINC_MAX_ITER + 1):
        m2 = 2.0 * m
        num = m * (bb - m) * xx / ((qam + m2) * (aa + m2))
        d = 1.0 / guard(1.0 + num * d)
        c = guard(1.0 + num / c)
        h = h * d * c
        num = -(aa + m) * (qab + m) * xx / ((aa + m2) * (qap + m2))
        d = 1.0 / guard(1.0 + num * d)
        c = guard(1.0 + num / c)
        delta = d * c
        h = h * delta
        if m % 8 == 0 and not bool(
                scalar(((delta - 1.0).abs() > _BETAINC_EPS).any())):
            break
    val = front * h
    return torch.where(swap, 1.0 - val, val)


def f_sf(f, d1, d2):
    """Survival function of the F distribution, matching scipy.stats.f.sf.

    NaN for non-positive degrees of freedom (scipy convention); for f < 0
    scipy returns 1.0 (left of support).  Computed in float64 and returned
    in ``f``'s floating dtype.
    """
    f = torch.as_tensor(f)
    out_dtype = f.dtype if f.is_floating_point() else torch.float64
    f64 = f.double()
    d1 = torch.as_tensor(d1, device=f.device).double()
    d2 = torch.as_tensor(d2, device=f.device).double()
    valid_dof = (d1 > 0) & (d2 > 0)
    fpos = torch.clamp(f64, min=0.0)
    # guard the betainc arguments so invalid lanes produce no inf/nan
    safe_d1 = torch.where(valid_dof, d1, torch.ones_like(d1))
    safe_d2 = torch.where(valid_dof, d2, torch.ones_like(d2))
    x = safe_d2 / (safe_d2 + safe_d1 * fpos)
    val = betainc(safe_d2 / 2.0, safe_d1 / 2.0, x)
    val = torch.where(f64 < 0, torch.ones_like(val), val)
    val = torch.where(valid_dof, val, torch.full_like(val, torch.nan))
    return val.to(out_dtype)


def sums_of_squares(u, z, ks):
    """(deltasse (|ks|, m), ssefull (|ks|, m)) of the top-k regressions
    of the columns of ``z`` on ``u``'s leading columns.  ``ssefull`` is a
    sum of squares, never ``ssered - deltasse`` (module docstring)."""
    beta = u.T @ z  # (npc, m)
    b2 = beta * beta
    deltasse = torch.cumsum(b2, dim=0)[ks - 1, :]
    # tail[i] = sum_{j >= i} beta_j^2 (0-based), tail[npc] = 0; plus the
    # part of z outside span(U), 0 up to rounding for a full basis
    tail = torch.cat([b2.flip(0).cumsum(0).flip(0),
                      torch.zeros_like(b2[:1])])
    outside = torch.sum((z - u @ beta) ** 2, dim=0)
    return deltasse, tail[ks, :] + outside[None, :]


def minp_stats_batch(u, m_proj, y_cols, ks, r):
    """Vectorized min-p F-test over a PC-count grid, for many phenotypes.

    Equivalent to mapping reference ``_minp_stats`` (``_association.py:
    50-61``) over the columns of ``y_cols``:
      zcond = M y;  zcond /= std(zcond)
      for k in ks: F-test of top-k PC regression; pick k minimizing p.

    ddof note: the reference's ``M.dot(z)`` is a pandas object, so its
    ``zcond.std()`` is ddof=1; the F statistic is scale-invariant, so
    either convention gives identical k/p/r2, and ddof=0 is used here.
    Scale-SENSITIVE consumers of zcond (beta, yresid) use ddof=1, see
    ``_assoc_observed`` in ``tools/_association.py``.

    Args:
      u: (n, npc) orthonormal sample-by-PC basis (npc >= max(ks)).
      m_proj: (n, n) residualizing projector.
      y_cols: (n, m) phenotype columns (observed and/or permuted).
      ks: int64 tensor (|ks|,) of candidate PC counts.
      r: number of covariate columns (for the F denominator dof).

    Returns (k_sel (m,), p_sel (m,), r2_sel (m,)).
    """
    n = y_cols.shape[0]
    z = m_proj @ y_cols
    z = moments.scale_by_std(z, ddof=0, axis=0)
    deltasse, ssefull = sums_of_squares(u, z, ks)
    ksf = ks.to(z.dtype)[:, None]
    fstat = (deltasse / ksf) / (ssefull / n)
    d2 = (n - (1.0 + r + ksf)).expand_as(fstat)
    ps = f_sf(fstat, ksf.expand_as(fstat), d2)
    r2s = deltasse / (deltasse + ssefull)
    # nanargmin over the ks axis (reference ``_association.py:60``); on
    # ties torch.argmin returns the first index, as numpy does
    ps_for_min = torch.where(torch.isnan(ps), torch.full_like(ps, torch.inf),
                             ps)
    sel = torch.argmin(ps_for_min, dim=0)  # (m,)
    mcols = torch.arange(y_cols.shape[1], device=y_cols.device)
    return ks[sel], ps[sel, mcols], r2s[sel, mcols]
