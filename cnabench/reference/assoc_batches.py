"""The association with batches and covariates, plainly: CNA as upstream
``cna`` v0.2.3 defines it (Reshef et al., Nat. Biotechnol. 2022), in a
``Precision``, on any device, blocked where the atlas is large.  The
benchmark's copy of ``plain_reference/cna_batches.py`` (which the tier-1
tests hold the program to at a small size; this file lives under the
benchmark's paths so that a run over any checkout finds it).  The NAM
comes from ``reference.assoc.diffuse``; the F-test, the tail counts and
the write-back are ``reference.assoc``'s.

* QC: per neighbourhood the Pearson kurtosis of the per-batch means of its
  NAM column; drop where it is >= max(6, 2 median).
* Residualize: centre the NAM; standardize the batch dummies and the
  covariates (ddof 1); for each ridge of ``RIDGES``
  ``M = I - C (C'C + ridge n L)^-1 C'`` (``L`` selects the dummies),
  ``NAM_ = M NAM_`` cumulatively, until the median batch kurtosis of
  ``NAM_`` is <= 6; the last ``M`` goes on to the test.  Then
  ``reference.assoc``'s standardization and Gram eigendecomposition.
* Test: the F-test min-p of ``M y`` with ``d2 = n - (1 + r + k)``, ``r``
  the columns of ``C``; null coefficients from ``M y_`` (ddof 1).

Departures from upstream, as the program's: the ridge list ends at 1e-4
then 0 (upstream also has 1e-5); the nulls are given (drawn within
batches by the benchmark); ``ssefull`` is upstream's subtraction, in
float64 where it costs nothing.
"""

from __future__ import annotations

import numpy as np
import torch

from . import Precision, mm
from . import assoc as ref_assoc

RIDGES = (1e5, 1e4, 1e3, 1e2, 1e1, 1e0, 1e-1, 1e-2, 1e-3, 1e-4, 0.0)


def batch_kurtosis(nam, bcodes, nb, prec: Precision):
    """Pearson kurtosis (C,) of each column's per-batch means."""
    onehot = (bcodes[:, None] == torch.arange(nb, device=nam.device)
              [None, :]).to(prec.dtype)
    means = mm(onehot.T.contiguous(), nam, prec) / onehot.sum(dim=0)[:, None]
    return ref_assoc.kurtosis_rows(means.T) + 3.0


def qc_keep(nam, bcodes, nb, prec: Precision):
    """Boolean (C,) keep of the batch-kurtosis QC."""
    kurt = batch_kurtosis(nam, bcodes, nb, prec)
    return kurt < max(6.0, 2.0 * float(ref_assoc.median(kurt)))


def standardize(x, ddof=1):
    return (x - x.mean(dim=0)) / x.std(dim=0, correction=ddof)


def design(bcodes, nb, covs, prec: Precision):
    """(C (n, nb + q), nb): the standardized batch dummies, then the
    standardized covariates (``covs`` a host array or None)."""
    dev = bcodes.device
    dummies = (bcodes[:, None] == torch.arange(nb, device=dev)[None, :])
    parts = [standardize(dummies.to(prec.dtype))]
    if covs is not None:
        parts.append(standardize(torch.as_tensor(np.asarray(covs, float),
                                                 device=dev).to(prec.dtype)))
    return torch.cat(parts, dim=1), nb


def projector(c, ridge, nbcols, prec: Precision):
    n, r = c.shape
    pen = torch.zeros(r, dtype=c.dtype, device=c.device)
    pen[:nbcols] = ridge * n
    ct = c.T.contiguous()
    sol = torch.linalg.solve(mm(ct, c, prec) + torch.diag(pen), ct)
    return torch.eye(n, dtype=c.dtype, device=c.device) - mm(c, sol, prec)


def residualize(nam, bcodes, nb, covs, prec: Precision, steps=None):
    """dict of ``namresid`` (S, C), ``M``, ``r``, ``steps``, ``trail``,
    ``u`` and ``svs``: the ridge sweep by its rule, or exactly ``steps``
    ridge steps where given."""
    c, nbcols = design(bcodes, nb, covs, prec)
    nam_r = nam - nam.mean(dim=0, keepdim=True)
    trail = []
    for ridge in RIDGES:
        m = projector(c, ridge, nbcols, prec)
        nam_r = mm(m, nam_r, prec)
        trail.append(float(ref_assoc.median(
            batch_kurtosis(nam_r, bcodes, nb, prec))))
        if (len(trail) == steps if steps is not None else trail[-1] <= 6):
            break
    # reference.assoc's standardization and Gram decomposition (with no
    # covariates its centring is a no-op on the already centred NAM_)
    namresid, u, svs = ref_assoc.resid_svd(nam_r, prec)
    return dict(namresid=namresid, M=m, r=c.shape[1], steps=len(trail),
                trail=trail, u=u, svs=svs)


def ridge_gaps(m_subject, bcodes, nb, covs):
    """Largest gap of a subject's ``M`` to the float64 ``M`` of each ridge
    of ``RIDGES``: the subject's ridge steps are the nearest's index + 1."""
    prec = Precision("float64")
    c, nbcols = design(bcodes, nb, covs, prec)
    m = torch.as_tensor(np.asarray(m_subject), device=c.device,
                        dtype=torch.float64)
    return [float((projector(c, ridge, nbcols, prec) - m).abs().max())
            for ridge in RIDGES]


def association(res, y, nulls, prec: Precision, thresholds=None):
    """The test of phenotype ``y`` (n,) with null phenotypes ``nulls``
    (n, Nnull) on the residualized state ``res`` (``residualize``).
    Returns a dict of host values (``reference.assoc.association``'s
    keys)."""
    namresid, u, m, r = res["namresid"], res["u"], res["M"], res["r"]
    dev = namresid.device
    n = y.shape[0]
    ks = ref_assoc.ks_grid(n)
    y = torch.as_tensor(y, device=dev, dtype=prec.dtype)
    nulls = torch.as_tensor(nulls, device=dev, dtype=prec.dtype)
    ystd = (y - y.mean()) / y.std(correction=0)
    k, p_obs, ps_obs = ref_assoc.minp(u, mm(m, ystd[:, None], prec), ks,
                                      prec, r=r)
    _, nullminps, _ = ref_assoc.minp(u, mm(m, nulls, prec), ks, prec, r=r)
    p_obs = float(p_obs[0])
    pfinal = (float((nullminps <= p_obs + 1e-8).sum()) + 1) / (
        nulls.shape[1] + 1)
    ncorrs = mm(namresid.T.contiguous(), ystd[:, None], prec)[:, 0] / n
    if thresholds is None:
        maxcorr = max(float(ncorrs.abs().max()), 0.001)
        thresholds = np.arange(maxcorr / 4, maxcorr, maxcorr / 400)
    edges = torch.as_tensor(ref_assoc.tail_edges(thresholds), device=dev)
    n_local = min(1000, nulls.shape[1])
    tails = ref_assoc.null_tail_counts(
        namresid, mm(m, nulls[:, :n_local], prec), edges, prec)
    ranks = ref_assoc.tail_counts(ncorrs, edges)
    fdr = tails.double() / (n_local * ranks.double())
    return dict(k=int(k[0]), p_obs=p_obs, ps_obs=ps_obs[:, 0], ks=ks,
                nullminps=nullminps, p=pfinal,
                ncorrs=ncorrs.double().cpu().numpy(),
                thresholds=np.asarray(thresholds),
                fdr=fdr.cpu().numpy(), ranks=ranks.cpu().numpy())
