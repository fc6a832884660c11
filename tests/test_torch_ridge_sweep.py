"""The ridge sweep of ``cna_tpu_torch.tools._nam._resid_nam_core`` against
the plain float64 reference ``plain_reference/cna_batches.residualize``
(CPU, float64 on both sides).

The program composes each ridge's S x S projector into ``M_cum``, reads the
running NAM's per-batch means as ``(G @ M_cum) @ nam_c`` and multiplies
the NAM once at the stop; the reference multiplies the running NAM by
every projector in turn.  The same projectors, in another float64 order:
the steps are equal, ``M`` is the last projector bit for bit, and
``namresid``, ``u`` and ``svs`` agree to 1e-10 of their scale.

The trail agrees to rounding amplified by the shrinkage: each ridge
shrinks the batch means, to about 1e-10 of their start at ridge 1e-4, so
an entry's rounding, in either order, is float64's epsilon times
``kappa`` (the centred NAM's norm over the running batch means' norm);
both orders read within 2.2 eps kappa of each other here.  At ridge 0 the
means are rounding alone and the entry is noise on both sides; it is the
schedule's last, so no decision hangs on it.

Seeded sample-level matrices: 200 samples in 40 batches, 3,000
neighbourhoods, four covariates; each neighbourhood raised in one home
batch by an exponential offset whose scale sets the regime: the sweep
stops at its first ridge (1), in mid-schedule (3.2: the median kurtosis
reaches 6 at ridge 1e-3, the ninth), or takes every ridge (10: only
ridge 0 brings it under 6).
"""

import numpy as np
import pandas as pd
import pytest
import torch

from cna_tpu_torch.ops import linalg
from cna_tpu_torch.tools import _nam
from cna_tpu_torch.utils import profiling
from plain_reference import cna_batches as ref

from .torch_parity import torch_cpu_x64  # noqa: F401

S, NB, CELLS = 200, 40, 3000
REGIMES = {"first": (1.0, 1), "mid": (3.2, 9), "every": (10.0, 11)}
EPS = torch.finfo(torch.float64).eps


def _cohort(scale, nb=NB):
    rng = np.random.default_rng(20)
    batch = rng.permutation(np.arange(S) % nb)
    x = rng.standard_normal((S, CELLS))
    home = rng.integers(0, nb, CELLS)
    x += (batch[:, None] == home[None, :]) * rng.exponential(scale, CELLS)
    covs = rng.standard_normal((S, 4))
    return x, batch, covs


def _kappa(x, batch, covs, steps):
    """Per ridge step, the centred NAM's norm over the norm of the running
    NAM's centred batch means, compounded the reference's way."""
    bcodes = torch.as_tensor(batch)
    nam = torch.tensor(x)
    nam = nam - nam.mean(dim=0)
    base = nam.norm()
    c, nb = ref.design(bcodes, torch.as_tensor(covs))
    out = []
    for ridge in ref.RIDGES[:steps]:
        nam = ref.projector(c, ridge, nb) @ nam
        means = torch.stack([nam[bcodes == b].mean(dim=0)
                             for b in torch.unique(bcodes)])
        out.append((base / (means - means.mean(dim=0)).norm()).item())
    return np.array(out)


def _run(x, batch, covs, monkeypatch):
    """The core's outputs, its sweep's (arguments, returns) (None without
    a sweep) and its span records."""
    swept = []
    sweep = _nam._ridge_sweep

    def recording(*args):
        out = sweep(*args)
        swept.append((args, out))
        return out

    monkeypatch.setattr(_nam, "_ridge_sweep", recording)
    samples = pd.Index(range(S))
    prof = profiling.enable_profiling()
    try:
        out = _nam._resid_nam_core(torch.tensor(x), covs,
                                   pd.Series(batch, index=samples), samples)
    finally:
        profiling.disable_profiling()
    return out, (swept[0] if swept else None), prof.phases


@pytest.mark.parametrize("regime", list(REGIMES))
def test_composed_sweep_matches_the_compounding_reference(regime,
                                                          monkeypatch):
    scale, steps = REGIMES[regime]
    x, batch, covs = _cohort(scale)
    out, (args, (_, _, n_ridges, trail)), phases = _run(x, batch, covs,
                                                        monkeypatch)
    want = ref.residualize(torch.tensor(x), torch.as_tensor(batch),
                           torch.as_tensor(covs))

    # the regime, and the decision: equal steps
    assert n_ridges == want["steps"] == steps
    (span,) = [p for p in phases if p["phase"] == "ridge_sweep"]
    assert span["ridges"] == steps and span["nam_products"] == 1

    # M: bit for bit the last ridge's projector as the compounding sweep
    # built it (its call on the sweep's design and schedule); and the
    # reference's own solve to rounding
    _, c, ridges, _, nbcols, _ = args
    m_last = linalg.residual_projector(c, ridge=ridges[steps - 1],
                                       n_batch_cols=nbcols)
    assert torch.equal(out["m"], m_last)
    np.testing.assert_allclose(out["m"].numpy(), want["M"].numpy(), rtol=0,
                               atol=1e-10)

    # the trail: the kurtosis of the same means, to 64 eps kappa; each
    # entry before the stop on the reference's side of 6; past it, inf
    got, ref_trail = trail[:steps].numpy(), np.array(want["trail"])
    tol = 64 * EPS * _kappa(x, batch, covs, steps)
    assert (np.abs(got - ref_trail) <= tol * ref_trail).all()
    assert (got[:-1] > 6).all() and (ref_trail[:-1] > 6).all()
    assert torch.isinf(trail[steps:]).all()

    # namresid and the decomposition, to 1e-10 of their scale
    scale_nr = want["namresid"].abs().max().item()
    np.testing.assert_allclose(out["namresid"].numpy(),
                               want["namresid"].numpy(), rtol=0,
                               atol=1e-10 * scale_nr)
    np.testing.assert_allclose(out["svs"].numpy(), want["svs"].numpy(),
                               rtol=0, atol=1e-10 * want["svs"].max().item())
    # the components the test reads (the largest k of the grid), each up
    # to its sign
    k = int(ref.ks_grid(S).max())
    u, u_ref = out["u"][:, :k], want["u"][:, :k]
    u = u * torch.sign((u * u_ref).sum(dim=0))
    np.testing.assert_allclose(u.numpy(), u_ref.numpy(), rtol=0, atol=1e-10)


def test_one_batch_opens_no_ridge_sweep(monkeypatch):
    x, batch, covs = _cohort(3.0, nb=1)
    out, swept, phases = _run(x, batch, covs, monkeypatch)
    want = ref.residualize(torch.tensor(x), torch.as_tensor(batch),
                           torch.as_tensor(covs))
    assert swept is None and want["steps"] == 0
    assert "ridge_sweep" not in {p["phase"] for p in phases}
    assert not any("nam_products" in p for p in phases)
    np.testing.assert_allclose(out["m"].numpy(), want["M"].numpy(), rtol=0,
                               atol=1e-10)
    np.testing.assert_allclose(out["namresid"].numpy(),
                               want["namresid"].numpy(), rtol=0,
                               atol=1e-10 * want["namresid"].abs().max().item())
