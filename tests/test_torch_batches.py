"""``cna_tpu_torch.tl.association`` with batches and covariates against
the plain float64 reference ``plain_reference/cna_batches.py`` (CPU,
float64 on both sides).

The atlas (``tests/torch_atlas.py``): 40 samples of 60 to 120 cells, 20
batches of two samples shifted by seeded offsets, three covariates, 200
nulls drawn within batches.  Twenty batches and not four: the Pearson
kurtosis of four batch means is at most 2.33, so with four batches the QC
could never drop a neighbourhood nor the ridge sweep take a second step.
The three cases: batches alone with offsets that make the QC drop
neighbourhoods (the sweep stops at its first ridge), covariates alone (no
QC, no sweep, the exact projector), and both, with offsets under which the
sweep takes many ridge steps (and the QC drops none: the median kurtosis
is then so high that twice it is out of reach).
"""

import ast
import warnings
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import torch

import cna_tpu_torch as ct
from cna_tpu_torch.tools import _nam
from cna_tpu_torch.utils import profiling
from plain_reference import cna_batches as ref

from .torch_atlas import batch_atlas, sample_codes
from .torch_parity import torch_cpu_x64  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
CASES = {"batches": dict(offset=0.3, batches=True, covs=False),
         "covs": dict(offset=0.3, batches=False, covs=True),
         "both": dict(offset=0.6, batches=True, covs=True)}


def run_both(case):
    """The program's result and span counters, and the reference's."""
    c = CASES[case]
    x, obs, y, batches, covs, nulls = batch_atlas(0, offset=c["offset"])
    d = ct.CellData(X=x, obs=obs)
    ct.pp.pca(d, n_comps=10)
    ct.pp.neighbors(d, n_neighbors=10)
    b = batches if c["batches"] else None
    cv = covs if c["covs"] else None
    prof = profiling.enable_profiling()
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            res = ct.tl.association(d, y, "id", batches=b, covs=cv,
                                    Nnull=nulls.shape[1], null_y=nulls,
                                    return_full=True)
    finally:
        profiling.disable_profiling()
    counts = {p["phase"]: p for p in prof.phases}
    nam, _ = ref.diffuse(d.obsp["connectivities"], sample_codes(obs, y),
                         len(y))
    want = ref.association(
        nam, y.to_numpy(),
        b.to_numpy() if b is not None else np.zeros(len(y), np.int64),
        cv.to_numpy() if cv is not None else None, nulls,
        thresholds=res.fdrs.threshold.to_numpy())
    return d, res, counts, want


@pytest.mark.parametrize("case", list(CASES))
def test_association_with_batches_matches_the_plain_reference(case):
    d, res, counts, want = run_both(case)
    # the regime each case is there to exercise
    if case == "batches":
        assert (~want["qc_keep"]).sum() > 0 and want["steps"] == 1
    if case == "both":
        assert want["steps"] >= 3
    # kept mask and ridge steps: decisions, exact
    np.testing.assert_array_equal(res.kept, want["kept"])
    if case == "covs":
        assert "batch_qc" not in counts and "ridge_sweep" not in counts
    else:
        assert counts["batch_qc"]["dropped"] == (~want["qc_keep"]).sum()
        assert counts["ridge_sweep"]["ridges"] == want["steps"]
    # M: two float64 solves of one system, ~1e-15 apart
    np.testing.assert_allclose(res.M.to_numpy(), want["M"], rtol=0,
                               atol=1e-10)
    assert res.k == want["k"]
    # the global p counts nulls at or below the observed p: equal counts
    assert res.p == want["p"]
    # two incomplete-beta evaluations (a continued fraction here, scipy's
    # there) agree to ~1e-10 relative
    np.testing.assert_allclose(res.nullminps, want["nullminps"], rtol=1e-8)
    # float64 products in another order: rounding, 1e-12 of the scale
    scale = np.abs(want["ncorrs"]).max()
    np.testing.assert_allclose(res.ncorrs, want["ncorrs"], rtol=0,
                               atol=1e-10 * scale)
    # tail counts of the same grid: a count moves only at a tie
    np.testing.assert_allclose(res.fdrs.fdr.to_numpy(), want["fdr"],
                               rtol=1e-12)
    # the write-back: NaN where dropped, the coefficient elsewhere
    np.testing.assert_allclose(d.obs["coef"].to_numpy(), want["coef"],
                               rtol=0, atol=1e-10 * scale)
    np.testing.assert_array_equal(d.obs["coef_fdr"].to_numpy(),
                                  want["coef_fdr"])


def test_float32_nam_sweeps_where_the_float64_reference_stops():
    """A float32 NAM whose median batch kurtosis reaches 6 only at a small
    ridge (6.40 at 1e-3, 5.79 at 1e-4): the program's sweep, in float64,
    takes the reference's 10 steps and its M is the reference's up to the
    float32 rounding of M; a float32 sweep stopped after 9."""
    rng = np.random.default_rng(0)
    s, nb, c = 259, 46, 3000
    batch = rng.permutation(np.arange(s) % nb)
    x = rng.standard_normal((s, c))
    home = rng.integers(0, nb, c)
    x += (batch[:, None] == home[None, :]) * rng.exponential(3, c)[None, :]
    covs = rng.standard_normal((s, 4))
    samples = pd.Index(range(s))
    arr = torch.tensor(x, dtype=torch.float32)
    prof = profiling.enable_profiling()
    try:
        out = _nam._resid_nam_core(arr, covs, pd.Series(batch, index=samples),
                                   samples)
    finally:
        profiling.disable_profiling()
    (sweep,) = [p for p in prof.phases if p["phase"] == "ridge_sweep"]
    bcodes = torch.as_tensor(batch)
    want = ref.residualize(arr.double(), bcodes, torch.as_tensor(covs))
    assert sweep["ridges"] == want["steps"] == 10
    assert out["m"].dtype == torch.float32
    np.testing.assert_allclose(out["m"].double().numpy(), want["M"].numpy(),
                               rtol=0, atol=1e-7)


FORBIDDEN = {"jax", "jaxlib", "cna_tpu", "cna_tpu_torch"}


@pytest.mark.parametrize("path", ["plain_reference/cna_batches.py",
                                  "cnabench/reference/assoc_batches.py"])
def test_reference_imports_nothing_of_the_packages(path):
    tree = ast.parse((ROOT / path).read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    assert not names & FORBIDDEN, names & FORBIDDEN
