"""``cna_tpu_torch.tl.association`` on a population cohort's shape against
the plain float64 reference ``plain_reference/cna_batches.py`` (CPU,
float64 on both sides), and the spans and counters of the residualize
layer and of the job's device memory.

The cohort is the benchmark's generator (``cnabench/data/onek1k.py``) at
a small size: 156 donors in 12 pools of 13, 25 cells a donor on average,
the 8 covariates of the cohort (age, sex, 6 genotype PCs), the planted
SNP's dosage as the phenotype and 200 nulls permuted within pools.  Two
pool offsets: one under which the QC drops neighbourhoods (the sweep
stops at its first ridge) and one under which the sweep takes every
ridge (the median batch kurtosis stays above 6; twice it is out of reach
of 12 pool means, so the QC drops none).
"""

import warnings

import numpy as np
import pytest

import cna_tpu_torch as ct
from cna_tpu_torch.utils import profiling
from cnabench import run
from cnabench.kinds import load
from plain_reference import cna_batches as ref

from .torch_atlas import sample_codes
from .torch_parity import torch_cpu_x64  # noqa: F401

COHORT = dict(n_samples=156, n_cells=156 * 25, min_cells=10, nnull=200)
OFFSETS = {"drops": 0.3, "sweeps": 0.45}


def cohort_job(offset, seed=7):
    """(CellData with its graph, the kind with its inputs, y, nulls)."""
    bench = run.load_json(run.ROOT / "BENCHMARK.json")
    _, cfg, traffic, _ = run.cell_files(bench, "onek1k.assoc")
    cfg.update(COHORT, batch_offset=offset)
    kind = load(traffic["job"])(cfg, traffic, seed, "cpu")
    kind.prepare()
    # float64 cells, so that the port computes in float64 throughout
    d = ct.CellData(X=kind.x.astype(np.float64), obs=kind.obs)
    ct.pp.pca(d, n_comps=10)
    ct.pp.neighbors(d, n_neighbors=10)
    y, nulls = kind.pool[0]
    return d, kind, y, nulls.astype(np.float64)


def traced_association(d, kind, y, nulls):
    prof = profiling.enable_profiling()
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            res = ct.tl.association(d, y, "id", batches=kind.batches,
                                    covs=kind.covs, Nnull=nulls.shape[1],
                                    null_y=nulls, return_full=True)
    finally:
        profiling.disable_profiling()
    return res, prof.phases


@pytest.fixture(scope="module", params=list(OFFSETS))
def case(request):
    d, kind, y, nulls = cohort_job(OFFSETS[request.param])
    res, phases = traced_association(d, kind, y, nulls)
    return request.param, d, kind, y, nulls, res, phases


def test_cohort_shape(case):
    _, d, kind, y, _, res, _ = case
    assert kind.batches.nunique() == 12 and kind.covs.shape == (156, 8)
    assert set(np.unique(y)) <= {0.0, 1.0, 2.0} and y.nunique() > 1
    # 12 pools and 8 covariates: r = 20 columns in the projector
    assert res.r == 20
    assert d.n_obs == 156 * 25


def test_cohort_association_matches_the_plain_reference(case):
    name, d, kind, y, nulls, res, phases = case
    nam, _ = ref.diffuse(d.obsp["connectivities"], sample_codes(d.obs, y),
                         len(y))
    want = ref.association(nam, y.to_numpy(), kind.batches.to_numpy(),
                           kind.covs.to_numpy(), nulls,
                           thresholds=res.fdrs.threshold.to_numpy())
    counts = {p["phase"]: p for p in phases}
    # the regime each offset is there to exercise
    if name == "drops":
        assert (~want["qc_keep"]).sum() > 0 and want["steps"] == 1
    else:
        assert (~want["qc_keep"]).sum() == 0 and want["steps"] >= 3
    # the QC keep and the ridge steps: decisions, exact
    np.testing.assert_array_equal(res.kept, want["kept"])
    assert counts["batch_qc"]["dropped"] == (~want["qc_keep"]).sum()
    assert counts["ridge_sweep"]["ridges"] == want["steps"]
    np.testing.assert_allclose(res.M.to_numpy(), want["M"], rtol=0,
                               atol=1e-10)
    assert res.k == want["k"]
    # the global p counts nulls at or below the observed p: equal counts
    assert res.p == want["p"]
    np.testing.assert_allclose(res.nullminps, want["nullminps"], rtol=1e-8)
    scale = np.abs(want["ncorrs"]).max()
    np.testing.assert_allclose(res.ncorrs, want["ncorrs"], rtol=0,
                               atol=1e-10 * scale)
    # tail counts of the same grid: a count moves only at a tie
    np.testing.assert_allclose(res.fdrs.fdr.to_numpy(), want["fdr"],
                               rtol=1e-12)
    np.testing.assert_allclose(d.obs["coef"].to_numpy(), want["coef"],
                               rtol=0, atol=1e-10 * scale)
    np.testing.assert_array_equal(d.obs["coef_fdr"].to_numpy(),
                                  want["coef_fdr"])


def test_gram_svd_span_sits_in_residualize(case):
    *_, phases = case
    by_id = {p["id"]: p for p in phases}
    (svd,) = [p for p in phases if p["phase"] == "gram_svd"]
    (root,) = [p for p in phases if p["parent"] is None]
    assert by_id[svd["parent"]]["phase"] == "residualize"
    assert svd["root"] == root["id"] and svd["host_seconds"] > 0
    (sweep,) = [p for p in phases if p["phase"] == "ridge_sweep"]
    # the decomposition follows the sweep inside the one residualize span
    assert sweep["parent"] == svd["parent"]


def test_mem_peak_is_counted_on_a_card_only(case):
    *_, phases = case
    (root,) = [p for p in phases if p["parent"] is None]
    assert root["phase"] == "association"
    assert not any("mem_peak" in p for p in phases)
