"""The cell ``onek1k.assoc``: its generator at the configuration's full
size (donors, cells, pools, dosages, covariates), the reference diffusion
the judge runs at that size against the plain one, and the cell on the
CPU at a small cohort's size - 156 donors in 12 pools of 13 - where it
reads ``correct`` and its new metric readers read, and where a run whose
batch path is broken underneath reads ``correct`` false.  The program
runs in float64 here, so a sound run holds the cell's limits easily.

    python -m pytest cnabench/tests/test_onek1k_assoc.py
"""

from __future__ import annotations

import json
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

from cnabench import kinds, run
from cnabench.data import onek1k
from cnabench.reference import Precision
from cnabench.reference import assoc as ref_assoc
from cnabench.reference import assoc_cohort as ref_c
from cnabench.reference import graph as ref_graph

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELL = "onek1k.assoc"
# 12 pools of 13 donors, 25 cells a donor on average: the QC drops about a
# tenth of the neighbourhoods and the sweep stops at its first ridge
SMALL = dict(n_samples=156, n_cells=156 * 25, min_cells=10, nnull=200,
             batch_offset=0.3)


@pytest.fixture
def x64():
    import cna_tpu_torch as ct

    ct.config.enable_x64(True)
    try:
        yield
    finally:
        ct.config.enable_x64(False)


def test_generator_at_the_configuration_size():
    _, cfg, traffic, _ = run.cell_files(BENCH, CELL)
    x, obs, samplem = onek1k.cohort(cfg, 2**32 - 7)
    assert x.shape == (1_267_758, 50) and x.dtype == np.float32
    assert samplem.shape[0] == 982 and obs["id"].nunique() == 982
    sizes = obs.groupby("id").size()
    assert sizes.sum() == 1_267_758 and sizes.min() >= 200
    pools = samplem["batch"].value_counts()
    assert onek1k.n_pools(cfg) == 76 == pools.size
    assert set(pools) <= {12, 13}
    assert set(samplem["dosage"]) == {0, 1, 2}
    assert list(samplem[onek1k.COVARIATES].columns) == onek1k.COVARIATES
    # the harness's 20-donor CPU size still has two pools
    assert onek1k.n_pools(dict(cfg, n_samples=20)) == 2


def test_phenotypes_are_dosages_permuted_within_pools():
    _, cfg, traffic, _ = run.cell_files(BENCH, CELL)
    cfg.update(SMALL)
    kind = kinds.load(traffic["job"])(cfg, traffic, 2**33 + 3, "cpu")
    kind.prepare()
    assert len(kind.pool) == traffic["phenotypes"]
    y0, _ = kind.pool[0]
    np.testing.assert_array_equal(y0, kind.samplem["dosage"])
    pools = kind.batches.to_numpy()
    for y, nulls in kind.pool:
        assert set(np.unique(y)) <= {0.0, 1.0, 2.0} and y.nunique() > 1
        ystd = (y - y.mean()) / y.std(ddof=0)
        assert nulls.shape == (156, 200)
        for b in np.unique(pools):
            # each null permutes the standardized dosages within a pool
            want = np.sort(ystd.to_numpy()[pools == b]).astype(np.float32)
            got = np.sort(nulls[pools == b], axis=0)
            np.testing.assert_array_equal(got, want[:, None].repeat(200, 1))


def test_blocked_diffusion_is_the_reference_diffusion(monkeypatch):
    rng = np.random.default_rng(0)
    n, s, k = 600, 9, 6
    pts = rng.standard_normal((n, 3))
    ids, d = ref_graph.knn(torch.as_tensor(pts), k, Precision("float64"))
    keys, vals = ref_graph.fuzzy_graph(ids, d, n)
    codes = rng.integers(0, s, n)
    want, want_steps = ref_assoc.diffuse(keys, vals, n, codes, s,
                                         Precision("float64"))
    # blocks of 7 cells: the statistics over many blocks
    monkeypatch.setattr(ref_c, "BLOCK", 7 * s)
    seen = []
    got, steps = ref_c.diffuse(keys, vals, n, codes, s, Precision("float64"),
                               watch=lambda step, st, c: seen.append(step))
    assert steps == want_steps == len(seen) >= 3
    torch.testing.assert_close(got, want, rtol=0, atol=1e-15)


def test_answer_on_the_host_is_the_programs_nam(x64):
    import cna_tpu_torch as ct
    from cnabench.kinds import association_cohort as kind_mod

    warnings.filterwarnings("ignore")
    ct.config.set_device("cpu")
    _, cfg, traffic, _ = run.cell_files(BENCH, CELL)
    cfg.update(SMALL)
    kind = kinds.load(traffic["job"])(cfg, traffic, 2**33 + 9, "cpu")
    kind.setup(ct)
    answer = kind.run(0)
    _, res = answer
    # the pull's path: a contiguous float32 tensor behind the lazy field
    nam = kind_mod._device_nam(res)
    assert isinstance(nam, torch.Tensor) and nam.is_contiguous()
    got = kind_mod._on_host(res)
    # job 0 is always judged: kept on the host, pulled from the tensor
    assert 0 in kind.picks
    kind.keep(0, answer)
    kept = kind.kept[0][1]
    assert isinstance(kept, dict) and kind.nam_pulls == ["tensor"]
    np.testing.assert_array_equal(kept["nam"], got["nam"])
    np.testing.assert_array_equal(kept["M"], got["M"])
    # the lazy field reads the same, once
    np.testing.assert_array_equal(got["nam"], res.nam.to_numpy(np.float32))
    assert got["nam"].dtype == np.float32
    np.testing.assert_array_equal(got["kept"], res.kept)


def _run(trace=False):
    warnings.filterwarnings("ignore")
    return run.run_cell(BENCH, CELL, 2**33 + 5, 0.3, trace, device="cpu",
                        config_overrides=SMALL)


def test_small_run_is_correct_and_reads_the_cohort_metrics(x64):
    result, rows, numbers = _run(trace=True)
    assert result["correct"], rows
    for name in ("assoc.gram_svd_s", "assoc.batch_qc_s",
                 "assoc.ridge_step_s"):
        assert result["metrics"][name]["value"] > 0, name
    # a device peak is read on a card only
    assert "assoc.mem_peak_gb" not in result["metrics"]
    assert numbers["qc_flip"] == 0 and numbers["ridge_steps_diff"] == 0


def _qc_skipped(monkeypatch):
    """Every neighbourhood kept, whatever its batch kurtosis."""
    from cna_tpu_torch.tools import _nam

    monkeypatch.setattr(
        _nam, "_qc_nam_arrays",
        lambda arrays, batches, show_progress=False: (
            arrays, np.ones(arrays.nam.shape[1], dtype=bool)))


def _covariates_dropped(monkeypatch):
    """The residualization run on the pools alone."""
    from cna_tpu_torch.tools import _association

    orig = _association._resid_nam
    monkeypatch.setattr(
        _association, "_resid_nam",
        lambda nam, covs, batches, **kw: orig(nam, None, batches, **kw))


@pytest.mark.parametrize("fault", [_qc_skipped, _covariates_dropped],
                         ids=lambda f: f.__name__.strip("_"))
def test_broken_batch_path_is_not_correct(fault, x64, monkeypatch):
    fault(monkeypatch)
    result, rows, _ = _run()
    assert not result["correct"], rows
