"""``bench_torch.py``, the port's benchmark driver, against ``bench.py``:
its output line, its data, its association and its imports (CPU)."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pandas as pd
import pytest

import cna_tpu
import cna_tpu_torch as ct

from .torch_parity import dyadic, torch_cpu_x64  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import bench  # noqa: E402
import bench_torch  # noqa: E402

# float64 end to end on one graph (tests/test_torch_association.py)
RTOL = 1e-8
SMALL = {"CNA_BENCH_CELLS": "3000", "CNA_BENCH_SAMPLES": "20",
         "CNA_BENCH_NNULL": "100"}


def _bench(*args, **env):
    return subprocess.run(
        [sys.executable, str(ROOT / "bench_torch.py"), *args],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env=dict(os.environ, **SMALL, **env))


def test_bench_torch_cpu_prints_one_json_line():
    r = _bench("--cpu")
    assert r.returncode == 0, r.stderr[-2000:]
    lines = r.stdout.strip().splitlines()
    assert len(lines) == 1, r.stdout
    rec = json.loads(lines[0])
    assert set(rec) == {"metric", "value", "unit", "vs_baseline", "extras"}
    assert rec["metric"] == "association_e2e_3k_cells_100perm"
    assert rec["unit"] == "s" and rec["value"] > 0
    assert rec["vs_baseline"] is None
    ex = rec["extras"]
    assert ex["ref"] is None
    assert ex["knn_method_resolved"] == "exact"
    for key in ("graph_build_cold_s", "graph_build_warm_s",
                "graph_build_warm_first_s", "assoc_cold_s", "e2e_warm_s"):
        assert ex[key] > 0, key
    assert {"pca_compute", "knn", "fuzzy_graph"} <= set(
        ex["graph_warm_phases_s"])
    assert {"nam", "residualize", "test"} <= set(ex["assoc_warm_phases_s"])
    # no kernel launches on the CPU (the wrappers take the plain versions)
    assert set(ex["kernel_launches"]) == {
        "graph_cold", "graph_warm_first", "graph_warm", "assoc_cold",
        "assoc_warm"}
    assert not any(ex["kernel_launches"].values())
    assert ex["kernel_build_s"] == 0 and ex["peak_device_gb"] is None
    assert ex["device"] == {"name": "cpu", "nvidia_smi": None}
    assert all(0 < p <= 1 for p in ex["p"]) and min(ex["k"]) >= 1
    assert (ex["cells"], ex["samples"], ex["nnull"]) == (3000, 20, 100)


def test_bench_torch_without_cpu_needs_the_card():
    """Without ``--cpu`` the bench computes on the card and stops where
    there is none; it prints no result."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the bench runs on it")
    r = _bench()
    assert r.returncode != 0
    assert "set_device('cpu')" in r.stderr
    assert r.stdout.strip() == ""


@pytest.mark.parametrize("n_cells,n_samples,seed", [(3000, 20, 0),
                                                    (2000, 50, 2)])
def test_make_data_equals_bench_py(n_cells, n_samples, seed):
    d, samplem = bench_torch.make_data(n_cells, n_samples, seed)
    d_ref, samplem_ref = bench._make_data(n_cells, n_samples, seed)
    np.testing.assert_array_equal(np.asarray(d.X), np.asarray(d_ref.X))
    assert np.asarray(d.X).dtype == np.asarray(d_ref.X).dtype
    pd.testing.assert_frame_equal(d.obs, d_ref.obs)
    pd.testing.assert_frame_equal(samplem, samplem_ref)


def _graph(pkg, d):
    d.X = np.asarray(d.X, dtype=np.float64)
    pkg.pp.pca(d, n_comps=20)
    d.obsm["X_dyadic"] = dyadic(d.obsm["X_pca"])
    pkg.pp.neighbors(d, n_neighbors=15, use_rep="X_dyadic")
    return d


def test_bench_association_equals_tpu_package():
    """The bench's association on bench.py's data against the TPU
    package's on the same graph (dyadic PCA scores, so that both kNN
    searches are exact) with the same null phenotypes."""
    nnull = 100
    d, samplem = bench_torch.make_data(3000, 20)
    d_ref, _ = bench._make_data(3000, 20)
    d, d_ref = _graph(ct, d), _graph(cna_tpu, d_ref)
    y = samplem["case"].astype(float)
    ys = ((y - y.mean()) / y.std(ddof=0)).to_numpy()
    rng = np.random.RandomState(5)
    null_y = np.stack([ys[rng.permutation(len(ys))] for _ in range(nnull)],
                      axis=1)
    seconds, res = bench_torch.run_association(d, y, nnull, seed=1,
                                               null_y=null_y)
    ref = cna_tpu.tl.association(d_ref, y, "id", Nnull=nnull, null_y=null_y,
                                 return_full=True)
    assert seconds > 0
    assert res.p == ref.p and res.k == ref.k
    np.testing.assert_allclose(res.ncorrs, ref.ncorrs, rtol=RTOL)
    # the threshold grid is np.arange(m / 4, m, m / 400) of m = max|ncorrs|:
    # an ulp of m can add or drop its last point, so the two curves are
    # held on the points both have
    n = min(len(res.fdrs), len(ref.fdrs))
    assert abs(len(res.fdrs) - len(ref.fdrs)) <= 1
    np.testing.assert_allclose(res.fdrs.threshold[:n], ref.fdrs.threshold[:n],
                               rtol=RTOL)
    np.testing.assert_allclose(res.fdrs.fdr[:n], ref.fdrs.fdr[:n], rtol=RTOL)


def test_build_graph_records_its_phases():
    d, _ = bench_torch.make_data(1000, 10)
    phases = {}
    seconds = bench_torch.build_graph(d, phases_out=phases)
    assert seconds > 0
    assert {"pca_compute", "knn", "fuzzy_graph"} <= set(phases)
    assert d.obsp["connectivities"].shape == (1000, 1000)
    # the profiler is off again after the build
    from cna_tpu_torch.utils import profiling

    assert not profiling.global_profiler().enabled


def test_import_bench_torch_pulls_in_neither_jax_nor_cna_tpu():
    code = ("import sys, bench_torch; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'cna_tpu')]; print(bad); sys.exit(1 if bad else 0)")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
