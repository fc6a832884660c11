"""cna_tpu_torch's file, gene and config layers against cna_tpu on the CPU:
h5ad both ways, HVG selection, the precision switch and the NaN checks."""

import dataclasses

import numpy as np
import pandas as pd
import pytest
import scipy.sparse as sp
import torch

import cna_tpu
import cna_tpu_torch as ct
from cna_tpu_torch import config
from cna_tpu_torch.utils import checks, profiling

from .torch_parity import torch_cpu_x64  # noqa: F401


def _cell_data(pkg, sparse):
    """A CellData of ``pkg`` with every kind of field the h5ad layer
    carries: X dense or CSR; obs / var with numeric, bool, string and
    categorical columns; obsm; obsp; nested uns; samplem."""
    rng = np.random.RandomState(0)
    n, g = 40, 7
    x = rng.poisson(1.0, (n, g)).astype(np.float32)
    obs = pd.DataFrame({
        "id": np.repeat([f"s{i}" for i in range(8)], 5),
        "score": rng.randn(n),
        "count": rng.randint(0, 9, n),
        "flag": rng.rand(n) > 0.5,
        "grp": pd.Categorical(rng.choice(["a", "b", "c"], n)),
    }, index=[f"cell{i}" for i in range(n)])
    var = pd.DataFrame({"symbol": [f"G{i}" for i in range(g)],
                        "hv": np.arange(g) % 2 == 0},
                       index=[f"gene{i}" for i in range(g)])
    conn = sp.random(n, n, density=0.1, format="csr", random_state=1)
    samplem = pd.DataFrame({"case": np.arange(8) % 2,
                            "age": rng.rand(8)},
                           index=pd.Index([f"s{i}" for i in range(8)],
                                          name="id"))
    return pkg.CellData(
        X=sp.csr_matrix(x) if sparse else x, obs=obs, var=var,
        obsm={"X_pca": rng.randn(n, 3), "X_umap": rng.randn(n, 2)
              .astype(np.float32)},
        obsp={"connectivities": conn + conn.T},
        uns={"neighbors": {"params": {"n_neighbors": 15, "method": "umap"},
                           "note": "kNN"},
             "pca": {"variance": rng.rand(3)}, "n": 3, "ratio": 0.5,
             "_cna_tpu_torch_cache": object()},
        samplem=samplem, sid_name="id")


def _assert_same(a, b):
    xa, xb = a.X, b.X
    assert sp.issparse(xa) == sp.issparse(xb)
    if sp.issparse(xa):
        assert xa.format == xb.format == "csr"
        xa, xb = xa.toarray(), xb.toarray()
    np.testing.assert_array_equal(xa, xb)
    for fa, fb in ((a.obs, b.obs), (a.var, b.var)):
        assert list(fa.columns) == list(fb.columns)
        np.testing.assert_array_equal(fa.index.to_numpy().astype(str),
                                      fb.index.to_numpy().astype(str))
        for col in fa.columns:
            np.testing.assert_array_equal(np.asarray(fa[col]),
                                          np.asarray(fb[col]))
            assert isinstance(fa[col].dtype, pd.CategoricalDtype) \
                == isinstance(fb[col].dtype, pd.CategoricalDtype)
    assert sorted(a.obsm) == sorted(b.obsm)
    for k in a.obsm:
        np.testing.assert_array_equal(a.obsm[k], b.obsm[k])
        assert a.obsm[k].dtype == b.obsm[k].dtype
    assert sorted(a.obsp) == sorted(b.obsp)
    for k in a.obsp:
        assert abs(a.obsp[k] - b.obsp[k]).max() == 0
    assert a.uns["neighbors"]["params"] == b.uns["neighbors"]["params"]
    assert a.uns["neighbors"]["note"] == b.uns["neighbors"]["note"] == "kNN"
    np.testing.assert_array_equal(a.uns["pca"]["variance"],
                                  b.uns["pca"]["variance"])
    assert a.uns["n"] == b.uns["n"] == 3 and a.uns["ratio"] == 0.5
    assert not any(k.startswith("_") for k in b.uns)
    assert a.sid_name == b.sid_name == "id"
    pd.testing.assert_frame_equal(a.samplem, b.samplem)


@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "csr"])
@pytest.mark.parametrize("writer", ["tpu", "port"])
def test_h5ad_round_trip_between_the_packages(tmp_path, sparse, writer):
    """A file written by one package reads back equal in the other (and
    in itself)."""
    src = _cell_data(cna_tpu if writer == "tpu" else ct, sparse)
    path = tmp_path / "x.h5ad"
    if writer == "tpu":
        cna_tpu.data.write_h5ad(src, path)
    else:
        src.write(path)
    by_port = ct.read_h5ad(path)
    by_tpu = cna_tpu.read_h5ad(path)
    assert isinstance(by_port, ct.CellData)
    _assert_same(by_tpu, by_port)
    _assert_same(by_port, ct.data.read_h5ad(path))


def test_device_graph_written_as_its_csr(tmp_path):
    """The IVF branch stores lazy device faces in obsp; the file holds the
    scipy matrices their ``tocsr()`` gives, and the private device caches
    of ``uns`` stay out of it."""
    d, samplem = ct.data.synthetic_dataset(n_samples=12, cells_per_sample=40,
                                           n_genes=15, seed=3,
                                           dtype=np.float64)
    ct.pp.pca(d, n_comps=8)
    ct.pp.neighbors(d, n_neighbors=8, method="ivf")
    assert type(d.obsp["connectivities"]).__name__ == "DeviceConnectivities"
    assert type(d.obsp["distances"]).__name__ == "LazyDistances"
    assert any(k.startswith("_cna_tpu_torch") for k in d.uns)
    path = tmp_path / "graph.h5ad"
    ct.data.write_h5ad(d, path)
    back = ct.read_h5ad(path)
    for key in ("connectivities", "distances"):
        want = d.obsp[key].tocsr()
        got = back.obsp[key]
        assert sp.isspmatrix_csr(got)
        np.testing.assert_array_equal(got.indptr, want.indptr)
        np.testing.assert_array_equal(got.indices, want.indices)
        np.testing.assert_array_equal(got.data, want.data)
    assert not any(k.startswith("_") for k in back.uns)
    assert back.uns["neighbors"]["params"]["knn_method_resolved"] == "ivf"
    # the file is a graph the TPU package can test on
    p_port = ct.tl.association(back, samplem["case"].astype(float), "id",
                               Nnull=50, seed=0)
    assert 0 < p_port <= 1


@pytest.mark.parametrize("subset", [True, False])
@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "csr"])
def test_select_hvg_keeps_the_tpu_packages_genes(sparse, subset):
    rng = np.random.RandomState(4)
    n, g = 300, 400
    means = rng.lognormal(-1.0, 1.2, g)
    x = rng.poisson(means, (n, g)).astype(np.float64)
    x[:, :12] *= rng.gamma(0.5, 2.0, (n, 1))  # overdispersed genes
    x[:, 20] = 0.0  # an all-zero gene
    xs = sp.csr_matrix(x) if sparse else x
    var = pd.DataFrame(index=[f"g{i}" for i in range(g)])
    ref = cna_tpu.CellData(X=xs.copy(), var=var.copy())
    ours = ct.CellData(X=xs.copy(), var=var.copy())
    keep_ref = cna_tpu.pp.select_hvg(ref, n_top=50, subset=subset)
    keep = ct.pp.select_hvg(ours, n_top=50, subset=subset)
    np.testing.assert_array_equal(keep, keep_ref)
    assert keep[:12].all() and keep.sum() == 50
    np.testing.assert_array_equal(ours.var["highly_variable"].to_numpy(),
                                  ref.var["highly_variable"].to_numpy())
    assert list(ours.var.index) == list(ref.var.index)
    assert sp.issparse(ours.X) == sparse
    got = ours.X.toarray() if sparse else ours.X
    want = ref.X.toarray() if sparse else ref.X
    np.testing.assert_array_equal(got, want)


def test_select_hvg_feeds_sparse_pca_past_its_gene_limit():
    """A sparse X of more genes than sparse PCA takes reaches it after
    the selection."""
    rng = np.random.RandomState(5)
    x = sp.random(200, 5000, density=0.01, format="csr", random_state=5,
                  data_rvs=lambda k: rng.poisson(3.0, k) + 1.0)
    d = ct.CellData(X=x)
    with pytest.raises(ValueError, match="highly variable"):
        ct.pp.pca(ct.CellData(X=x), n_comps=5)
    ct.pp.select_hvg(d, n_top=500)
    assert d.X.shape == (200, 500) and sp.issparse(d.X)
    scores = ct.pp.pca(d, n_comps=5)
    assert scores.shape == (200, 5) and np.isfinite(scores).all()


def test_precision_restores_the_mode_on_exit_and_on_error():
    assert config.current_precision() == config.Precision(x64=True)
    assert config.Precision(x64=False).float == torch.float32
    with config.precision(False) as prec:
        assert prec.float == torch.float32 and not config.x64_enabled()
        assert config.spmm_dtype() == torch.float32
    assert config.x64_enabled() and config.spmm_dtype() == torch.float64
    with pytest.raises(RuntimeError, match="inside"):
        with config.precision(False):
            raise RuntimeError("inside")
    assert config.x64_enabled()
    with pytest.raises(dataclasses.FrozenInstanceError):
        config.current_precision().x64 = False


def test_tunnel_helpers_are_documented_no_ops(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    config.enable_compilation_cache(str(tmp_path / "cache"))
    assert not (tmp_path / "cache").exists()
    t = config.warmup_transfers_async()
    t.join(timeout=10)
    assert not t.is_alive()


def test_debug_nans_name_the_op_and_the_phase():
    prof = profiling.global_profiler()
    config.enable_debug_nans(True)
    try:
        torch.log(torch.tensor([1.0, 2.0]))  # finite: passes
        with pytest.raises(FloatingPointError,
                           match=r"aten\.log.*NaN.*phase 'prep' "
                                 r"\(outer > prep\)"):
            with prof.phase("outer"), prof.phase("prep"):
                torch.log(torch.tensor([-1.0]))
        # a NaN passed on from an input, or written on purpose, is not made
        nan = torch.full((2,), torch.nan)
        nan + 1.0
        with pytest.raises(FloatingPointError, match="Inf"):
            torch.tensor([1.0]) / torch.tensor([0.0])
    finally:
        config.enable_debug_nans(False)
    torch.log(torch.tensor([-1.0]))  # off again
    assert profiling.open_phases() == ()


def test_debug_nans_name_a_pipeline_phase():
    x = np.random.RandomState(0).randn(60, 5)
    x[:, 2] *= 1e160  # finite, but the covariance overflows
    d = ct.CellData(X=x)
    config.enable_debug_nans(True)
    try:
        with pytest.raises(FloatingPointError,
                           match="Inf from finite inputs in phase "
                                 "'pca_compute'"):
            ct.pp.pca(d, n_comps=3)
    finally:
        config.enable_debug_nans(False)


def _demo():
    d, samplem = ct.data.synthetic_dataset(n_samples=12, cells_per_sample=30,
                                           n_genes=10, seed=1,
                                           dtype=np.float64)
    ct.pp.pca(d, n_comps=6)
    ct.pp.neighbors(d, n_neighbors=6)
    return d, samplem["case"].astype(float)


def test_checkify_float_checks_trips_inside_and_passes_association():
    def bad(x):
        return torch.sqrt(x - 2.0)  # NaN for x = 1

    checked = checks.checkify_float_checks(bad)
    with pytest.raises(FloatingPointError, match=r"aten\.sqrt"):
        checked(torch.tensor([1.0]))
    assert checked(torch.tensor([6.0])).item() == 2.0

    d, y = _demo()
    p_plain = ct.tl.association(d, y, "id", Nnull=100, seed=3)
    p = checks.checkify_float_checks(ct.tl.association)(d, y, "id",
                                                       Nnull=100, seed=3)
    assert p == p_plain and 0 < p <= 1


def test_kernel_outputs_checked_only_under_a_mode():
    out = torch.tensor([-torch.inf, 1.0])  # -inf: a missing neighbour
    checks.kernel_outputs("knn_exact", out, torch.tensor([torch.nan]))
    with checks.FloatChecks():
        checks.kernel_outputs("knn_exact", out)
        with pytest.raises(FloatingPointError, match="'knn_exact'"):
            checks.kernel_outputs("knn_exact", out,
                                  torch.tensor([torch.nan]))
