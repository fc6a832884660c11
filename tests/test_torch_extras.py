"""The small modules of cna_tpu_torch that hold no kernel: sparse PCA, the
``tl._stats`` namespace, ``ut.obs_to_sample`` and NAM savepoints, against
cna_tpu on the CPU in float64 (the same numpy inputs to both)."""

import importlib

import numpy as np
import pandas as pd
import pytest
import scipy.sparse as sp
import torch

import cna_tpu
import cna_tpu_torch as ct
from cna_tpu.tools import _stats as tpu_stats
from cna_tpu.utils import checkpoint as tpu_ckpt
from cna_tpu_torch.tools import _stats as tstats
from cna_tpu_torch.utils import checkpoint as ckpt

from .torch_parity import sign_align, torch_cpu_x64  # noqa: F401

# ``pp.pca`` the function shadows the module of the same name
tpu_pca = importlib.import_module("cna_tpu.pp.pca")
pca_mod = importlib.import_module("cna_tpu_torch.pp.pca")

RTOL = 1e-8


# ---------------------------------------------------------------------------
# sparse PCA
# ---------------------------------------------------------------------------


def sparse_counts(n=400, g=40, seed=0):
    rng = np.random.RandomState(seed)
    dense = rng.poisson(0.6, size=(n, g)).astype(np.float64)
    dense[:, :5] += rng.poisson(3.0, size=(n, 1))  # a shared program
    return sp.csr_matrix(dense)


@pytest.mark.parametrize("chunk_rows", [65_536, 64])
def test_sparse_pca_matches_tpu_package_and_dense_path(chunk_rows):
    x = sparse_counts()
    want, w_evals, w_comps, w_var = tpu_pca._pca_sparse(x, 10, chunk_rows)
    got, evals, comps, total_var = pca_mod._pca_sparse(x, 10, chunk_rows)
    want = np.asarray(want)
    assert got.shape == (400, 10) and got.dtype == torch.float64
    s = sign_align(want, got.numpy())
    np.testing.assert_allclose(got.numpy() * s, want, rtol=RTOL, atol=1e-10)
    np.testing.assert_allclose(evals, w_evals, rtol=RTOL)
    np.testing.assert_allclose(comps * s, w_comps, rtol=RTOL, atol=1e-10)
    np.testing.assert_allclose(total_var, w_var, rtol=RTOL)
    # and the port's dense path on the densified matrix
    dense, d_evals, _, d_var = pca_mod._pca_device(
        torch.as_tensor(x.toarray()), 10)
    s = sign_align(dense.numpy(), got.numpy())
    np.testing.assert_allclose(got.numpy() * s, dense.numpy(), rtol=RTOL,
                               atol=1e-10)
    np.testing.assert_allclose(evals, d_evals, rtol=RTOL)
    np.testing.assert_allclose(total_var, d_var, rtol=RTOL)


def test_sparse_pca_through_pp_pca_keeps_x_sparse():
    x = sparse_counts(seed=1)
    out = []
    for pkg in (cna_tpu, ct):
        d = pkg.CellData(X=x.copy())
        pkg.pp.pca(d, n_comps=6)
        assert sp.issparse(d.X)
        out.append((np.asarray(d.obsm["X_pca"]), d.uns["pca"]))
    (sa, ua), (sb, ub) = out
    assert sb.shape == (400, 6)
    np.testing.assert_allclose(sb * sign_align(sa, sb), sa, rtol=RTOL,
                               atol=1e-10)
    np.testing.assert_allclose(ub["variance_ratio"], ua["variance_ratio"],
                               rtol=RTOL)
    # the kNN reads the cached device scores of a sparse X too
    d = ct.CellData(X=x.copy())
    ct.pp.pca(d, n_comps=6)
    ct.pp.neighbors(d, n_neighbors=5)
    assert d.obsp["connectivities"].shape == (400, 400)


def test_sparse_pca_refuses_wide_x():
    wide = sp.random(20, pca_mod._SPARSE_PCA_MAX_GENES + 1, density=0.001,
                     format="csr", random_state=0)
    assert pca_mod._SPARSE_PCA_MAX_GENES == tpu_pca._SPARSE_PCA_MAX_GENES
    with pytest.raises(ValueError, match="4096 informative genes"):
        ct.pp.pca(ct.CellData(X=wide), n_comps=5)
    with pytest.raises(ValueError, match="4096 informative genes"):
        cna_tpu.pp.pca(cna_tpu.CellData(X=wide), n_comps=5)


# ---------------------------------------------------------------------------
# tl._stats
# ---------------------------------------------------------------------------


def test_stats_namespace_names_match():
    assert tstats.__all__ == tpu_stats.__all__
    assert ct.tl._stats is tstats
    for name in tstats.__all__:
        assert callable(getattr(tstats, name)), name


def test_stats_helpers_match_tpu_package():
    rng = np.random.default_rng(0)
    z = rng.normal(size=60) * 2
    znull = rng.normal(size=(60, 9))
    n_max_z2 = rng.chisquare(df=1, size=50) * 4
    cases = {
        "tail_counts": (z[:40], znull[:40, :7]),
        "empirical_fdrs": (z, znull, np.linspace(0.1, 2.5, 25)),
        "empirical_fwers": (z[:30], n_max_z2),
        "minfwer_loo": (n_max_z2,),
        "numtests": (n_max_z2 * 2,),
        "numtests_loo": (n_max_z2[:24] * 2,),
    }
    for name, args in cases.items():
        got = ct.ut.fetch(getattr(tstats, name)(*args))
        want = np.asarray(getattr(tpu_stats, name)(*args))
        assert got.shape == want.shape, name
        np.testing.assert_allclose(got, want, rtol=1e-10, err_msg=name)
    # a non-arithmetic threshold grid takes the general path
    thresholds = np.sort(rng.uniform(0.05, 2.5, 25))
    np.testing.assert_allclose(
        ct.ut.fetch(tstats.empirical_fdrs(z, znull, thresholds)),
        np.asarray(tpu_stats.empirical_fdrs(z, znull, thresholds)),
        rtol=1e-10)


def test_conditional_permutation_reference_signature():
    """Reference call shape (B, Y, num) under numpy's global seed: the
    same seed gives the same draw, and every column is a within-batch
    permutation."""
    b = np.repeat(np.arange(4), 10)
    y = np.arange(40.0)
    np.random.seed(0)
    p1 = tstats.conditional_permutation(b, y, 5)
    np.random.seed(0)
    p2 = tstats.conditional_permutation(b, y, 5)
    assert isinstance(p1, torch.Tensor) and p1.dtype == torch.float64
    p1, p2 = p1.numpy(), p2.numpy()
    np.testing.assert_array_equal(p1, p2)
    assert p1.shape == (40, 5)
    assert np.asarray(tpu_stats.conditional_permutation(b, y, 5)).shape \
        == p1.shape
    for col in range(5):
        for batch in range(4):
            rows = b == batch
            np.testing.assert_array_equal(np.sort(p1[rows, col]),
                                          np.sort(y[rows]))
    assert (p1 != y[:, None]).any()
    # an explicit seed or generator is independent of numpy's state
    a1 = tstats.conditional_permutation(b, y, 3, generator=7).numpy()
    np.random.seed(123)
    a2 = tstats.conditional_permutation(b, y, 3, generator=7).numpy()
    gen = torch.Generator()
    gen.manual_seed(7)
    a3 = tstats.conditional_permutation(b, y, 3, generator=gen).numpy()
    np.testing.assert_array_equal(a1, a2)
    np.testing.assert_array_equal(a1, a3)


def test_grouplevel_permutation_reference_signature():
    g = np.repeat(np.arange(6), 3)
    y = np.repeat(np.arange(6.0) * 2, 3)
    out = tstats.grouplevel_permutation(g, y, 4).numpy()
    assert out.shape == (18, 4)
    for col in range(4):
        # constant within donor, the multiset of donor values preserved
        mat = out[:, col].reshape(6, 3)
        assert (mat == mat[:, :1]).all()
        np.testing.assert_array_equal(np.sort(mat[:, 0]), np.arange(6.0) * 2)
    with pytest.raises(ValueError, match="constant within each donor"):
        tstats.grouplevel_permutation(g, np.arange(18.0), 2)
    with pytest.raises(ValueError):
        tpu_stats.grouplevel_permutation(g, np.arange(18.0), 2)


# ---------------------------------------------------------------------------
# ut.obs_to_sample
# ---------------------------------------------------------------------------


def test_obs_to_sample_matches():
    rng = np.random.RandomState(0)
    obs = pd.DataFrame({
        "id": rng.permutation(np.repeat(["c", "a", "b", "d"], 25)),
        "age": rng.rand(100), "score": rng.randn(100)})
    d_a = cna_tpu.CellData(X=np.zeros((100, 2)), obs=obs.copy())
    d_b = ct.CellData(X=np.zeros((100, 2)), obs=obs.copy())
    for cols, agg in ((["age", "score"], "mean"), ("age", "max")):
        want = cna_tpu.ut.obs_to_sample(d_a, cols, "id", aggregate=agg)
        got = ct.ut.obs_to_sample(d_b, cols, "id", aggregate=agg)
        pd.testing.assert_frame_equal(got, want)
    assert list(got.index) == list(pd.unique(obs["id"]))  # first-seen order
    assert got.index.name == "id"


# ---------------------------------------------------------------------------
# NAM savepoints
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def demo():
    rng = np.random.RandomState(0)
    sids = np.repeat([f"s{i:02d}" for i in range(12)], 25)
    case = np.repeat(np.arange(12) >= 6, 25)
    x = rng.randn(300, 8) + 0.8 * case[:, None] * (np.arange(8) < 3)
    d = ct.CellData(X=x, obs=pd.DataFrame(
        {"sample": sids}, index=[f"c{i}" for i in range(300)]))
    ct.pp.pca(d, n_comps=5)
    ct.pp.neighbors(d, n_neighbors=6)
    y = pd.Series((np.arange(12) >= 6).astype(float),
                  index=[f"s{i:02d}" for i in range(12)])
    return d, y


def test_savepoint_written_hit_and_missed(demo, tmp_path, capsys):
    d, y = demo
    path = str(tmp_path / "sub" / "nam.npz")
    kw = dict(Nnull=100, seed=3, return_full=True)
    plain = ct.tl.association(d, y, "sample", **kw)
    first = ct.tl.association(d, y, "sample", nam_savepoint=path, **kw)
    assert (tmp_path / "sub" / "nam.npz").exists()  # written
    fp = ckpt.nam_fingerprint(d, "sample")
    nam_df, keep, nsteps = ckpt.load_nam(path, fp)
    assert keep is None and nsteps >= 3
    assert nam_df.shape == (12, 300) and list(nam_df.index) == list(y.index)

    # hit: the diffusion is not run again
    from cna_tpu_torch.tools import _nam

    def boom(*args, **kwargs):
        raise AssertionError("the NAM was recomputed despite a savepoint")

    real = _nam._nam
    _nam._nam = boom
    try:
        second = ct.tl.association(d, y, "sample", nam_savepoint=path,
                                   show_progress=True, **kw)
    finally:
        _nam._nam = real
    assert "loading NAM from savepoint" in capsys.readouterr().out
    for res in (first, second):
        assert res.p == plain.p and res.k == plain.k
        np.testing.assert_allclose(res.ncorrs, plain.ncorrs, rtol=1e-12)
    arrays, _ = _nam.nam_arrays(d, "sample", nam_savepoint=path)
    assert arrays.nsteps == nsteps

    # miss on a changed fingerprint: another step count, another graph
    assert ckpt.load_nam(path, ckpt.nam_fingerprint(d, "sample",
                                                    nsteps=2)) is None
    arrays2, _ = _nam.nam_arrays(d, "sample", nsteps=2, nam_savepoint=path)
    assert arrays2.nsteps == 2  # recomputed, and the file now holds it
    assert ckpt.load_nam(path, fp) is None
    other = ct.CellData(X=d.X, obs=d.obs.copy())
    other.obsp["connectivities"] = d.obsp["connectivities"] * 0.5
    assert ckpt.nam_fingerprint(other, "sample") != fp
    assert ckpt.load_nam(str(tmp_path / "absent.npz"), fp) is None


def test_savepoint_fingerprint_and_file_match_tpu_package(demo, tmp_path):
    """Same graph, same sample assignment: the same fingerprint, and a
    savepoint written by one package loads in the other."""
    d, _ = demo
    ref = cna_tpu.CellData(X=d.X, obs=d.obs.copy())
    ref.obsp["connectivities"] = d.obsp["connectivities"].copy()
    fp = ckpt.nam_fingerprint(d, "sample", nsteps=3)
    assert fp == tpu_ckpt.nam_fingerprint(ref, "sample", nsteps=3)
    path = str(tmp_path / "nam.npz")
    nam_df, _ = ct.tl.nam(d, "sample", nsteps=3)
    ckpt.save_nam(path, nam_df, fp, nsteps=3)
    loaded, keep, nsteps = tpu_ckpt.load_nam(path, fp)
    pd.testing.assert_frame_equal(loaded, nam_df, check_names=False)
    assert keep is None and nsteps == 3


def test_savepoint_fingerprints_a_device_graph(demo):
    d, _ = demo
    dev = ct.CellData(X=d.X, obs=d.obs.copy())
    dev.obsm["X_pca"] = d.obsm["X_pca"]
    ct.pp.neighbors(dev, n_neighbors=6, method="ivf")
    conn = dev.obsp["connectivities"]
    fp = ckpt.nam_fingerprint(dev, "sample")
    assert fp == ckpt.nam_fingerprint(dev, "sample") and conn._csr is None
    assert fp != ckpt.nam_fingerprint(dev, "sample", self_weight=2)
