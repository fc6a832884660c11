"""cna_tpu_torch's graph layer against cna_tpu's: synthetic data, PCA,
fuzzy connectivities, ELL / bucketed packing and the diffusion step."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import cna_tpu
import cna_tpu_torch as ct
from cna_tpu.graph import buckets as tpu_buckets
from cna_tpu.graph import ell as tpu_ell
from cna_tpu.graph.reorder import permute_graph as tpu_permute
from cna_tpu.ops import spmm as tpu_spmm
from cna_tpu.pp.knn import knn_search as tpu_knn_search
from cna_tpu_torch.graph import buckets, ell
from cna_tpu_torch.graph.reorder import permute_graph
from cna_tpu_torch.ops import spmm
from cna_tpu_torch.utils import graph_from_numpy

from .torch_parity import (brute_knn, dyadic, sign_align,  # noqa: F401
                           torch_cpu_x64)

# the pp packages re-export a function named ``neighbors``, which hides
# the module of the same name
tpu_nb = importlib.import_module("cna_tpu.pp.neighbors")
nb = importlib.import_module("cna_tpu_torch.pp.neighbors")

# float64 on both sides, same formulas, different libraries: weights of
# the fuzzy graph at rtol 1e-10; one diffusion step (a sum of <= K
# positive terms) at rtol 1e-12
FUZZY_RTOL = 1e-10
STEP_RTOL = 1e-12


@pytest.fixture(scope="module")
def knn_lists():
    x = np.random.RandomState(2).randn(400, 6)
    idx, d2 = brute_knn(x, 10)
    return idx.astype(np.int32), np.sqrt(d2)


@pytest.fixture(scope="module")
def hub_graph():
    """Symmetric random graph with a few hub rows, so the ELL pack spills
    into the COO overflow."""
    rng = np.random.RandomState(5)
    n = 300
    a = sp.random(n, n, density=0.02, random_state=rng, format="csr")
    hubs = sp.random(3, n, density=0.9, random_state=rng, format="csr")
    a = sp.vstack([hubs, a[3:]]).tocsr()
    a = (a + a.T).tocsr()
    a.sum_duplicates()
    a.sort_indices()
    return a


@pytest.mark.parametrize("structure", ["archetypes", "manifold"])
def test_synthetic_dataset_equal(structure):
    kw = dict(n_samples=8, cells_per_sample=30, n_genes=12, seed=3,
              structure=structure)
    a, sa = cna_tpu.data.synthetic_dataset(**kw)
    b, sb = ct.data.synthetic_dataset(**kw)
    assert np.array_equal(a.X, b.X) and a.X.dtype == b.X.dtype
    assert a.obs.equals(b.obs) and a.var.equals(b.var)
    assert sa.equals(sb)


def test_pca_matches_up_to_sign():
    x = np.random.RandomState(6).randn(300, 15)
    obs = None
    da, db = cna_tpu.CellData(X=x, obs=obs), ct.CellData(X=x, obs=obs)
    sa = np.asarray(cna_tpu.pp.pca(da, n_comps=8))
    sb = ct.pp.pca(db, n_comps=8)
    s = sign_align(sa, sb)
    np.testing.assert_allclose(sb * s, sa, rtol=1e-9, atol=1e-11)
    np.testing.assert_allclose(db.uns["pca"]["variance"],
                               da.uns["pca"]["variance"], rtol=1e-12)
    np.testing.assert_allclose(db.uns["pca"]["variance_ratio"],
                               da.uns["pca"]["variance_ratio"], rtol=1e-12)
    np.testing.assert_allclose(db.uns["pca"]["components"] * s,
                               da.uns["pca"]["components"], atol=1e-11)


def test_smooth_knn_dist_and_strengths(knn_lists):
    idx, d = knn_lists
    target = np.log2(10.0)
    rho_a, sig_a = tpu_nb.smooth_knn_dist(jnp.asarray(d),
                                          jnp.log2(jnp.asarray(10.0)))
    rho_b, sig_b = nb.smooth_knn_dist(torch.as_tensor(d), target)
    np.testing.assert_allclose(rho_b.numpy(), np.asarray(rho_a),
                               rtol=FUZZY_RTOL)
    np.testing.assert_allclose(sig_b.numpy(), np.asarray(sig_a),
                               rtol=FUZZY_RTOL)
    for ids in (None, idx):
        wa = tpu_nb.membership_strengths(
            jnp.asarray(d), rho_a, sig_a,
            None if ids is None else jnp.asarray(ids))
        wb = nb.membership_strengths(
            torch.as_tensor(d), rho_b, sig_b,
            None if ids is None else torch.as_tensor(ids))
        np.testing.assert_allclose(wb.numpy(), np.asarray(wa),
                                   rtol=FUZZY_RTOL)


def test_fuzzy_connectivities_same_csr(knn_lists):
    idx, d = knn_lists
    ca = tpu_nb.fuzzy_connectivities(idx, d)
    cb = nb.fuzzy_connectivities(idx, d)
    assert np.array_equal(ca.indptr, cb.indptr)
    assert np.array_equal(ca.indices, cb.indices)
    np.testing.assert_allclose(cb.data, ca.data, rtol=FUZZY_RTOL)
    assert abs(cb - cb.T).max() == 0  # float-exact symmetric


def test_neighbors_same_graph():
    rep = dyadic(np.random.RandomState(7).randn(500, 8))
    out = []
    for pkg in (cna_tpu, ct):
        d = pkg.CellData(X=np.zeros((500, 1)))
        d.obsm["X_rep"] = rep
        pkg.pp.neighbors(d, n_neighbors=12, use_rep="X_rep")
        out.append(d)
    a, b = out
    for key in ("distances", "connectivities"):
        assert np.array_equal(a.obsp[key].indices, b.obsp[key].indices)
        assert np.array_equal(a.obsp[key].indptr, b.obsp[key].indptr)
        np.testing.assert_allclose(b.obsp[key].data, a.obsp[key].data,
                                   rtol=FUZZY_RTOL)
    assert b.uns["neighbors"] == a.uns["neighbors"]


def test_neighbors_raw_pca_scores():
    """On raw PCA scores the two graphs differ by the self distance only.

    The port's exact search sets it to 0; cna_tpu keeps the expansion's
    rounding noise, which becomes rho of the fuzzy kernel on the rows
    where it rounds positive.  So the port's graph must equal the one
    cna_tpu builds from its own kNN lists with the self column zeroed,
    and cna_tpu's own graph on every entry whose two ends both kept an
    exactly-0 self distance there."""
    x = np.random.RandomState(12).randn(500, 30)
    ref = cna_tpu.CellData(X=x)
    cna_tpu.pp.pca(ref, n_comps=10)
    rep = np.asarray(ref.obsm["X_pca"])
    out = []
    for pkg in (cna_tpu, ct):
        d = pkg.CellData(X=np.zeros((500, 1)))
        d.obsm["X_rep"] = rep
        pkg.pp.neighbors(d, n_neighbors=12, use_rep="X_rep")
        out.append(d)
    a, b = out

    # cna_tpu.pp.neighbors runs exactly this search on the CPU
    ti, td = tpu_knn_search(rep, 12, method="exact")
    shifted = td[:, 0] > 0
    assert 0 < shifted.sum() < len(shifted)  # the deviation is exercised

    # the kNN lists: same ids, real distances at FUZZY_RTOL
    da, db = a.obsp["distances"], b.obsp["distances"]
    assert np.array_equal(da.indptr, db.indptr)
    assert np.array_equal(da.indices, db.indices)
    np.testing.assert_allclose(db.data, da.data, rtol=FUZZY_RTOL)

    td0 = td.copy()
    td0[:, 0] = 0.0
    expect = tpu_nb.fuzzy_connectivities(ti, td0)
    cb = b.obsp["connectivities"]
    assert np.array_equal(cb.indptr, expect.indptr)
    assert np.array_equal(cb.indices, expect.indices)
    np.testing.assert_allclose(cb.data, expect.data, rtol=FUZZY_RTOL)

    ca = a.obsp["connectivities"].tocoo()
    cb = cb.tocsr()
    same = ~shifted[ca.row] & ~shifted[ca.col]
    assert same.mean() > 0.5
    np.testing.assert_allclose(
        np.asarray(cb[ca.row[same], ca.col[same]]).ravel(), ca.data[same],
        rtol=FUZZY_RTOL)
    # and where a row's rho did shift, its weights really differ
    assert not np.allclose(
        np.asarray(cb[ca.row[~same], ca.col[~same]]).ravel(),
        ca.data[~same], rtol=1e-6)


def test_from_scipy_array_for_array(hub_graph):
    ga = tpu_ell.from_scipy(hub_graph)
    gb = ell.from_scipy(hub_graph)
    assert ga.n_overflow > 0  # the hub rows spill
    for f in ("indices", "weights", "overflow_rows", "overflow_cols",
              "overflow_weights", "colsums_raw"):
        va, vb = np.asarray(getattr(ga, f)), getattr(gb, f).numpy()
        assert va.dtype == vb.dtype, f
        assert np.array_equal(va, vb), f


def test_from_scipy_buckets_array_for_array(hub_graph):
    oa = tpu_buckets.degree_ordering(hub_graph)
    ob = buckets.degree_ordering(hub_graph)
    assert np.array_equal(oa.perm, ob.perm)
    assert np.array_equal(oa.inv, ob.inv)
    ga = tpu_buckets.from_scipy_buckets(tpu_permute(hub_graph, oa))
    gb = buckets.from_scipy_buckets(permute_graph(hub_graph, ob))
    assert len(ga.indices) == len(gb.indices) > 1
    for ia, ib, wa, wb in zip(ga.indices, gb.indices, ga.weights,
                              gb.weights):
        assert np.array_equal(np.asarray(ia), ib.numpy())
        assert np.array_equal(np.asarray(wa), wb.numpy())
    assert np.array_equal(np.asarray(ga.colsums_raw), gb.colsums_raw.numpy())
    assert gb.padded_area() == ga.padded_area()
    degrees = np.sort(np.diff(hub_graph.indptr))
    assert (buckets.plan_buckets(degrees)
            == tpu_buckets.plan_buckets(degrees))


@pytest.mark.parametrize("fmt,block_rows", [("ell", None), ("ell", 64),
                                            ("bucketed", None)])
def test_diffusion_step_matches(hub_graph, fmt, block_rows):
    s = np.random.RandomState(8).rand(hub_graph.shape[0], 5)
    if fmt == "ell":
        ga, gb = tpu_ell.from_scipy(hub_graph), ell.from_scipy(hub_graph)
    else:
        order = buckets.degree_ordering(hub_graph)
        g = permute_graph(hub_graph, order)
        ga = tpu_buckets.from_scipy_buckets(g)
        gb = buckets.from_scipy_buckets(g)
        s = s[order.perm]
    ya = tpu_spmm.diffusion_step(jnp.asarray(s), ga, ga.colsums(1.0), 1.0,
                                 block_rows=block_rows)
    yb = spmm.diffusion_step(torch.as_tensor(s), gb, gb.colsums(1.0), 1.0,
                             block_rows=block_rows)
    np.testing.assert_allclose(yb.numpy(), np.asarray(ya), rtol=STEP_RTOL)


@pytest.mark.parametrize("fmt", ["ell", "bucketed"])
def test_graph_from_numpy_diffuses_the_same_packed_graph(hub_graph, fmt):
    if fmt == "ell":
        ga = tpu_ell.from_scipy(hub_graph)
        gb = graph_from_numpy(
            np.asarray(ga.indices), np.asarray(ga.weights),
            np.asarray(ga.colsums_raw), np.asarray(ga.overflow_rows),
            np.asarray(ga.overflow_cols), np.asarray(ga.overflow_weights))
        assert isinstance(gb, ell.EllGraph) and gb.n_overflow > 0
    else:
        g = tpu_permute(hub_graph, tpu_buckets.degree_ordering(hub_graph))
        ga = tpu_buckets.from_scipy_buckets(g)
        gb = graph_from_numpy([np.asarray(i) for i in ga.indices],
                              [np.asarray(w) for w in ga.weights],
                              np.asarray(ga.colsums_raw))
        assert isinstance(gb, buckets.BucketEllGraph)
    s = np.random.RandomState(9).rand(hub_graph.shape[0], 4)
    ya = tpu_spmm.diffusion_step(jnp.asarray(s), ga, ga.colsums(1.0), 1.0)
    yb = spmm.diffusion_step(torch.as_tensor(s), gb, gb.colsums(1.0), 1.0)
    np.testing.assert_allclose(yb.numpy(), np.asarray(ya), rtol=STEP_RTOL)


def test_bucketed_graph_rejects_overflow():
    with pytest.raises(ValueError, match="no COO overflow"):
        graph_from_numpy([np.zeros((2, 8), np.int32)], [np.zeros((2, 8))],
                         np.zeros(2), overflow_rows=np.zeros(1, np.int32))
