"""cna_tpu_torch's device-resident graph path (``graph.device``,
``ops.spmm.sorted_ext_spmm``, the device branch of ``pp.neighbors``, the
streamed PCA) against cna_tpu's, and the atlas slice as a whole on the CPU.

Both packages build the graph from the same kNN lists in float64, so the
matrices are compared exactly or at 1e-12 where sums are reordered.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import scipy.sparse as sp
import torch

import cna_tpu
import cna_tpu_torch as ct
from cna_tpu.graph import device as tpu_device
from cna_tpu.graph.reorder import Reordering as TpuReordering
from cna_tpu.ops import spmm as tpu_spmm
from cna_tpu_torch.graph import device
from cna_tpu_torch.graph.ell import EllGraph
from cna_tpu_torch.graph.reorder import Reordering
from cna_tpu_torch.ops import spmm
from cna_tpu_torch.pp.ivf import ivf_knn, measured_recall
from cna_tpu_torch.utils import (graph_from_numpy,
                                 sorted_ext_graph_from_numpy)

from .torch_parity import brute_knn, sign_align, torch_cpu_x64  # noqa: F401

# the pp packages re-export functions named ``neighbors`` and ``pca``,
# which hide the modules of the same names
tpu_nb = importlib.import_module("cna_tpu.pp.neighbors")
nb = importlib.import_module("cna_tpu_torch.pp.neighbors")
tpu_pca = importlib.import_module("cna_tpu.pp.pca")
pca_mod = importlib.import_module("cna_tpu_torch.pp.pca")

# float64 on both sides, same formulas, different libraries (the tolerances
# of tests/test_torch_graph.py): fuzzy weights at rtol 1e-10; a diffusion
# step, whose sums the two formats order differently, at 1e-12
FUZZY_RTOL = 1e-10
STEP_TOL = 1e-12


def _hubby_points(n=2400, seed=0):
    """A dense core inside a diffuse cloud: asymmetric kNN (mirror edges)
    and hub rows (COO spill), as in tests/test_device_graph.py."""
    rng = np.random.RandomState(seed)
    return np.concatenate([
        rng.randn(n - n // 6, 10), rng.randn(n // 6, 10) * 0.05])


def _union(x, k):
    """kNN lists (numpy brute force, float64) and cna_tpu's fuzzy-union
    edge weights and codes for them: the inputs both ``build_sym_ell``
    are given."""
    idx, d2 = brute_knn(x, k)
    idx, dists = idx.astype(np.int32), np.sqrt(d2)
    d_dev = jnp.asarray(dists)
    rho, sigma = tpu_nb.smooth_knn_dist(d_dev, jnp.log2(jnp.asarray(float(k))))
    w = tpu_nb.membership_strengths(d_dev, rho, sigma, jnp.asarray(idx))
    w_sym, code = tpu_nb.fuzzy_union_device(jnp.asarray(idx), w)
    return idx, dists, np.asarray(w_sym), np.asarray(code)


def _both(idx, w_sym, code, **kw):
    ref = tpu_device.build_sym_ell(jnp.asarray(idx), jnp.asarray(w_sym),
                                   jnp.asarray(code), **kw)
    got = device.build_sym_ell(torch.from_numpy(idx), torch.from_numpy(w_sym),
                               torch.from_numpy(code), **kw)
    return ref, got


def _csr_pair(ref, got, n, perm=None):
    if perm is None:
        ro = go = None
    else:
        inv = np.empty_like(perm)
        inv[perm] = np.arange(n, dtype=perm.dtype)
        ro, go = TpuReordering(perm=perm, inv=inv), Reordering(perm=perm,
                                                               inv=inv)
    return (tpu_device.DeviceConnectivities(ref, ro, n).tocsr(),
            device.DeviceConnectivities(got, go, n).tocsr())


def _same_csr(a, b):
    return (np.array_equal(a.indptr, b.indptr)
            and np.array_equal(a.indices, b.indices)
            and np.array_equal(a.data, b.data))


@pytest.fixture(scope="module")
def hubby():
    x = _hubby_points()
    return (x,) + _union(x, 15)


def test_sym_ell_equal_to_tpu_package_and_host_csr(hubby):
    x, idx, dists, w_sym, code = hubby
    n = len(x)
    # both packages choose the same representation; the hub-skewed graph
    # gets bucketed mirror columns unless a wide ELL is allowed
    ref, got = _both(idx, w_sym, code)
    assert type(got).__name__ == type(ref).__name__ == "SortedExtGraph"
    ref, got = _both(idx, w_sym, code, ell_max_kx=128)
    assert isinstance(got, EllGraph) and got.dtype == torch.float64
    assert got.max_degree == ref.max_degree > idx.shape[1]
    assert got.n_overflow > 0  # the dense core spills into the COO tail
    a, b = _csr_pair(ref, got, n)
    assert _same_csr(a, b)  # exactly cna_tpu's matrix
    host = nb.fuzzy_connectivities(idx, dists)
    assert np.array_equal(host.indptr, b.indptr)
    assert np.array_equal(host.indices, b.indices)
    np.testing.assert_allclose(b.data, host.data, rtol=FUZZY_RTOL)
    assert abs(b - b.T).max() == 0  # float-exact symmetric
    # the ELL columns themselves, and the column sums
    assert np.array_equal(got.indices.numpy(), np.asarray(ref.indices))
    assert np.array_equal(got.weights.numpy(), np.asarray(ref.weights))
    np.testing.assert_allclose(got.colsums_raw.numpy(),
                               np.asarray(ref.colsums_raw), rtol=STEP_TOL)
    np.testing.assert_allclose(got.colsums_raw.numpy(),
                               np.asarray(b.sum(axis=0)).ravel(),
                               rtol=STEP_TOL)
    # the spill holds the same edges; cna_tpu pads it with zero weights
    def coo(g):
        w = np.asarray(g.overflow_weights)
        keep = w > 0
        return sorted(zip(np.asarray(g.overflow_rows)[keep],
                          np.asarray(g.overflow_cols)[keep], w[keep]))
    assert coo(got) == coo(ref)
    assert got.n_overflow == int((np.asarray(ref.overflow_weights) > 0).sum())


def test_no_mirror_edges_gives_the_direct_ell():
    # a ring: every list is mutual, so no entry needs a mirror
    n = 64
    idx = np.stack([np.arange(n), (np.arange(n) + 1) % n,
                    (np.arange(n) - 1) % n], axis=1).astype(np.int32)
    w = np.full((n, 3), 0.5)
    w[:, 0] = 0.0
    code = (w > 0).astype(np.int8)
    ref, got = _both(idx, w, code)
    assert got.max_degree == 3 and got.n_overflow == 0
    assert _same_csr(*_csr_pair(ref, got, n))


def test_sorted_ext_graph_parity_and_diffusion(hubby):
    """The in-degree-bucketed mirror representation (forced with
    ell_max_kx=0): the same CSR as cna_tpu's and as the plain ELL, and the
    same diffusion step (tests/test_device_graph.py:64-103)."""
    x, idx, dists, w_sym, code = hubby
    n = len(x)
    ref, got = _both(idx, w_sym, code, ell_max_kx=0)
    assert isinstance(ref, tpu_device.SortedExtGraph)
    assert isinstance(got, device.SortedExtGraph)
    assert len(got.ext_indices) >= 2  # bucketing engaged
    assert got.padded_area() <= ref.padded_area()  # no size buckets here
    a, b = _csr_pair(ref, got, n)
    assert _same_csr(a, b)
    _, ell = _both(idx, w_sym, code, ell_max_kx=128)
    assert _same_csr(device.DeviceConnectivities(ell, None, n).tocsr(), b)
    np.testing.assert_allclose(got.colsums_raw.numpy(),
                               np.asarray(ref.colsums_raw), rtol=STEP_TOL)

    s = np.random.default_rng(0).standard_normal((n, 5))
    y_ref = np.asarray(tpu_spmm.sorted_ext_spmm(ref, jnp.asarray(s)))
    y = spmm.sorted_ext_spmm(got, torch.from_numpy(s)).numpy()
    np.testing.assert_allclose(y, y_ref, rtol=STEP_TOL, atol=STEP_TOL)
    np.testing.assert_allclose(y, b @ s, rtol=STEP_TOL, atol=STEP_TOL)
    step_ref = np.asarray(tpu_spmm.diffusion_step(
        jnp.asarray(s), ref, ref.colsums(1.0), 1.0))
    step = spmm.diffusion_step(torch.from_numpy(s), got, got.colsums(1.0),
                               1.0).numpy()
    np.testing.assert_allclose(step, step_ref, rtol=STEP_TOL, atol=STEP_TOL)
    step_ell = spmm.diffusion_step(torch.from_numpy(s), ell,
                                   ell.colsums(1.0), 1.0).numpy()
    np.testing.assert_allclose(step, step_ell, rtol=STEP_TOL, atol=STEP_TOL)


def test_graphs_carried_across_from_the_tpu_package(hubby):
    """cna_tpu's packed graphs (padded, overlapping bucket slices and
    all) as the port's, through numpy: same CSR, same SpMM."""
    x, idx, dists, w_sym, code = hubby
    n = len(x)
    ref_s, _ = _both(idx, w_sym, code, ell_max_kx=0)
    ref_e, _ = _both(idx, w_sym, code, ell_max_kx=128)
    npy = np.asarray
    g_s = sorted_ext_graph_from_numpy(
        npy(ref_s.direct_indices), npy(ref_s.direct_weights),
        [npy(i) for i in ref_s.ext_indices],
        [npy(w) for w in ref_s.ext_weights], npy(ref_s.inv_pi),
        npy(ref_s.colsums_raw), npy(ref_s.overflow_rows),
        npy(ref_s.overflow_cols), npy(ref_s.overflow_weights))
    g_e = graph_from_numpy(
        npy(ref_e.indices), npy(ref_e.weights), npy(ref_e.colsums_raw),
        npy(ref_e.overflow_rows), npy(ref_e.overflow_cols),
        npy(ref_e.overflow_weights))
    want = tpu_device.DeviceConnectivities(ref_e, None, n).tocsr()
    for g in (g_s, g_e):
        assert _same_csr(device.DeviceConnectivities(g, None, n).tocsr(),
                         want)
    s = np.random.default_rng(1).standard_normal((n, 4))
    y_ref = np.asarray(tpu_spmm.sorted_ext_spmm(ref_s, jnp.asarray(s)))
    np.testing.assert_allclose(
        spmm.sorted_ext_spmm(g_s, torch.from_numpy(s)).numpy(), y_ref,
        rtol=STEP_TOL, atol=STEP_TOL)


def test_device_graph_permuted_coordinates():
    """With a cell ordering (the IVF compact order) the materialized CSR
    lands in original coordinates (tests/test_device_graph.py:105-129)."""
    x = _hubby_points(1200, seed=3)
    n, k = len(x), 10
    perm = np.random.RandomState(1).permutation(n).astype(np.int32)
    idx_c, _, w_sym, code = _union(x[perm], k)  # compact coordinates
    ref, got = _both(idx_c, w_sym, code)
    a, b = _csr_pair(ref, got, n, perm=perm)
    assert _same_csr(a, b)
    idx_o, dists_o = brute_knn(x, k)
    host = nb.fuzzy_connectivities(idx_o.astype(np.int32), np.sqrt(dists_o))
    assert abs(b - host).max() < 1e-12


def test_lazy_faces_scipy_compat(hubby):
    x, idx, dists, w_sym, code = hubby
    n, k = idx.shape
    _, got = _both(idx, w_sym, code)
    conn = device.DeviceConnectivities(got, None, n)
    assert conn._csr is None and "device" in repr(conn)
    assert conn.shape == (n, n) and conn.dtype == np.float64
    digest = conn.content_digest()
    assert digest == conn.content_digest() and conn._csr is None
    other = device.DeviceConnectivities(
        _both(idx[::-1].copy(), w_sym, code)[1], None, n)
    assert other.content_digest() != digest
    assert conn.nnz > 0 and "materialized" in repr(conn)  # delegates
    assert sp.issparse(conn[5]) and conn.toarray().shape == (n, n)
    assert sp.triu(conn.tocsr(), k=1).nnz * 2 == conn.nnz  # sym, no diag
    with pytest.raises(AttributeError):
        conn._missing

    order = np.random.RandomState(2).permutation(n).astype(np.int32)
    inv = np.argsort(order)
    # lists in compact coordinates: compact row r is original order[r]
    idx_c = inv[idx[order]].astype(np.int32)
    lazy = device.LazyDistances(torch.from_numpy(idx_c),
                                torch.from_numpy(dists[order]), order)
    ref = tpu_device.LazyDistances(jnp.asarray(idx_c),
                                   jnp.asarray(dists[order]), order)
    assert lazy.shape == (n, n) and lazy._csr is None
    assert _same_csr(lazy.tocsr(), ref.tocsr())
    assert lazy.nnz == n * (k - 1)
    rows = np.repeat(np.arange(n), k - 1)
    np.testing.assert_array_equal(
        np.asarray(lazy.tocsr()[rows, idx[:, 1:].ravel()]).ravel(),
        dists[:, 1:].ravel())


def test_diffuse_stepwise_device_graph():
    """The public diffusion primitive honours the device graph's cell
    ordering: each yielded step is in the caller's cell order
    (tests/test_device_graph.py:160-199)."""
    x = _hubby_points(1200, seed=5)
    n, k = len(x), 10
    obs = pd.DataFrame(index=[f"c{i}" for i in range(n)])
    perm = np.random.RandomState(0).permutation(n).astype(np.int32)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(n, dtype=np.int32)
    idx_c, _, w_sym, code = _union(x[perm], k)
    ref, got = _both(idx_c, w_sym, code)
    d = ct.CellData(X=x, obs=obs)
    d.obsp["connectivities"] = device.DeviceConnectivities(
        got, Reordering(perm=perm, inv=inv), n)
    d_ref = cna_tpu.CellData(X=x, obs=obs.copy())
    d_ref.obsp["connectivities"] = tpu_device.DeviceConnectivities(
        ref, TpuReordering(perm=perm, inv=inv), n)
    d_csr = ct.CellData(X=x, obs=obs.copy())
    d_csr.obsp["connectivities"] = d.obsp["connectivities"].tocsr()

    s0 = np.random.RandomState(1).rand(n, 3)
    steps = [s.numpy() for s in ct.tl.diffuse_stepwise(d, s0, maxnsteps=3)]
    steps_ref = [np.asarray(s) for s in
                 cna_tpu.tl.diffuse_stepwise(d_ref, s0, maxnsteps=3)]
    steps_csr = [s.numpy() for s in
                 ct.tl.diffuse_stepwise(d_csr, s0, maxnsteps=3)]
    for a, b, c in zip(steps, steps_ref, steps_csr):
        np.testing.assert_allclose(a, b, rtol=STEP_TOL, atol=STEP_TOL)
        np.testing.assert_allclose(a, c, rtol=STEP_TOL, atol=STEP_TOL)
    df = pd.DataFrame(s0, index=obs.index, columns=list("abc"))
    last = ct.tl.diffuse(d, df, nsteps=3)
    assert list(last.index) == list(obs.index)
    np.testing.assert_allclose(last.to_numpy(), steps[-1], rtol=STEP_TOL)


# ---------------------------------------------------------------------------
# the slice on the CPU
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def atlas():
    """Synthetic data through the port's PCA and pp.neighbors(method='ivf')
    on the CPU, with cna_tpu's IVF search of the same PCA scores."""
    kw = dict(n_samples=20, cells_per_sample=500, n_genes=30, seed=7)
    d, samplem = ct.data.synthetic_dataset(**kw)
    ct.pp.pca(d, n_comps=20)
    ct.pp.neighbors(d, n_neighbors=15, method="ivf")
    return d, samplem["case"].astype(float), kw


def test_neighbors_ivf_stores_device_graph_and_provenance(atlas):
    d, y, _ = atlas
    conn = d.obsp["connectivities"]
    assert isinstance(conn, device.DeviceConnectivities)
    assert isinstance(d.obsp["distances"], device.LazyDistances)
    assert conn.ordering is not None
    assert sorted(conn.ordering.perm) == list(range(d.n_obs))
    params = d.uns["neighbors"]["params"]
    assert params["knn_method"] == "ivf"
    assert params["knn_method_resolved"] == "ivf"
    info = d.uns["neighbors"]["ivf"]
    assert set(info) == {"u", "coverage", "verify_recall", "pilot_curve"}
    assert info["u"] >= 16 and 0 < info["coverage"] <= 1.5
    assert info["verify_recall"] >= 0.9
    assert isinstance(info["pilot_curve"], list)
    csr = conn.tocsr()
    assert abs(csr - csr.T).max() == 0 and csr.diagonal().max() == 0
    dist = d.obsp["distances"].tocsr()
    assert (np.diff(dist.indptr) == 14).all()


def test_association_on_ivf_graph_tracks_the_exact_graph(atlas):
    """Against the port's own exact graph: ncorrs correlate above 0.97 and
    the decision p < 0.05 agrees (tests/test_device_graph.py:202-240)."""
    d, y, kw = atlas
    d_ex, _ = ct.data.synthetic_dataset(**kw)
    ct.pp.pca(d_ex, n_comps=20)
    ct.pp.neighbors(d_ex, n_neighbors=15, method="exact")
    assert sp.issparse(d_ex.obsp["connectivities"])  # the host-CSR branch
    res_ex = ct.tl.association(d_ex, y, "id", Nnull=300, seed=0,
                               return_full=True)
    conn = d.obsp["connectivities"]
    d.obsp["connectivities"] = device.DeviceConnectivities(
        conn.ell, conn.ordering, d.n_obs)  # a face not yet materialized
    res_iv = ct.tl.association(d, y, "id", Nnull=300, seed=0,
                               return_full=True)
    assert d.obsp["connectivities"]._csr is None  # nothing materialized
    assert (res_ex.p < 0.05) == (res_iv.p < 0.05)
    r = np.corrcoef(np.asarray(res_ex.ncorrs), np.asarray(res_iv.ncorrs))[0, 1]
    assert r > 0.97, r
    # a deliberately low-recall graph still tracks the exact one
    rep = np.asarray(d.obsm["X_pca"], np.float32)
    idx, dists = ivf_knn(rep, 15, u0=33, g=64, min_recall=None, seed=0)
    rec = measured_recall(torch.from_numpy(rep), idx, 15, seed=3)
    assert 0.7 < rec < 0.92, f"degradation did not engage (recall {rec})"
    d_dg, _ = ct.data.synthetic_dataset(**kw)
    d_dg.obsp["connectivities"] = nb.fuzzy_connectivities(idx, dists)
    res_dg = ct.tl.association(d_dg, y, "id", Nnull=300, seed=0,
                               return_full=True)
    assert (res_ex.p < 0.05) == (res_dg.p < 0.05)
    r = np.corrcoef(np.asarray(res_ex.ncorrs), np.asarray(res_dg.ncorrs))[0, 1]
    assert r > 0.97, (r, rec)


def test_association_equal_on_carried_knn_lists(atlas):
    """Given cna_tpu's IVF kNN lists and cell order (carried across as
    numpy), both packages build the device graph in float64 and run the
    association: same nsteps, k and p, ncorrs within 1e-8."""
    d, y, kw = atlas
    rep = np.asarray(d.obsm["X_pca"], np.float32)
    res = cna_tpu.pp.ivf.ivf_knn_device(rep, 15)
    idx = np.asarray(res.indices)
    dists = np.asarray(res.dists, dtype=np.float64)
    order = np.asarray(res.order)
    n, k = idx.shape
    inv = np.empty_like(order)
    inv[order] = np.arange(n, dtype=order.dtype)
    null_rng = np.random.RandomState(4)
    out = []
    for pkg in (cna_tpu, ct):
        data, _ = pkg.data.synthetic_dataset(**kw)
        if pkg is cna_tpu:
            i_dev, d_dev = jnp.asarray(idx), jnp.asarray(dists)
            mod, dev_mod, reorder = tpu_nb, tpu_device, TpuReordering
            target = jnp.log2(jnp.asarray(float(k)))
        else:
            i_dev, d_dev = torch.from_numpy(idx), torch.from_numpy(dists)
            mod, dev_mod, reorder = nb, device, Reordering
            target = np.log2(k)
        rho, sigma = mod.smooth_knn_dist(d_dev, target)
        w = mod.membership_strengths(d_dev, rho, sigma, i_dev)
        w_sym, code = mod.fuzzy_union_device(i_dev, w)
        ell = dev_mod.build_sym_ell(i_dev, w_sym, code)
        data.obsp["connectivities"] = dev_mod.DeviceConnectivities(
            ell, reorder(perm=order, inv=inv), n)
        ys = (y - y.mean()) / y.std(ddof=0)
        null_y = np.stack([ys.to_numpy()[null_rng.permutation(len(ys))]
                           for _ in range(200)], axis=1) \
            if not out else out[0][1]
        r = pkg.tl.association(data, y, "id", Nnull=200, null_y=null_y,
                               return_full=True)
        nam, _ = pkg.tl.nam(data, "id")
        nsteps = pkg.tl._nam.nam_arrays(data, "id")[0].nsteps
        out.append((r, null_y, data, nam, nsteps))
    (ra, _, da, nam_a, steps_a), (rb, _, db, nam_b, steps_b) = out
    assert steps_a == steps_b >= 3
    ca = da.obsp["connectivities"].tocsr()
    cb = db.obsp["connectivities"].tocsr()
    assert np.array_equal(ca.indptr, cb.indptr)
    assert np.array_equal(ca.indices, cb.indices)
    np.testing.assert_allclose(cb.data, ca.data, rtol=FUZZY_RTOL)
    assert ra.k == rb.k and ra.p == rb.p
    np.testing.assert_allclose(nam_b.to_numpy(), nam_a.to_numpy(),
                               rtol=1e-8, atol=1e-12)
    np.testing.assert_allclose(np.asarray(rb.ncorrs), np.asarray(ra.ncorrs),
                               rtol=0, atol=1e-8)
    np.testing.assert_allclose(db.obs["coef"].to_numpy(),
                               da.obs["coef"].to_numpy(), rtol=0, atol=1e-8)


def test_neighbors_branch_choice():
    """The device-resident branch for IVF on any device; the host-CSR
    branch for the exact methods on the CPU."""
    x = np.random.RandomState(0).randn(300, 5)
    d = ct.CellData(X=x)
    ct.pp.pca(d, n_comps=4)
    ct.pp.neighbors(d, n_neighbors=5)
    assert sp.issparse(d.obsp["connectivities"])
    assert sp.issparse(d.obsp["distances"])
    assert "ivf" not in d.uns["neighbors"]
    assert nb._neighbors_meta(5, "auto", "exact") == d.uns["neighbors"]
    ct.pp.neighbors(d, n_neighbors=5, method="ivf")
    assert isinstance(d.obsp["connectivities"], device.DeviceConnectivities)
    assert d.uns["neighbors"]["ivf"]["verify_recall"] >= 0.9


# ---------------------------------------------------------------------------
# streamed PCA
# ---------------------------------------------------------------------------


def test_streamed_pca_matches_tpu_package():
    """Several chunks through both packages' streamed PCA in float64:
    scores within 1e-8 up to column signs."""
    x = np.random.RandomState(11).randn(1_000, 12) + 3.0
    sa, va, ca, ta = tpu_pca._pca_dense_streamed(x, 6, chunk_rows=300)
    sb, vb, cb, tb = pca_mod._pca_dense_streamed(x, 6, chunk_rows=300)
    assert sb.dtype == torch.float64 and sb.shape == (1_000, 6)
    s = sign_align(np.asarray(sa), sb.numpy())
    np.testing.assert_allclose(sb.numpy() * s, np.asarray(sa), rtol=0,
                               atol=1e-8)
    np.testing.assert_allclose(vb, va, rtol=1e-10)
    np.testing.assert_allclose(cb * s, ca, atol=1e-8)
    assert abs(tb - ta) <= 1e-10 * abs(ta)
    # and the in-memory path of the port itself
    sc, vc, _, tc = pca_mod._pca_device(torch.from_numpy(x), 6)
    np.testing.assert_allclose(sb.numpy() * sign_align(sc.numpy(),
                                                       sb.numpy()),
                               sc.numpy(), rtol=0, atol=1e-8)
    np.testing.assert_allclose(vb, vc, rtol=1e-10)


def test_pca_takes_the_streamed_path_above_its_threshold(monkeypatch):
    x = np.random.RandomState(12).randn(400, 10)
    d_small, d_big = ct.CellData(X=x), ct.CellData(X=x)
    ct.pp.pca(d_small, n_comps=5)
    monkeypatch.setattr(pca_mod, "_STREAM_MIN_ELEMS", 4_000)
    calls = []
    streamed = pca_mod._pca_dense_streamed
    monkeypatch.setattr(
        pca_mod, "_pca_dense_streamed",
        lambda xh, nc: calls.append(xh.shape) or streamed(xh, nc,
                                                          chunk_rows=128))
    scores = ct.pp.pca(d_big, n_comps=5)
    assert calls == [(400, 10)]
    assert isinstance(scores, np.ndarray) and scores.shape == (400, 5)
    ref = d_small.obsm["X_pca"]
    np.testing.assert_allclose(scores * sign_align(ref, scores), ref,
                               rtol=0, atol=1e-8)
    np.testing.assert_allclose(d_big.uns["pca"]["variance_ratio"],
                               d_small.uns["pca"]["variance_ratio"],
                               rtol=1e-8)
    # the device copy feeds pp.neighbors without a host round trip
    assert pca_mod.device_rep(d_big, d_big.obsm["X_pca"]) is not scores
