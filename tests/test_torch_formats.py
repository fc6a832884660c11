"""The opt-in locality formats ('banded', 'block', 'hybrid'), cna_tpu_torch
against cna_tpu on the CPU in float64: the cell orderings, the packed
graphs field for field, the block SpMM, and ``tl.nam`` / ``tl.association``
under each format against the port's own 'ell' result and against
``cna_tpu`` under the same format.

Both packages get the same numpy data and the same ``obsm['X_pca']`` (the
port's scores, sign-fixed and rounded to dyadic values, which also makes
the kNN distance expansion exact in both; ``torch_parity.dyadic``), so the
kd ordering, the permuted graph and the packs are the same arrays.
"""

import numpy as np
import pandas as pd
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp

import cna_tpu
import cna_tpu_torch as ct
from cna_tpu.graph import blocks as tpu_blocks
from cna_tpu.graph import reorder as tpu_reorder
from cna_tpu.ops import spmm as tpu_spmm
from cna_tpu.tools import _nam as tpu_nam
from cna_tpu_torch.graph import blocks, reorder
from cna_tpu_torch.graph.device import DeviceConnectivities
from cna_tpu_torch.ops import spmm
from cna_tpu_torch.ops.spmm_banded import BandedGraph
from cna_tpu_torch.tools import _nam

from .torch_parity import dyadic, torch_cpu_x64  # noqa: F401

RTOL = 1e-8  # NAM and association outputs, as tests/test_spmm_pallas.py
SPMM_RTOL = 1e-12
FORMATS = ("banded", "block", "hybrid")
N_SAMPLES, CELLS = 12, 120
SAMPLES = [f"s{i:02d}" for i in range(N_SAMPLES)]


def manifold_x(seed=5, genes=12):
    """Cells on a smooth 2-D sheet (the data of
    ``tests/test_spmm_pallas.py::test_banded_format_nam_matches_ell``)."""
    rng = np.random.RandomState(seed)
    n = N_SAMPLES * CELLS
    t = rng.rand(n, 2) * 3
    return np.sin(t @ rng.randn(2, genes)) + 0.05 * rng.randn(n, genes)


@pytest.fixture(scope="module")
def graphs():
    """(cna_tpu data, port data, y): the same X, the same X_pca, each
    package's own exact kNN graph of it."""
    x = manifold_x()
    obs = pd.DataFrame({"sid": np.repeat(SAMPLES, CELLS)},
                       index=[f"c{i}" for i in range(len(x))])
    ref = ct.CellData(X=x.copy(), obs=obs.copy())
    ct.pp.pca(ref, n_comps=8)
    scores = dyadic(ref.obsm["X_pca"])
    out = []
    for pkg in (cna_tpu, ct):
        d = pkg.CellData(X=x.copy(), obs=obs.copy())
        d.obsm["X_pca"] = scores.copy()
        pkg.pp.neighbors(d, n_neighbors=8)
        out.append(d)
    rng = np.random.RandomState(2)
    y = pd.Series((np.arange(N_SAMPLES) >= N_SAMPLES // 2)
                  + 0.3 * rng.randn(N_SAMPLES), index=SAMPLES)
    a, b = out
    assert abs(a.obsp["connectivities"] - b.obsp["connectivities"]).max() \
        < 1e-12
    return a, b, y


def random_sparse(n, density, seed):
    return sp.random(n, n, density=density, random_state=seed, format="csr")


# ---------------------------------------------------------------------------
# orderings
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,dim,kw", [
    (1000, 8, {}), (777, 3, dict(block_size=64)),
    (500, 5, dict(leaf_size=7, seed=3)), (40, 2, {})])
def test_cluster_ordering_matches(n, dim, kw):
    emb = np.random.RandomState(n).randn(n, dim)
    want = tpu_blocks.cluster_ordering(emb, **kw)
    got = blocks.cluster_ordering(emb, **kw)
    np.testing.assert_array_equal(got.perm, want.perm)
    np.testing.assert_array_equal(got.inv, want.inv)
    assert got.n == n and sorted(got.perm) == list(range(n))


def test_rcm_ordering_and_graph_permutations_match(graphs):
    conn = graphs[1].obsp["connectivities"]
    want = tpu_reorder.rcm_ordering(conn)
    got = reorder.rcm_ordering(conn)
    np.testing.assert_array_equal(got.perm, want.perm)
    np.testing.assert_array_equal(got.inv, want.inv)
    # the ordering narrows the band, and both permutations agree
    before = reorder.bandwidth_profile(conn)
    permuted = reorder.permute_graph(conn, got)
    after = reorder.bandwidth_profile(permuted)
    assert after == tpu_reorder.bandwidth_profile(
        tpu_reorder.permute_graph(conn, want))
    assert after[1] < before[1]
    unsorted = reorder.permute_graph_unsorted(conn, got)
    assert abs(unsorted - permuted).max() == 0
    ref_unsorted = tpu_reorder.permute_graph_unsorted(conn, want)
    np.testing.assert_array_equal(unsorted.indices, ref_unsorted.indices)
    assert reorder.bandwidth_profile(sp.csr_matrix((5, 5))) == (0, 0)


# ---------------------------------------------------------------------------
# packs and the block SpMM
# ---------------------------------------------------------------------------

BLOCK_FIELDS = ("tiles", "pair_rows", "pair_cols", "colsums_raw")


def assert_same_block(got, want):
    for name in BLOCK_FIELDS:
        g, w = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        assert g.shape == w.shape and g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)
    for name in ("n_cells", "block_size", "n_blocks", "n_pairs", "n_rows"):
        assert getattr(got, name) == getattr(want, name), name


def assert_same_ell(got, want):
    for name in ("indices", "weights", "overflow_rows", "overflow_cols",
                 "overflow_weights", "colsums_raw"):
        g, w = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        assert g.shape == w.shape and g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)


@pytest.mark.parametrize("n,b", [(700, 64), (512, 32), (100, 256)])
def test_block_pack_matches(n, b):
    a = random_sparse(n, 0.02, seed=n)
    want = tpu_blocks.from_scipy_blocks(a, block_size=b)
    got = blocks.from_scipy_blocks(a, block_size=b)
    assert_same_block(got, want)
    assert got.dtype == torch.float64 and got.device.type == "cpu"
    np.testing.assert_array_equal(got.colsums(2.0).numpy(),
                                  np.asarray(want.colsums(2.0)))
    got32 = blocks.from_scipy_blocks(a, block_size=b, dtype=np.float32)
    assert_same_block(got32, tpu_blocks.from_scipy_blocks(
        a, block_size=b, dtype=np.float32))


@pytest.mark.parametrize("kw", [
    dict(block_size=32, coverage=0.6), dict(block_size=64),
    dict(block_size=32, min_pair_nnz=4)])
def test_hybrid_pack_matches(graphs, kw):
    conn = graphs[1].obsp["connectivities"]
    order = blocks.cluster_ordering(graphs[1].obsm["X_pca"])
    a = reorder.permute_graph(conn, order)
    want = tpu_blocks.from_scipy_hybrid(a, **kw)
    got = blocks.from_scipy_hybrid(a, **kw)
    assert_same_block(got.block, want.block)
    assert_same_ell(got.ell, want.ell)
    np.testing.assert_array_equal(got.colsums_raw.numpy(),
                                  np.asarray(want.colsums_raw))
    assert got.n_cells == want.n_cells and got.n_rows == want.n_rows
    assert got.block.n_pairs > 0 and got.ell.n_rows == got.n_rows


def carried_block(g):
    return ct.ut.block_graph_from_numpy(
        *(np.asarray(getattr(g, f)) for f in BLOCK_FIELDS), g.n_cells)


@pytest.mark.parametrize("pair_chunk", [10**9, 16])
def test_block_spmm_matches(pair_chunk):
    """The one-shot and the chunked branch, on a graph carried over from
    the TPU package."""
    n, s = 1000, 5
    a = random_sparse(n, 0.05, seed=6)
    want_g = tpu_blocks.from_scipy_blocks(a, block_size=32)
    g = carried_block(want_g)
    assert g.n_pairs > 16 and g.n_rows == 1024
    x = np.pad(np.random.RandomState(1).randn(n, s), ((0, 24), (0, 0)))
    got = spmm.block_spmm(g, torch.as_tensor(x), pair_chunk=pair_chunk)
    want = tpu_spmm.block_spmm(want_g, jnp.asarray(x), pair_chunk=pair_chunk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=SPMM_RTOL, atol=1e-13)
    np.testing.assert_allclose(got.numpy()[:n], a @ x[:n], rtol=SPMM_RTOL,
                               atol=1e-13)
    assert not got.numpy()[n:].any()


@pytest.mark.parametrize("fmt", ["block", "hybrid"])
@pytest.mark.parametrize("self_weight", [1.0, 0.0])
def test_block_diffusion_step_matches_on_padded_rows(fmt, self_weight):
    """``n_rows`` of the block formats is the padded row count and their
    column sums are 0 on padding rows: with ``self_weight = 0`` the step
    divides 0 by 0 there, and the tiles carry the result into every row
    that shares a tile with the padding block.  The port carries the TPU
    package's behaviour: the same values and the same non-numbers."""
    n, s = 900, 6
    a = random_sparse(n, 0.03, seed=8)
    a = (a + a.T).tocsr()
    if fmt == "block":
        want_g = tpu_blocks.from_scipy_blocks(a, block_size=32)
        g = carried_block(want_g)
    else:
        want_g = tpu_blocks.from_scipy_hybrid(a, block_size=32, coverage=0.6)
        e = want_g.ell
        g = ct.ut.hybrid_graph_from_numpy(
            carried_block(want_g.block),
            ct.ut.graph_from_numpy(
                np.asarray(e.indices), np.asarray(e.weights),
                np.asarray(e.colsums_raw), np.asarray(e.overflow_rows),
                np.asarray(e.overflow_cols), np.asarray(e.overflow_weights)),
            np.asarray(want_g.colsums_raw), want_g.n_cells)
    assert g.n_rows == 928 > n
    x = np.pad(np.random.RandomState(3).rand(n, s), ((0, 28), (0, 0)))
    got = spmm.diffusion_step(torch.as_tensor(x), g, g.colsums(self_weight),
                              self_weight).numpy()
    want = np.asarray(tpu_spmm.diffusion_step(
        jnp.asarray(x), want_g, want_g.colsums(self_weight), self_weight))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, rtol=SPMM_RTOL, atol=1e-13)
    if self_weight:
        t = x[:n] / (np.asarray(a.sum(axis=0)).ravel() + self_weight)[:, None]
        np.testing.assert_allclose(got[:n], a @ t + self_weight * t,
                                   rtol=SPMM_RTOL)
        assert np.isfinite(got).all()
    else:
        assert np.isnan(got[n:]).all()  # 0 / 0 on the padding rows


# ---------------------------------------------------------------------------
# tl.nam / tl.association under each format
# ---------------------------------------------------------------------------


def _nam_under(pkg, d, fmt, **kw):
    pkg.tl.set_graph_format(d, fmt)
    try:
        return pkg.tl.nam(d, "sid", **kw)
    finally:
        pkg.tl.set_graph_format(d, "ell")


@pytest.mark.parametrize("fmt", FORMATS)
def test_nam_under_format_matches_ell_and_tpu_package(graphs, fmt):
    a, b, _ = graphs
    nam_ell, keep_ell = _nam_under(ct, b, "ell", nsteps=3)
    nam_fmt, keep_fmt = _nam_under(ct, b, fmt, nsteps=3)
    nam_ref, keep_ref = _nam_under(cna_tpu, a, fmt, nsteps=3)
    assert np.array_equal(keep_fmt, keep_ell)
    assert np.array_equal(keep_fmt, keep_ref)
    assert list(nam_fmt.index) == list(nam_ref.index)
    assert list(nam_fmt.columns) == list(nam_ref.columns)
    np.testing.assert_allclose(nam_fmt.to_numpy(), nam_ell.to_numpy(),
                               rtol=RTOL, atol=1e-10)
    np.testing.assert_allclose(nam_fmt.to_numpy(), nam_ref.to_numpy(),
                               rtol=RTOL, atol=1e-10)


@pytest.mark.parametrize("fmt", FORMATS)
def test_packed_graph_of_the_pipeline_matches(graphs, fmt):
    """``get_device_graph`` orders, permutes and packs as the TPU package
    does: the same ordering and the same packed fields."""
    a, b, _ = graphs
    want, want_order = tpu_nam.get_device_graph(a, fmt=fmt)
    got, order = _nam.get_device_graph(b, fmt=fmt)
    np.testing.assert_array_equal(order.perm, want_order.perm)
    # the two packages' own fuzzy weights differ by rounding, so compare
    # the pack of ONE matrix: the port's, permuted by the shared ordering
    permuted = reorder.permute_graph(b.obsp["connectivities"], order)
    if fmt == "banded":
        from cna_tpu.ops.spmm_pallas import banded_from_scipy

        from .test_torch_banded import assert_same_pack, fields_of

        assert isinstance(got, BandedGraph)
        arrays, geometry = fields_of(got)
        assert_same_pack(banded_from_scipy(permuted), {**arrays, **geometry})
        assert got.n_rows == b.n_obs
    elif fmt == "block":
        assert_same_block(got, tpu_blocks.from_scipy_blocks(permuted))
        assert got.n_rows == want.n_rows >= b.n_obs
    else:
        ref = tpu_blocks.from_scipy_hybrid(permuted)
        assert_same_block(got.block, ref.block)
        assert_same_ell(got.ell, ref.ell)


def test_adaptive_nam_under_banded_takes_the_same_steps(graphs):
    a, b, _ = graphs
    ct.tl.set_graph_format(b, "banded")
    cna_tpu.tl.set_graph_format(a, "banded")
    try:
        nb, kb = _nam.nam_arrays(b, "sid")
        na, ka = tpu_nam.nam_arrays(a, "sid")
    finally:
        ct.tl.set_graph_format(b, "ell")
        cna_tpu.tl.set_graph_format(a, "ell")
    n_ell, _ = _nam.nam_arrays(b, "sid")
    assert nb.nsteps == na.nsteps == n_ell.nsteps
    assert np.array_equal(kb, ka)
    np.testing.assert_allclose(nb.nam.numpy(), np.asarray(na.nam), rtol=RTOL,
                               atol=1e-10)


def test_association_under_banded_matches(graphs):
    a, b, y = graphs
    ys = ((y - y.mean()) / y.std(ddof=0)).to_numpy()
    rng = np.random.RandomState(11)
    null_y = np.stack([ys[rng.permutation(len(ys))] for _ in range(200)],
                      axis=1)
    kw = dict(Nnull=200, null_y=null_y, return_full=True)
    r_ell = ct.tl.association(b, y, "sid", **kw)
    ct.tl.set_graph_format(b, "banded")
    cna_tpu.tl.set_graph_format(a, "banded")
    try:
        rb = ct.tl.association(b, y, "sid", **kw)
        ra = cna_tpu.tl.association(a, y, "sid", **kw)
    finally:
        ct.tl.set_graph_format(b, "ell")
        cna_tpu.tl.set_graph_format(a, "ell")
    assert rb.p == ra.p == r_ell.p and rb.k == ra.k == r_ell.k
    assert np.array_equal(rb.kept, ra.kept)
    np.testing.assert_allclose(rb.ncorrs, ra.ncorrs, rtol=RTOL, atol=1e-10)
    np.testing.assert_allclose(rb.ncorrs, r_ell.ncorrs, rtol=RTOL,
                               atol=1e-10)
    np.testing.assert_allclose(b.obs["coef"], a.obs["coef"], rtol=RTOL,
                               atol=1e-10)


def test_rcm_fallback_without_an_embedding(graphs):
    """No ``obsm['X_pca']``: the graph itself is ordered (reverse
    Cuthill-McKee), in both packages alike."""
    a, b, _ = graphs
    out = []
    for pkg, src in ((cna_tpu, a), (ct, b)):
        d = pkg.CellData(X=np.zeros((src.n_obs, 1)), obs=src.obs.copy())
        d.obsp["connectivities"] = b.obsp["connectivities"].copy()
        out.append((_nam_under(pkg, d, "ell", nsteps=2),
                    _nam_under(pkg, d, "banded", nsteps=2)))
    (_, (ref, _)), ((ell, _), (got, _)) = out
    np.testing.assert_allclose(got.to_numpy(), ell.to_numpy(), rtol=RTOL,
                               atol=1e-10)
    np.testing.assert_allclose(got.to_numpy(), ref.to_numpy(), rtol=RTOL,
                               atol=1e-10)


def test_device_connectivities_under_banded(graphs):
    """A device-resident graph (``method='ivf'``, here on the CPU) is
    materialized as a host CSR for an explicit locality format only."""
    _, b, _ = graphs
    d = ct.CellData(X=b.X.copy(), obs=b.obs.copy())
    d.obsm["X_pca"] = b.obsm["X_pca"].copy()
    ct.pp.neighbors(d, n_neighbors=8, method="ivf")
    conn = d.obsp["connectivities"]
    assert isinstance(conn, DeviceConnectivities)
    nam_def, keep_def = ct.tl.nam(d, "sid", nsteps=3)
    assert conn._csr is None  # the default format never materializes it
    ct.tl.set_graph_format(d, "banded")
    nam_b, keep_b = ct.tl.nam(d, "sid", nsteps=3)
    assert conn._csr is not None
    graph, order = _nam.get_device_graph(d)
    assert isinstance(graph, BandedGraph) and order is not None
    assert np.array_equal(keep_b, keep_def)
    # the device graph sums its columns in the float32 of the IVF search
    # (in both packages), the packer in float64 from the host CSR: the two
    # formats agree to float32 rounding here, not to 1e-8
    np.testing.assert_allclose(nam_b.to_numpy(), nam_def.to_numpy(),
                               rtol=1e-5, atol=1e-10)
    # the TPU package on the materialized graph and the same embedding
    ref = cna_tpu.CellData(X=b.X.copy(), obs=b.obs.copy())
    ref.obsm["X_pca"] = b.obsm["X_pca"].copy()
    ref.obsp["connectivities"] = conn.tocsr().copy()
    nam_ref, _ = _nam_under(cna_tpu, ref, "banded", nsteps=3)
    np.testing.assert_allclose(nam_b.to_numpy(), nam_ref.to_numpy(),
                               rtol=RTOL, atol=1e-10)


def test_packed_graph_is_cached_and_dropped_by_set_graph_format(graphs):
    _, b, _ = graphs
    ct.tl.set_graph_format(b, "banded")
    try:
        g1, o1 = _nam.get_device_graph(b)
        g2, o2 = _nam.get_device_graph(b)
        assert g1 is g2 and o1 is o2  # reused on a second call
        assert any(str(k).startswith(_nam._ELL_CACHE_KEY) for k in b.uns)
        ct.tl.set_graph_format(b, "banded")  # drops every packed graph
        assert not any(str(k).startswith(_nam._ELL_CACHE_KEY) for k in b.uns)
        g3, _ = _nam.get_device_graph(b)
        assert g3 is not g1
        np.testing.assert_array_equal(g3.lidx.numpy(), g1.lidx.numpy())
        # a new graph object misses the cache even without a format change
        b.obsp["connectivities"] = b.obsp["connectivities"].copy()
        g4, _ = _nam.get_device_graph(b)
        assert g4 is not g3
    finally:
        ct.tl.set_graph_format(b, "ell")


def test_graph_pack_is_a_profiling_phase(graphs):
    from cna_tpu_torch.utils import profiling

    _, b, _ = graphs
    prof = profiling.enable_profiling()
    try:
        ct.tl.set_graph_format(b, "block")
        _nam.get_device_graph(b)
        names = [p["phase"] for p in prof.phases]
        assert names == ["graph_pack_ordering", "graph_pack_permute",
                         "graph_pack_pack", "graph_pack"]
        _nam.get_device_graph(b)  # cached: no second pack
        assert len(prof.phases) == 4
    finally:
        ct.tl.set_graph_format(b, "ell")
        profiling._GLOBAL = profiling.PhaseProfiler(enabled=False)
