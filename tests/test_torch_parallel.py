"""cna_tpu_torch.parallel against cna_tpu.parallel and against the port's
single-device path, on the CPU in float64.

The port's mesh slots are all ``cpu`` here (devices may repeat), so 16
and 32 shards need no subprocess; the TPU package runs on the 8 virtual
CPU devices of ``tests/conftest.py``.  Tolerances: the halo step against
the single-device step at rtol 1e-10 / atol 1e-12 (the same sums in
another order), the association at rtol 1e-8 / atol 1e-11 (as
``tests/test_mesh_association.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import scipy.sparse as sp
import torch

import cna_tpu
import cna_tpu_torch as ct
from cna_tpu.parallel import halo as tpu_halo
from cna_tpu.parallel import make_mesh as tpu_make_mesh
from cna_tpu_torch.graph.ell import from_scipy
from cna_tpu_torch.ops import fdr, spmm
from cna_tpu_torch.parallel import dist, halo, launch, make_mesh, sharded
from cna_tpu_torch.utils.interop import halo_plan_from_numpy

from .torch_parity import dyadic, torch_cpu_x64  # noqa: F401

STEP_RTOL, STEP_ATOL = 1e-10, 1e-12
ASSOC_RTOL, ASSOC_ATOL = 1e-8, 1e-11


def _hub_graph():
    """The hub-skewed 1,600-cell graph of ``tests/halo_many_worker.py``."""
    rng = np.random.RandomState(0)
    n = 1600
    a = sp.random(n, n, density=0.01, random_state=1, format="csr")
    hub_rows = np.repeat([3, 701, 1203], 300)
    hub_cols = rng.randint(0, n, hub_rows.size)
    hubs = sp.csr_matrix((np.full(hub_rows.size, 0.3),
                          (hub_rows, hub_cols)), shape=(n, n))
    return (a + a.T + hubs + hubs.T).tocsr()


@pytest.fixture(scope="module")
def demo():
    """The demo dataset of ``tests/fixtures.py`` (50 samples x 200 cells x
    50 genes) with its graph built by the port, as (port CellData,
    sample metadata); both packages are fed this one graph."""
    from .fixtures import make_demo_dataset

    d, samplem = make_demo_dataset(seed=0, build_graph=False)
    d = ct.CellData(X=np.asarray(d.X), obs=d.obs[["id"]].copy())
    ct.pp.pca(d, n_comps=50)
    ct.pp.neighbors(d, n_neighbors=15)
    return d, samplem


@pytest.fixture(scope="module")
def demo_graph(demo):
    return demo[0].obsp["connectivities"].tocsr()


@pytest.fixture(scope="module")
def hub_graph():
    return _hub_graph()


def _graph(request, name):
    return request.getfixturevalue(name)


CASES = [("demo_graph", 2), ("demo_graph", 4), ("demo_graph", 8),
         ("hub_graph", 16), ("hub_graph", 32)]


def _tpu_plan_fields(plan):
    return dict(
        bucket_indices=[np.asarray(i) for i in plan.bucket_indices],
        bucket_weights=[np.asarray(w) for w in plan.bucket_weights],
        row_pos=np.asarray(plan.row_pos),
        send_rounds=[np.asarray(s) for s in plan.send_rounds],
        colsums=np.asarray(plan.colsums), n_cells=plan.n_cells,
        n_ghosts=plan.n_ghosts, rounds=plan.rounds,
        out_permuted=plan.out_permuted)


@pytest.mark.parametrize("graph,n_shards", CASES)
def test_halo_plan_equals_tpu_package(request, graph, n_shards):
    a = _graph(request, graph)
    ref = _tpu_plan_fields(tpu_halo.build_halo_plan_csr(a, n_shards))
    plan = halo.build_halo_plan_csr(a, n_shards)
    assert plan.rounds == ref["rounds"]
    assert (plan.n_cells, plan.n_ghosts, plan.out_permuted) == (
        ref["n_cells"], ref["n_ghosts"], ref["out_permuted"])
    for name in ("bucket_indices", "bucket_weights", "send_rounds"):
        ours = getattr(plan, name)
        assert len(ours) == len(ref[name]), name
        for o, r in zip(ours, ref[name]):
            assert o.dtype == torch.from_numpy(r.copy()).dtype, name
            np.testing.assert_array_equal(o.numpy(), r, err_msg=name)
    np.testing.assert_array_equal(plan.row_pos.numpy(), ref["row_pos"])
    np.testing.assert_array_equal(plan.colsums.numpy(), ref["colsums"])
    stats = plan.exchange_stats(s_cols=50)
    assert stats["padded_bytes"] >= stats["ghost_bytes"] > 0


def _single_step(a, s, self_weight, steps=1):
    g = from_scipy(a, width_percentile=100.0)
    cur = torch.from_numpy(s)
    for _ in range(steps):
        cur = spmm.diffusion_step(cur, g, g.colsums(self_weight),
                                  self_weight)
    return cur.numpy()


@pytest.mark.parametrize("graph,n_shards", CASES)
def test_halo_step_equals_single_device(request, graph, n_shards):
    a = _graph(request, graph)
    n = a.shape[0]
    s = np.random.default_rng(2).standard_normal((n, 5))
    expected = _single_step(a, s, 1.5, steps=3)
    mesh = make_mesh(["cpu"] * n_shards)
    plan = halo.place_plan(halo.build_halo_plan_csr(a, n_shards), mesh)
    n_pad = plan.n_shards * plan.shard_rows
    cur = torch.from_numpy(np.pad(s, ((0, n_pad - n), (0, 0))))
    for _ in range(3):
        cur = halo.halo_diffusion_step(cur, plan, mesh, 1.5)
    np.testing.assert_allclose(np.asarray(cur)[:n], expected,
                               rtol=STEP_RTOL, atol=STEP_ATOL)


def test_halo_step_equals_tpu_package_on_one_plan(demo_graph):
    """Both packages' halo steps over 8 shards, fed the TPU package's
    plan (``utils.interop.halo_plan_from_numpy``)."""
    a = demo_graph
    n = a.shape[0]
    tpu_plan = tpu_halo.build_halo_plan_csr(a, 8)
    plan = halo_plan_from_numpy(**_tpu_plan_fields(tpu_plan))
    n_pad = plan.n_shards * plan.shard_rows
    s = np.pad(np.random.default_rng(3).standard_normal((n, 7)),
               ((0, n_pad - n), (0, 0)))
    ref = np.asarray(tpu_halo.halo_diffusion_step(
        jnp.asarray(s), tpu_plan, tpu_make_mesh(jax.devices()[:8]), 1.0))
    got = halo.halo_diffusion_step(torch.from_numpy(s), plan,
                                   make_mesh(["cpu"] * 8), 1.0)
    np.testing.assert_allclose(np.asarray(got), ref, rtol=STEP_RTOL,
                               atol=STEP_ATOL)


def test_halo_plan_of_an_empty_graph():
    """A graph without edges plans no round and no bucket width, and its
    plan still states its dtype (the TPU package's ``HaloPlan.dtype``
    reads the first bucket's weights and raises there)."""
    plan = halo.build_halo_plan_csr(sp.csr_matrix((40, 40)), 4)
    assert plan.rounds == () and plan.n_ghosts == 0
    assert plan.dtype == torch.float64
    s = torch.ones(plan.n_shards * plan.shard_rows, 3,
                   dtype=torch.float64)
    out = halo.halo_diffusion_step(s, plan, make_mesh(["cpu"] * 4), 1.0)
    np.testing.assert_allclose(np.asarray(out)[:40], 1.0)


def test_row_sharded_step_equals_single_device(hub_graph):
    """The fallback step (state all-gathered, rows over the cell slots) on
    an ELL graph with a COO overflow tail, and uneven row blocks."""
    g = from_scipy(hub_graph, width_percentile=90.0)
    assert g.n_overflow > 0
    s = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (hub_graph.shape[0], 4)))
    colsums = g.colsums(1.0)
    expected = spmm.diffusion_step(s, g, colsums, 1.0).numpy()
    mesh = make_mesh(["cpu"] * 6, perms=2)
    got = sharded.diffusion_step(s, sharded.shard_graph(g, mesh), colsums,
                                 1.0, mesh)
    np.testing.assert_allclose(np.asarray(got), expected, rtol=STEP_RTOL,
                               atol=STEP_ATOL)


def _copy(pkg, d):
    """A fresh CellData of package ``pkg`` holding ``d``'s X, sample ids,
    PCA scores and graph."""
    return pkg.CellData(X=np.asarray(d.X), obs=d.obs[["id"]].copy(),
                        obsm={"X_pca": np.asarray(d.obsm["X_pca"])},
                        obsp={"connectivities":
                              d.obsp["connectivities"].tocsr()})


@pytest.fixture(scope="module")
def port_demo(demo):
    return _copy(ct, demo[0])


def test_nam_arrays_on_mesh_equals_single_device(port_demo):
    d = port_demo
    single, keep_s = ct.tools._nam.nam_arrays(d, "id")
    assert d.uns["_cna_tpu_torch_diffusion_path"] == "local"
    meshed, keep_m = ct.tools._nam.nam_arrays(d, "id",
                                              mesh=make_mesh(["cpu"] * 4))
    assert d.uns["_cna_tpu_torch_diffusion_path"] == "halo"
    assert np.array_equal(keep_s, keep_m)
    assert meshed.nsteps == single.nsteps
    np.testing.assert_allclose(meshed.nam.numpy(), single.nam.numpy(),
                               rtol=1e-10, atol=1e-13)
    plan, ordering = ct.tools._nam.get_halo_plan(d, 4)
    assert sorted(ordering.perm) == list(range(d.n_obs))
    # the locality partition keeps the exchange well under an all-gather
    # ((D-1) = 3 cells' worth per cell)
    assert 0 < plan.ghost_fraction() < 2.0


def test_mesh_fallback_on_explicit_format(port_demo):
    """A user-set 'bucketed' graph has no halo plan: the mesh path takes
    the fallback, path 'gspmd', and still matches."""
    d = port_demo
    single, _ = ct.tools._nam.nam_arrays(d, "id")
    ct.tl.set_graph_format(d, "bucketed")
    try:
        meshed, _ = ct.tools._nam.nam_arrays(d, "id",
                                             mesh=make_mesh(["cpu"] * 4))
        assert d.uns["_cna_tpu_torch_diffusion_path"] == "gspmd"
        np.testing.assert_allclose(meshed.nam.numpy(), single.nam.numpy(),
                                   rtol=1e-10, atol=1e-13)
    finally:
        d.uns.pop(ct.tools._nam._FORMAT_KEY, None)


@pytest.fixture(scope="module")
def assoc_inputs(demo):
    y = demo[1]["case"].astype(float)
    return y, np.random.RandomState(9).randn(50, 64)


@pytest.mark.parametrize("fused", [False, True])
def test_association_on_mesh_equals_tpu_and_single_device(
        demo, port_demo, assoc_inputs, fused, monkeypatch):
    """8 slots as 4 cells x 2 perms against the TPU package on its 8
    virtual devices and against the port on one device; ``fused`` forces
    the mesh tail counts (``ops.fdr.null_coef_tail_counts_mesh``)."""
    y, null_y = assoc_inputs
    d_tpu = _copy(cna_tpu, demo[0])
    ref = cna_tpu.tl.association(d_tpu, y, "id", Nnull=64, null_y=null_y,
                                 mesh=tpu_make_mesh(jax.devices()[:8],
                                                    perms=2),
                                 return_full=True)
    assert d_tpu.uns["_cna_tpu_diffusion_path"] == "halo"
    d = port_demo
    single = ct.tl.association(d, y, "id", Nnull=64, null_y=null_y,
                               return_full=True)
    if fused:
        monkeypatch.setattr(ct.tools._association,
                            "_FUSED_FDR_MIN_ELEMENTS", 0)
    meshed = ct.tl.association(d, y, "id", Nnull=64, null_y=null_y,
                               mesh=make_mesh(["cpu"] * 8, perms=2),
                               return_full=True)
    assert d.uns["_cna_tpu_torch_diffusion_path"] == "halo"
    for other in (ref, single):
        assert meshed.p == other.p and meshed.k == other.k
        np.testing.assert_allclose(meshed.ncorrs, other.ncorrs,
                                   rtol=ASSOC_RTOL, atol=ASSOC_ATOL)
        np.testing.assert_allclose(meshed.fdrs.fdr.values,
                                   other.fdrs.fdr.values,
                                   rtol=ASSOC_RTOL, atol=ASSOC_ATOL)
        np.testing.assert_allclose(meshed.nullminps, other.nullminps,
                                   rtol=ASSOC_RTOL, atol=ASSOC_ATOL)
    np.testing.assert_array_equal(meshed.fdrs.num_detected.values,
                                  single.fdrs.num_detected.values)


def test_mesh_tail_counts_equal_unsharded_and_tpu_package():
    """Cell and null counts that divide neither mesh axis (1,003 cells
    over 3, 37 nulls over 2)."""
    from cna_tpu.ops import fdr as tpu_fdr

    rng = np.random.default_rng(5)
    s, c, m = 20, 1003, 37
    namresid = rng.standard_normal((s, c))
    ycond = rng.standard_normal((s, m))
    nr_t, yc_t = torch.from_numpy(namresid), torch.from_numpy(ycond)
    t0, dt, nb = 0.05, 0.002, 400
    whole = fdr.null_coef_tail_counts(nr_t, yc_t, s, t0, dt, nb)
    meshed = fdr.null_coef_tail_counts_mesh(
        nr_t, yc_t, s, t0, dt, nb, make_mesh(["cpu"] * 6, perms=2),
        block=128)
    ref = tpu_fdr.null_coef_tail_counts_mesh(
        jnp.asarray(namresid), jnp.asarray(ycond), s, t0, dt, nb,
        tpu_make_mesh(jax.devices()[:6], perms=2))
    assert int(whole[0]) > 0
    np.testing.assert_array_equal(meshed.numpy(), whole.numpy())
    np.testing.assert_array_equal(meshed.numpy(), np.asarray(ref))


def test_sharded_knn_equals_tpu_package():
    from cna_tpu.parallel.sharded import sharded_knn as tpu_sharded_knn

    x = dyadic(np.random.RandomState(0).randn(1000, 12))
    idx, dst = sharded.sharded_knn(x, 8, make_mesh(["cpu"] * 8, perms=2),
                                   key_block=256)
    ref_i, ref_d = tpu_sharded_knn(x, 8, tpu_make_mesh(cells=4, perms=2),
                                   key_block=256)
    assert idx.dtype == np.int32 and idx.shape == (1000, 8)
    # the port's self distance is exactly 0 and its own id first
    assert (idx[:, 0] == np.arange(1000)).all() and (dst[:, 0] == 0).all()
    np.testing.assert_array_equal(idx, ref_i)
    np.testing.assert_allclose(dst, ref_d, rtol=1e-12, atol=1e-12)


def test_make_mesh_shapes_and_errors():
    mesh = make_mesh(["cpu"] * 8, perms=2)
    assert mesh.shape == {"cells": 4, "perms": 2}
    assert mesh.devices.shape == (4, 2) and not mesh.multiprocess
    assert make_mesh(["cpu"] * 8, cells=3, perms=2).shape == {
        "cells": 3, "perms": 2}
    with pytest.raises(ValueError, match="not divisible by perms=3"):
        make_mesh(["cpu"] * 8, perms=3)
    with pytest.raises(ValueError, match="needs 9 devices, have 8"):
        make_mesh(["cpu"] * 8, cells=3, perms=3)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="none is available"):
            make_mesh()
    # without a process group the global mesh is this process's slots
    assert launch.global_mesh(perms=2, local_devices=["cpu"] * 4).shape == {
        "cells": 2, "perms": 2}


def test_sharded_values_gather_and_sum():
    mesh = make_mesh(["cpu"] * 6, perms=2)
    x = torch.arange(7 * 5, dtype=torch.float64).reshape(7, 5)
    for spec in (ct.parallel.mesh.cell_rows(mesh),
                 ct.parallel.mesh.perm_cols(mesh),
                 ct.parallel.mesh.cell_by_perm(mesh)):
        placed = ct.parallel.mesh.place(x, spec)
        np.testing.assert_array_equal(np.asarray(placed), x.numpy())
    total = dist.psum(mesh, [torch.ones(3)] * 4, (3,), torch.float32)
    np.testing.assert_array_equal(total.numpy(), 4.0)


def test_assert_agreement_single_process():
    launch.assert_agreement(np.arange(10.0), "arange")  # no-op pass


def test_assert_agreement_detects_divergence():
    rows = np.stack([launch._digest(np.arange(10.0)),
                     launch._digest(np.arange(10.0) + 1e-3)])
    with pytest.raises(RuntimeError, match="process 1"):
        launch._check_digest_rows(rows, "nam_checksum", atol=0.0)
    # float32 reduction-order noise admitted via atol
    launch._check_digest_rows(rows, "nam_checksum", atol=1.0)


def test_assert_agreement_names_nan():
    with pytest.raises(RuntimeError, match="contains NaN"):
        launch.assert_agreement(np.array([1.0, np.nan]), "ncorrs")


def test_partition_keeps_shards_connected(port_demo):
    """The graph-grown partition's shard blocks hold fewer cross-shard
    edges than equal blocks of the input order (on this expander-like
    archetype data, 0.65 of them)."""
    from cna_tpu_torch.graph.partition import partition_ordering
    from cna_tpu_torch.graph.reorder import permute_graph

    conn = port_demo.obsp["connectivities"].tocsr()
    order = partition_ordering(conn, port_demo.obsm["X_pca"], 4)

    def cross(a):
        coo = a.tocoo()
        nd = -(-a.shape[0] // 4)
        return int(np.sum(coo.row // nd != coo.col // nd))

    assert cross(permute_graph(conn, order)) < 0.8 * cross(conn)
    pd.testing.assert_index_equal(pd.Index(np.sort(order.perm)),
                                  pd.RangeIndex(conn.shape[0]))


def test_association_step_equals_single_device(hub_graph):
    """The whole-pipeline step across the mesh (row-sharded diffusion,
    stopping statistic, perms-sharded min-p, null-coefficient tiles)
    against the same step on one device."""
    from cna_tpu_torch.ops import ftest, moments

    rng = np.random.default_rng(6)
    g = from_scipy(hub_graph, width_percentile=90.0)
    n_cells, n, nnull = hub_graph.shape[0], 12, 10
    s = torch.from_numpy(rng.random((n_cells, n)))
    c_counts = torch.from_numpy(rng.integers(50, 200, n).astype(float))
    u = torch.linalg.qr(torch.from_numpy(rng.standard_normal((n, 4))))[0]
    m_proj = torch.eye(n, dtype=torch.float64)
    y_cols = torch.from_numpy(rng.standard_normal((n, nnull)))
    ks = torch.tensor([1, 2, 3])
    colsums = g.colsums(1.0)
    mesh = make_mesh(["cpu"] * 6, perms=2)
    s_new, medkurt, minps, nullnc = sharded.association_step(
        s, sharded.shard_graph(g, mesh), colsums, 1.0, c_counts, u, m_proj,
        y_cols, ks, 0, mesh)

    ref = spmm.diffusion_step(s, g, colsums, 1.0)
    snormed = ref / c_counts[None, :]
    nam = snormed - snormed.mean(dim=0, keepdim=True)
    z = moments.scale_by_std(m_proj @ y_cols, ddof=1, axis=0)
    np.testing.assert_allclose(np.asarray(s_new), ref.numpy(),
                               rtol=STEP_RTOL, atol=STEP_ATOL)
    np.testing.assert_allclose(
        float(medkurt),
        float(moments.median(moments.kurtosis(snormed, axis=1))), rtol=1e-12)
    np.testing.assert_allclose(
        minps.numpy(), ftest.minp_stats_batch(u, m_proj, y_cols, ks, 0)[1],
        rtol=1e-12)
    np.testing.assert_allclose(nullnc.numpy(),
                               (torch.abs(nam @ z) / n_cells).numpy(),
                               rtol=1e-12, atol=1e-15)
