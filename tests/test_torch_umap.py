"""cna_tpu_torch.pp.umap and cna_tpu_torch.pl against cna_tpu on the CPU.

The graph is the one ``cna_tpu`` builds for a demo-sized dataset (20
samples x 100 cells, 50 genes), handed to the port as a scipy matrix.
The host parts (``_fit_ab``, ``spectral_init``), the edges and the period
groups must be equal; the epochs are compared under the TPU package's own
negative-sample draws (made here with JAX, through the port's private
``_draws``), within the reference's own float32 rounding error, which is
measured against the reference's epochs run in float64.
"""

import importlib

import jax
import jax.numpy as jnp
import matplotlib
import numpy as np
import pandas as pd
import pytest
import scipy.sparse as sp
import torch

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402

import cna_tpu  # noqa: E402
import cna_tpu_torch as ct  # noqa: E402

from .fixtures import make_demo_dataset  # noqa: E402
from .torch_parity import torch_cpu_x64  # noqa: E402,F401

TPU = importlib.import_module("cna_tpu.pp.umap")
PORT = importlib.import_module("cna_tpu_torch.pp.umap")
R = 5  # negative_sample_rate


@pytest.fixture(scope="module")
def demo_graph():
    d, samplem = make_demo_dataset(n_samples=20, cells_per_sample=100)
    return d, samplem


def _port_data(d):
    return ct.CellData(obs=d.obs.copy(),
                       obsm={"X_pca": np.asarray(d.obsm["X_pca"])},
                       obsp={"connectivities": d.obsp["connectivities"],
                             "distances": d.obsp["distances"]})


def _tpu_edges(conn, n_epochs):
    """The TPU package's edge preparation (``pp/umap.py:341-354``)."""
    coo = sp.coo_matrix(sp.triu(conn, k=1) + sp.triu(conn.T, k=1))
    coo.sum_duplicates()
    w = coo.data.astype(np.float32)
    w = np.where(w < w.max() / float(n_epochs), 0.0, w)
    keep = w > 0
    return (coo.row[keep].astype(np.int32), coo.col[keep].astype(np.int32),
            w.max() / w[keep])


def _assert_groups_equal(tpu_groups, port_groups, n):
    """Array for array, once the TPU package's dummy edges are taken out:
    they sit at the end of each padded group and their keys (the sentinel
    row n) sort last, so ``ord`` keeps its real entries in order with
    positions renumbered, and ``bounds`` loses the sentinel's end."""
    assert [g["period"] for g in tpu_groups] \
        == [g["period"] for g in port_groups]
    for g, h in zip(tpu_groups, port_groups):
        e_g, e_pad = h["heads"].shape[0], len(g["heads"])
        np.testing.assert_array_equal(g["heads"][:e_g], h["heads"].numpy())
        np.testing.assert_array_equal(g["tails"][:e_g], h["tails"].numpy())
        assert (g["heads"][e_g:] == n).all() and (g["tails"][e_g:] == n).all()
        real = g["ord"][:3 * e_g]
        assert (real % e_pad < e_g).all()
        np.testing.assert_array_equal(
            (real // e_pad) * e_g + real % e_pad, h["ord"].numpy())
        np.testing.assert_array_equal(g["bounds"][:n + 1],
                                      h["bounds"].numpy())


def test_fit_ab_and_spectral_init_equal_the_tpu_package(demo_graph):
    d, _ = demo_graph
    assert PORT._fit_ab() == TPU._fit_ab()
    assert PORT._fit_ab(spread=2.0, min_dist=0.3) \
        == TPU._fit_ab(spread=2.0, min_dist=0.3)
    conn = d.obsp["connectivities"]
    emb, mode = PORT.spectral_init(conn, seed=3)
    ref, ref_mode = TPU.spectral_init(conn, seed=3)
    assert mode == ref_mode == "spectral"
    np.testing.assert_array_equal(emb, ref)


@pytest.mark.parametrize("n_epochs", [5, 200])
def test_edges_and_period_structure_equal_the_tpu_package(demo_graph,
                                                         n_epochs):
    d, _ = demo_graph
    conn = d.obsp["connectivities"]
    n = conn.shape[0]
    heads, tails, eps_edge = _tpu_edges(conn, n_epochs)
    h, t, e = PORT._umap_edges(conn, n_epochs)
    np.testing.assert_array_equal(h.numpy(), heads)
    np.testing.assert_array_equal(t.numpy(), tails)
    assert e.dtype == torch.float32
    np.testing.assert_array_equal(e.numpy(), eps_edge)
    _assert_groups_equal(TPU._period_structure(heads, tails, eps_edge, n),
                         PORT._period_structure(h, t, e, n), n)


def test_device_graph_edges_equal_its_csr():
    """A ``DeviceConnectivities`` (the IVF branch, on the CPU) gives the
    edges its own ``tocsr()`` gives through the TPU package's host path."""
    d, _ = ct.data.synthetic_dataset(n_samples=12, cells_per_sample=60,
                                     n_genes=20, seed=2, dtype=np.float64)
    ct.pp.pca(d, n_comps=10)
    ct.pp.neighbors(d, n_neighbors=10, method="ivf")
    conn = d.obsp["connectivities"]
    assert type(conn).__name__ == "DeviceConnectivities"
    assert conn.ordering is not None  # compact order differs from cells'
    n = d.n_obs
    h, t, e = PORT._umap_edges(conn, 200)
    assert conn._csr is None  # built without a host copy
    heads, tails, eps_edge = _tpu_edges(conn.tocsr(), 200)
    np.testing.assert_array_equal(h.numpy(), heads)
    np.testing.assert_array_equal(t.numpy(), tails)
    np.testing.assert_array_equal(e.numpy(), eps_edge)
    _assert_groups_equal(TPU._period_structure(heads, tails, eps_edge, n),
                         PORT._period_structure(h, t, e, n), n)


def _jax_draws(groups, n_epochs, n_windows, seed=0):
    """The TPU package's window draws: one key split per (epoch, group),
    due or not, and ``randint`` over the padded group
    (``pp/umap.py:275-292``); the port's groups are the first e_g."""
    key = jax.random.key(seed)
    out = {}
    for i in range(n_epochs):
        for gi, g in enumerate(groups):
            key, sub = jax.random.split(key)
            out[i, gi] = np.array(jax.random.randint(
                sub, (len(g["heads"]),), 0, n_windows))

    def draws(epoch, group, e_g, nw):
        assert nw == n_windows
        return torch.as_tensor(out[epoch, group][:e_g]).long()

    return draws


def test_positions_match_under_the_tpu_packages_draws(demo_graph):
    """Five epochs through both public ``umap``s, the port fed JAX's own
    window draws.  The tolerance is the reference's own float32 rounding:
    its epochs run again in float64 (same init, schedule and draws) give
    ``ref_err``, how far its float32 positions are from exact arithmetic.
    The port must be no further than that from the float64 run (its row
    sums are sequential where the reference's come from one float32
    cumulative sum), and so within 2 * ref_err of the reference."""
    d, _ = demo_graph
    n_epochs = 5
    conn = d.obsp["connectivities"]
    n = conn.shape[0]
    heads, tails, eps_edge = _tpu_edges(conn, n_epochs)
    groups = TPU._period_structure(heads, tails, eps_edge, n)
    draws = _jax_draws(groups, n_epochs, n // R)

    ref32 = cna_tpu.pp.umap(d, n_epochs=n_epochs, seed=0)
    pd_ = _port_data(d)
    port32 = ct.pp.umap(pd_, n_epochs=n_epochs, seed=0, _draws=draws)
    assert pd_.uns["umap"] == d.uns["umap"]

    a, b = TPU._fit_ab()
    pos0, _ = TPU.spectral_init(conn, seed=0)
    ref64 = np.asarray(TPU._optimize_layout(
        jnp.asarray(pos0, jnp.float64), jnp.asarray(heads),
        jnp.asarray(tails), jnp.asarray(eps_edge), jax.random.key(0), a, b,
        n_epochs=n_epochs, negative_sample_rate=R))
    ref_err = np.abs(ref32 - ref64).max()
    port_err = np.abs(port32 - ref64).max()
    print(f"\n5 epochs from float64: the port {port_err}, the reference "
          f"{ref_err}; port to reference {np.abs(port32 - ref32).max()}")
    assert 0 < ref_err < 1.0  # positions span about +-25
    assert port_err <= ref_err, (port_err, ref_err)
    assert np.abs(port32 - ref32).max() <= 2 * ref_err


def _neighbor_to_random_ratio(emb, knn, sample, rng):
    """tests/test_umap.py's quality measure: mean 2-D distance of sampled
    cells to their kNN neighbours over that to random cells."""
    n = emb.shape[0]
    num, den = [], []
    for i in sample:
        nbrs = knn.indices[knn.indptr[i]:knn.indptr[i + 1]]
        rand = rng.randint(0, n, len(nbrs))
        num.append(np.linalg.norm(emb[nbrs] - emb[i], axis=1).mean())
        den.append(np.linalg.norm(emb[rand] - emb[i], axis=1).mean())
    return np.mean(num) / np.mean(den)


def test_layout_quality_and_ratio_match_the_tpu_package(demo_graph):
    """Its own generator: the port passes ``tests/test_umap.py``'s quality
    bar, and its ratio lies within 0.05 of the TPU package's on the same
    graph and init (the two random streams differ)."""
    d, _ = demo_graph
    pd_ = _port_data(d)
    emb = ct.pp.umap(pd_, n_epochs=100, seed=0)
    ref = cna_tpu.pp.umap(d, n_epochs=100, seed=0)
    assert emb.shape == (d.n_obs, 2) and emb.dtype == np.float32
    assert np.isfinite(emb).all()
    knn = d.obsp["distances"]
    rng = np.random.RandomState(0)
    sample = rng.choice(d.n_obs, 500, replace=False)
    ratio = _neighbor_to_random_ratio(emb, knn, sample,
                                      np.random.RandomState(1))
    ratio_ref = _neighbor_to_random_ratio(ref, knn, sample,
                                          np.random.RandomState(1))
    ratio_null = _neighbor_to_random_ratio(emb[rng.permutation(d.n_obs)],
                                           knn, sample,
                                           np.random.RandomState(1))
    assert ratio < 0.35 and ratio_null > 0.8 and ratio < ratio_null / 2
    assert abs(ratio - ratio_ref) < 0.05, (ratio, ratio_ref)


def test_same_seed_same_layout_and_too_few_cells_raise(demo_graph):
    d, _ = demo_graph
    pd_ = _port_data(d)
    e1 = ct.pp.umap(pd_, n_epochs=20, seed=7)
    e2 = ct.pp.umap(pd_, n_epochs=20, seed=7)
    e3 = ct.pp.umap(pd_, n_epochs=20, seed=8)
    np.testing.assert_array_equal(e1, e2)
    assert not np.array_equal(e1, e3)
    tiny = ct.CellData(X=np.eye(4), obsp={
        "connectivities": sp.csr_matrix(np.ones((4, 4)) - np.eye(4))})
    with pytest.raises(ValueError, match="negative_sample_rate=5"):
        ct.pp.umap(tiny, n_epochs=10)
    with pytest.raises(KeyError, match="pp.neighbors"):
        ct.pp.umap(ct.CellData(X=np.eye(6)))


@pytest.fixture(scope="module")
def plotted():
    """The port's own association and layout on the demo graph (its own
    pipeline on the CPU), with a stratum column."""
    d, samplem = make_demo_dataset(n_samples=20, cells_per_sample=100)
    pd_ = _port_data(d)
    pd_.obs["stratum"] = np.where(pd_.obs["case"] > 0, "case", "control")
    ct.tl.association(pd_, samplem["case"].astype(float), "id", Nnull=200,
                      seed=0)
    ct.pp.umap(pd_, n_epochs=30, seed=0)
    return pd_


def _draw(fn, data, *args, **kwargs):
    fig, ax = plt.subplots()
    try:
        fn(data, *args, ax=ax, **kwargs)
        fig.canvas.draw()
        out = [(type(c).__name__, np.asarray(c.get_offsets()),
                c.get_clim() if c.get_array() is not None else None,
                [p.vertices.copy() for p in c.get_paths()]
                if type(c).__name__ == "PolyCollection" else None,
                np.asarray(c.get_facecolor()))
               for c in ax.collections]
        return out, (ax.get_xlim(), ax.get_ylim(), ax.get_xlabel(),
                     ax.get_ylabel())
    finally:
        plt.close(fig)


def _assert_same_drawing(a, b):
    cols_a, axes_a = a
    cols_b, axes_b = b
    assert axes_a == axes_b and len(cols_a) == len(cols_b)
    for ca, cb in zip(cols_a, cols_b):
        assert ca[0] == cb[0]
        np.testing.assert_array_equal(ca[1], cb[1])
        assert ca[2] == cb[2]
        if ca[3] is not None:
            assert len(ca[3]) == len(cb[3])
            for pa, pb in zip(ca[3], cb[3]):
                np.testing.assert_array_equal(pa, pb)
        np.testing.assert_array_equal(ca[4], cb[4])


@pytest.mark.parametrize("plot", ["umap_ncorr", "umap_overlay",
                                  "violinplot"])
def test_plots_draw_what_the_tpu_package_draws(plotted, plot):
    d = plotted
    args = {"umap_ncorr": (), "umap_overlay": (d.obs["coef"] > 0, "coef"),
            "violinplot": ("stratum",)}[plot]
    ours = _draw(getattr(ct.pl, plot), d, *args)
    theirs = _draw(getattr(cna_tpu.pl, plot), d, *args)
    assert ours[0], "nothing was drawn"
    _assert_same_drawing(ours, theirs)
    if plot == "umap_ncorr":  # the overlay's colour limits are symmetric
        passed = d.obs["coef_fdr"] <= 0.1
        if passed.any():
            lim = np.abs(d.obs["coef"][passed]).max()
            assert ours[0][1][2] == (-lim, lim)
