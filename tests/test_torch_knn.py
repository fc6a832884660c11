"""cna_tpu_torch's exact kNN (``ops.knn``, ``pp.knn``) against cna_tpu's.

The CUDA kernel runs only on a card; here its plain version (what a CPU
tensor takes) is held to the Pallas kernel of cna_tpu in interpret mode,
and ``pp.knn.knn_search`` to cna_tpu's blocked search.  The kernel's TF32
candidate filter is emulated in torch and held to the plain version on
inputs chosen against it.  The kernel itself is held to its plain version
on the card by ``test_torch_card.py`` (no JAX there) and by
``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

from cna_tpu.ops.knn_pallas import knn_pallas
from cna_tpu.pp.knn import knn_search as tpu_knn_search
from cna_tpu_torch import config
from cna_tpu_torch.ops import _build, _dist_tile
from cna_tpu_torch.ops import ivf as ivf_ops
from cna_tpu_torch.ops import knn as knn_ops
from cna_tpu_torch.pp.knn import knn_device, knn_search, resolve_method

from .test_torch_ivf import _filter_threshold, _tf32
from .torch_parity import brute_knn, torch_cpu_x64  # noqa: F401

# float32 squared distances: the Pallas kernel sums |q|^2+|x|^2-2q.x, the
# plain version sum((q-x)^2), so they differ by rounding (the tolerance of
# tests/test_knn_pallas.py)
F32_DIST_ATOL = 1e-3
SHAPES = [(700, 20, 10), (300, 7, 5), (1025, 40, 16)]


def _recall(a, b):
    k = a.shape[1]
    return np.mean([len(set(a[i]) & set(b[i])) / k for i in range(len(a))])


@pytest.mark.parametrize("n,d,k", SHAPES)
def test_plain_matches_pallas_kernel(n, d, k):
    x = np.random.RandomState(0).randn(n, d).astype(np.float32)
    negd, idx = knn_pallas(x, k, q_tile=128, block=256, interpret=True)
    negd, idx = np.asarray(negd), np.asarray(idx)
    pn, pi = knn_ops.knn_exact(torch.from_numpy(x), k)
    assert pn.dtype == torch.float32 and pi.dtype == torch.int32
    pn, pi = pn.numpy(), pi.numpy()

    assert (pi[:, 0] == np.arange(n)).all()  # self first
    assert (pn[:, 0] == 0).all()  # exact self distance
    assert np.allclose(pn, negd, atol=F32_DIST_ATOL)
    assert _recall(pi, idx) == 1.0
    assert (np.diff(-pn, axis=1) >= 0).all()  # ascending distances
    ref_idx, ref_d = brute_knn(x.astype(np.float64), k)
    assert np.allclose(-pn, ref_d, atol=F32_DIST_ATOL)
    assert _recall(pi, ref_idx) == 1.0


def test_wrapper_checks_and_limits():
    x = torch.randn(50, 4)
    before = _build.launch_counts().get(knn_ops.KERNEL, 0)
    negd, idx = knn_ops.knn_exact(x, 3)
    # a CPU tensor takes the plain version and counts no launch
    assert _build.launch_counts().get(knn_ops.KERNEL, 0) == before
    ref_d, ref_i = knn_ops.knn_exact_plain(x, 3)
    assert torch.equal(negd, ref_d) and torch.equal(idx, ref_i)

    with pytest.raises(ValueError, match="k <= 128"):
        knn_ops.knn_exact(torch.randn(300, 4), 129)
    with pytest.raises(ValueError, match="D <= 128"):
        knn_ops.knn_exact(torch.randn(300, 129), 5)
    with pytest.raises(TypeError, match="float32"):
        knn_ops.knn_exact(torch.randn(30, 4, dtype=torch.float64), 3)
    with pytest.raises(ValueError, match="contiguous"):
        knn_ops.knn_exact(torch.randn(4, 30).T, 3)
    with pytest.raises(ValueError, match="exceeds"):
        knn_ops.knn_exact(torch.randn(4, 3), 5)


def test_knn_search_exact_matches_tpu_package():
    x = np.random.RandomState(3).randn(600, 12)
    ti, td = tpu_knn_search(x, 9, method="exact")
    pi, pd_ = knn_search(x, 9, method="exact", query_block=256,
                         key_block=128)
    assert pi.dtype == np.int32 and pd_.dtype == np.float64
    assert np.array_equal(pi, ti)
    # float64 matmul expansions in two libraries: rtol 1e-10 on real
    # distances
    np.testing.assert_allclose(pd_[:, 1:], td[:, 1:], rtol=1e-10)
    # the self distance: exactly 0 in the port; cna_tpu keeps the
    # expansion's rounding noise (sqrt of ~1e-15)
    assert (pd_[:, 0] == 0).all()
    assert np.abs(td[:, 0]).max() < 1e-6


def test_knn_search_pallas_and_approx_on_cpu():
    x = np.random.RandomState(4).randn(400, 6)
    ref_idx, ref_d2 = brute_knn(x, 7)
    pi, pd_ = knn_search(x, 7, method="pallas")  # plain version, float32
    assert pd_.dtype == np.float32
    assert _recall(pi, ref_idx) == 1.0
    np.testing.assert_allclose(pd_ ** 2, ref_d2, atol=F32_DIST_ATOL)
    ai, ad = knn_search(x, 7, method="approx")  # runs the exact search
    ei, ed = knn_search(x, 7, method="exact")
    assert np.array_equal(ai, ei) and np.array_equal(ad, ed)


@pytest.mark.parametrize("n,device,expect", [
    (20_000, "cpu", "exact"),
    (20_000, "cuda", "exact"),
    (20_001, "cpu", "approx"),
    (20_001, "cuda", "pallas"),
    (262_144, "cuda", "pallas"),
    (262_145, "cuda", "ivf"),
])
def test_resolve_method_auto(n, device, expect):
    assert resolve_method(n, "auto", device) == expect


def test_resolve_method_unported_and_unknown():
    # IVF is ported: 'auto' above 262,144 points and 'ivf' resolve to it
    assert resolve_method(262_145, "auto", "cuda") == "ivf"
    assert resolve_method(262_145, "auto", "cpu") == "ivf"
    assert resolve_method(1000, "ivf", "cpu") == "ivf"
    with pytest.raises(ValueError, match="unknown kNN method"):
        resolve_method(1000, "annoy", "cpu")
    assert resolve_method(10, "pallas", "cpu") == "pallas"
    with pytest.raises(ValueError, match="ivf_knn_device"):
        knn_device(torch.zeros(4, 2), 2, "ivf")


def test_knn_search_ivf_on_cpu():
    x = np.random.RandomState(5).randn(1_500, 6).astype(np.float32)
    ref_idx, _ = brute_knn(x.astype(np.float64), 8)
    idx, d = knn_search(x, 8, method="ivf")
    assert idx.dtype == np.int32 and d.dtype == np.float32
    assert (idx[:, 0] == np.arange(1_500)).all() and (d[:, 0] == 0).all()
    assert _recall(idx, ref_idx) >= 0.9


# --- the CUDA kernel's TF32 candidate filter --------------------------------
#
# knn_exact looks at a candidate exactly unless its TF32 key reaches the
# row's threshold (csrc/dist_tile.cuh).  Here the filter is emulated in torch
# as the kernel forms it: one centre for the whole launch (the mean of x in
# float32), operands centred in float32 and rounded to TF32 (by masking, or
# to nearest as `cvt.rna` does; tests/test_torch_ivf.py), products summed
# exactly onto the float32 norm term, tiles of KEY_TILE candidates in id
# order, each row's threshold taken from its running top-k at the tile's
# start.

KEY_TILE = 128  # candidates to a key tile (kTileKeys in csrc/knn_exact.cu)


def _knn_keys(x, mode):
    """(A (n, d_pad) float64, B (n, d_pad) float64, start (n,) float64,
    nq (n,) float32): the keys of row i against candidate j are
    start[j] + A[i] . B[j], as the kernel forms them."""
    n, d = x.shape
    d_pad = knn_ops.kernel_d_pad(d)
    eps, _ = knn_ops.filter_bound(d_pad)
    one_minus = torch.tensor(1.0, dtype=torch.float32) - torch.tensor(
        eps, dtype=torch.float32)
    xc = x - x.sum(0) / n  # the kernel's centre: the mean of x
    nx = (xc * xc).sum(1)
    return (_tf32(-2.0 * xc, mode).double(), _tf32(xc, mode).double(),
            (nx * one_minus).double(), nx)


def _sq_dists(q, x):
    """Direct float32 squared distances (n_q, n_x), in row blocks."""
    return torch.cat([((q[s:s + 256, None, :] - x[None, :, :]) ** 2).sum(-1)
                      for s in range(0, q.shape[0], 256)])


def _emulate_knn_filter(x, k, mode="nearest"):
    """The kernel's walk over its key tiles, emulated: returns (ids (n, k)
    int64, sq_dists (n, k) float32, share of the pairs that reached the
    exact path, and a bool (n, n) mask of the pairs that were let through
    (None above 4,096 rows))."""
    n, d = x.shape
    eps, gam = knn_ops.filter_bound(knn_ops.kernel_d_pad(d))
    a, b, start, nq = _knn_keys(x, mode)
    best_d = torch.full((n, k), float("inf"))
    best_i = torch.zeros((n, k), dtype=torch.int64)
    passed = torch.zeros((n, n), dtype=torch.bool) if n <= 4096 else None
    n_pass = 0
    for t0 in range(0, n, KEY_TILE):
        ids = torch.arange(t0, min(n, t0 + KEY_TILE))
        keys = (start[None, ids] + a @ b[ids].T).to(torch.float32)
        thr = _filter_threshold(best_d[:, -1:], nq[:, None], eps, gam)
        ok = keys < thr
        n_pass += int(ok.sum())
        if passed is not None:
            passed[:, ids] = ok
        rows = torch.nonzero(ok.any(1)).flatten()
        if len(rows) == 0:
            continue
        sub = ok[rows]
        d2 = torch.full(sub.shape, float("inf"))
        r, c = torch.nonzero(sub, as_tuple=True)
        d2[r, c] = ((x[rows[r]] - x[ids[c]]) ** 2).sum(1)
        # insertion in id order: a stable sort keeps the lower id first
        # among equal distances, and only a strictly smaller distance
        # displaces the k-th
        cat_d = torch.cat([best_d[rows], d2], 1)
        cat_i = torch.cat([best_i[rows], ids.expand(len(rows), -1)], 1)
        srt, pos = torch.sort(cat_d, dim=1, stable=True)
        best_d[rows] = srt[:, :k]
        best_i[rows] = torch.gather(cat_i, 1, pos[:, :k])
    return best_i, best_d, n_pass / (n * n), passed


def _knn_filter_data(kind, seed, n, d):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, d)
    if kind == "offset":  # norms 1e3 times the neighbour distances
        x = x + 1000.0 * rng.choice([-1.0, 1.0], d)
    elif kind == "tiny_spread":
        x = 1000.0 + 1e-3 * x
    elif kind == "duplicates":  # every point four times
        x = np.tile(x[: n // 4], (4, 1))[rng.permutation(4 * (n // 4))]
    elif kind == "identical":  # a block of identical rows
        x[100:400] = x[100]
    elif kind == "clusters":  # tight clusters far apart, rows in id order
        x = np.repeat(300.0 * rng.randn(8, d), n // 8 + 1, 0)[:n] \
            + rng.randn(n, d)
    return torch.from_numpy(x.astype(np.float32))


def _assert_same_knn(ids, d2, x, k):
    """The emulated result is knn_exact_plain's up to ties."""
    p_negd, p_idx = knn_ops.knn_exact_plain(x, k)
    kth = (-p_negd)[:, -1:]
    assert float((d2 + p_negd).abs().max()) <= 1e-5 * max(float(kth.max()),
                                                         1.0)
    same = (ids[:, :, None] == p_idx.long()[:, None, :]).any(-1)
    assert bool((same | (d2 >= kth * (1 - 1e-5))).all())


@pytest.mark.parametrize("mode", ["mask", "nearest"])
@pytest.mark.parametrize("kind,d,k", [
    ("random", 20, 15), ("random", 3, 64), ("random", 7, 1),
    ("random", 50, 128), ("random", 128, 15), ("offset", 20, 15),
    ("tiny_spread", 20, 15), ("duplicates", 20, 1), ("duplicates", 20, 15),
    ("duplicates", 20, 64), ("identical", 20, 128), ("clusters", 20, 15)])
def test_knn_filter_never_drops_a_closer_candidate(kind, d, k, mode):
    n = 700
    x = _knn_filter_data(kind, seed=d + k, n=n, d=d)
    eps, gam = knn_ops.filter_bound(knn_ops.kernel_d_pad(d))
    a, b, start, nq = _knn_keys(x, mode)
    keys = (start[None, :] + a @ b.T).to(torch.float32)
    d2 = _sq_dists(x, x)
    # every pair, at the tightest threshold it must still pass (the next
    # float32 above its own distance): the proof's statement
    tau = torch.nextafter(d2, torch.full_like(d2, float("inf")))
    thr = _filter_threshold(tau, nq[:, None], eps, gam)
    assert bool((keys < thr).all()), float((keys - thr).max())
    # the walk over the key tiles: every pair closer than the row's final
    # k-th distance was let through, and the result is the plain version's
    ids, best, share, passed = _emulate_knn_filter(x, k, mode)
    assert bool(passed[d2 < best[:, -1:]].all())
    _assert_same_knn(ids, best, x, k)
    assert 0.0 < share <= 1.0


def test_knn_filter_exact_share_on_bench_data(capsys):
    """The share of pairs that reach the exact path at a scaled-down bench
    dataset (20,000 cells, 20 PCs, k = 15): it decides whether one centre
    for the whole launch is enough (csrc/knn_exact.cu)."""
    from cna_tpu_torch import data as ct_data, pp

    d, _ = ct_data.synthetic_dataset(n_samples=10, cells_per_sample=2000,
                                     n_genes=50, seed=0)
    try:
        config.set_device("cpu")
        config.enable_x64(False)
        pp.pca(d, n_comps=20)
    finally:
        config.enable_x64(True)
    x = torch.as_tensor(np.asarray(d.obsm["X_pca"], dtype=np.float32))
    ids, best, share, _ = _emulate_knn_filter(x.contiguous(), 15)
    _assert_same_knn(ids, best, x, 15)
    with capsys.disabled():
        print(f"\nknn_exact filter, 20,000 x 20, k=15: {share:.4%} of the "
              f"pairs reach the exact path ({share * x.shape[0]:.1f} a row; "
              f"the first tile of {KEY_TILE} passes whole)")
    # one tile of 128 passes whole; the rest is about k ln(N / k)
    assert share < 0.02, share


def test_knn_and_ivf_take_the_one_filter_bound():
    assert knn_ops.filter_bound is _dist_tile.filter_bound
    assert ivf_ops.filter_bound is _dist_tile.filter_bound
    assert knn_ops.kernel_d_pad is ivf_ops.kernel_d_pad \
        is _dist_tile.kernel_d_pad
    assert ivf_ops.D_PADS is _dist_tile.D_PADS
    # the kernels share one compiled-width table and one maximum width
    assert _dist_tile.MAX_D == knn_ops.MAX_D == ivf_ops.MAX_D
    assert [knn_ops.kernel_d_pad(d) for d in (1, 20, 33, 128)] \
        == [4, 20, 48, 128]
