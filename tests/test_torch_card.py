"""The hand-written CUDA kernels against their plain versions, on the card,
and the device paths without a kernel whose results must not depend on the
device (HVG moments, the UMAP engine).

These tests need an NVIDIA card and skip without one.  This file imports
neither JAX nor cna_tpu, so it runs where the port runs; on the card's
machine (which has no JAX, while ``tests/conftest.py`` imports it):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_card.py -m gpu
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import cna_tpu_torch as ct
from cna_tpu_torch.graph.device import DeviceConnectivities
from cna_tpu_torch.ops import _build
from cna_tpu_torch.ops import ivf as ivf_ops
from cna_tpu_torch.ops import knn as knn_ops
from cna_tpu_torch.ops import spmm_banded as banded_ops

from .torch_parity import need_cuda

# float32 squared distances summed in different orders
F32_DIST_ATOL = 1e-3
# the banded kernel against its plain version, relative to max|y| (another
# summation order at the state's own precision)
BANDED_RTOL = {torch.float32: 1e-5, torch.float64: 1e-12}


@pytest.mark.gpu
@pytest.mark.parametrize("n,d,k", [(700, 20, 10), (300, 7, 5),
                                   (1025, 40, 16), (1037, 7, 5),
                                   (3000, 128, 128), (500, 1, 3)])
def test_kernel_matches_plain(n, d, k):
    need_cuda()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    x = torch.randn(n, d, generator=gen, device="cuda")
    before = _build.launch_counts().get(knn_ops.KERNEL, 0)
    negd, idx = knn_ops.knn_exact(x, k)
    torch.cuda.synchronize()
    assert _build.launch_counts()[knn_ops.KERNEL] == before + 1
    pn, _ = knn_ops.knn_exact_plain(x, k)
    rows = torch.arange(n, device="cuda", dtype=torch.int32)
    assert bool((idx[:, 0] == rows).all())
    assert bool((negd[:, 0] == 0).all())
    assert bool((torch.diff(-negd, dim=1) >= 0).all())
    assert float((negd - pn).abs().max()) <= F32_DIST_ATOL
    recomputed = ((x[idx.long()] - x[:, None, :]) ** 2).sum(-1)
    assert float((recomputed + negd).abs().max()) <= F32_DIST_ATOL


def _assert_exact_knn(x, k):
    """knn_exact on the card against its plain version: the first distance
    exactly 0 and owned by the lowest id among the row's exact copies,
    distances ascending and within 1e-4 of the row's k-th distance rank by
    rank, ids at equal distance ascending, recall 1 with ties, the ids
    carrying their distances, one launch, and the same bits twice."""
    n = x.shape[0]
    before = _build.launch_counts().get(knn_ops.KERNEL, 0)
    stats = torch.zeros(knn_ops.N_STATS, dtype=torch.int64, device="cuda")
    negd, idx = knn_ops.knn_exact(x, k, stats=stats)
    torch.cuda.synchronize()
    assert _build.launch_counts()[knn_ops.KERNEL] == before + 1
    assert int(stats[1]) == n * n and 0 < int(stats[0]) <= n * n
    pn, pi = knn_ops.knn_exact_plain(x, k)
    dk, dp = -negd, -pn
    assert bool((dk[:, 0] == 0).all())
    _, group = torch.unique(x, dim=0, return_inverse=True)
    rows = torch.arange(n, device="cuda")
    first = torch.full((n,), n, device="cuda").scatter_reduce(
        0, group, rows, reduce="amin")
    assert bool((idx[:, 0].long() == first[group]).all())
    assert bool((torch.diff(dk, dim=1) >= 0).all())
    tied = dk[:, 1:] == dk[:, :-1]
    assert bool((idx[:, 1:] > idx[:, :-1])[tied].all())
    kth = dp[:, -1:]
    err = torch.where(kth > 0, (dk - dp).abs() / kth.clamp(min=1e-30),
                      (dk - dp).abs())
    assert float(err.max()) <= 1e-4
    same = (idx.long()[:, :, None] == pi.long()[:, None, :]).any(-1)
    assert bool((same | (dk >= kth * (1 - 1e-4))).all())
    recomputed = ((x[idx.long()] - x[:, None, :]) ** 2).sum(-1)
    assert float(torch.where(kth > 0, (recomputed - dk).abs()
                             / kth.clamp(min=1e-30),
                             (recomputed - dk).abs()).max()) <= 1e-4
    again = knn_ops.knn_exact(x, k)
    assert torch.equal(again[0], negd) and torch.equal(again[1], idx)


@pytest.mark.gpu
@pytest.mark.parametrize("d", [3, 8, 12, 16, 20, 24, 28, 32, 40, 64, 96, 128])
@pytest.mark.parametrize("k", [1, 15, 64, 128])
def test_knn_exact_every_width_and_k(d, k):
    """Every compiled width, both homes of the top-k (registers up to 16,
    the heap beyond), N not a multiple of the 128 rows of a block."""
    need_cuda()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(d * 1000 + k)
    _assert_exact_knn(torch.randn(1_501, d, generator=gen, device="cuda"), k)


@pytest.mark.gpu
@pytest.mark.parametrize("attack", ["offset", "tiny_spread", "duplicates",
                                    "identical", "clusters"])
@pytest.mark.parametrize("k", [1, 15, 64, 128])
def test_knn_exact_filter_attacks(attack, k):
    """Inputs chosen against the TF32 candidate filter: a common offset a
    thousand times the spread, the same with a spread float32 barely
    resolves, every point four times, a block of 300 identical rows (more
    than a thread block's rows), and tight clusters far apart."""
    need_cuda()
    n, d = 2_000, 20
    gen = torch.Generator(device="cuda")
    gen.manual_seed(k)
    x = torch.randn(n, d, generator=gen, device="cuda")
    if attack == "offset":
        x = x + 1000.0
    elif attack == "tiny_spread":
        x = x * 1e-3 + 1000.0
    elif attack == "duplicates":
        x = x[: n // 4].repeat(4, 1)[torch.randperm(n, generator=gen,
                                                     device="cuda")]
    elif attack == "identical":
        x[100:400] = x[100]
    else:
        x = x + 300.0 * torch.randn(8, d, generator=gen, device="cuda"
                                    ).repeat_interleave(n // 8, 0)
    _assert_exact_knn(x.contiguous(), k)


@pytest.mark.gpu
def test_kernel_rejects_what_it_cannot_take():
    need_cuda()
    with pytest.raises(ValueError, match="D <= 128"):
        knn_ops.knn_exact(torch.randn(300, 129, device="cuda"), 5)
    with pytest.raises(ValueError, match="k <= 128"):
        knn_ops.knn_exact(torch.randn(300, 4, device="cuda"), 129)
    with pytest.raises(TypeError, match="float32"):
        knn_ops.knn_exact(torch.randn(30, 4, device="cuda",
                                      dtype=torch.float64), 3)
    with pytest.raises(ValueError, match="stats"):
        knn_ops.knn_exact(torch.randn(30, 4, device="cuda"), 3,
                          stats=torch.zeros(2, dtype=torch.int64,
                                            device="cuda"))


def _random_layout(f_pad, g, d, n_dummy, min_count=1):
    gen = torch.Generator(device="cuda")
    gen.manual_seed(f_pad + g + d)
    x4 = torch.randn(f_pad, g, ivf_ops.kernel_d_pad(d), generator=gen,
                     device="cuda")
    x4[:, :, d:] = 0.0
    counts = torch.randint(min_count, g + 1, (f_pad,), generator=gen,
                           device="cuda", dtype=torch.int32)
    counts[f_pad - n_dummy:] = 0
    csum = (torch.cumsum(counts, 0) - counts).to(torch.int32)
    return gen, x4, counts, csum


@pytest.mark.gpu
@pytest.mark.parametrize("f_pad,g,d,q_blocks,n_probe,k", [
    (64, 128, 20, 1, 32, 15), (64, 64, 12, 4, 32, 10),
    (96, 128, 33, 1, 48, 64), (32, 32, 3, 2, 16, 5),
    (48, 128, 128, 1, 16, 128), (40, 8, 5, 1, 16, 3)])
def test_ivf_score_matches_plain(f_pad, g, d, q_blocks, n_probe, k):
    need_cuda()
    gen, x4, counts, csum = _random_layout(f_pad, g, d, n_dummy=8)
    ns = f_pad // q_blocks
    sel = torch.randperm(ns, generator=gen, device="cuda")[:ns // 2 + 1].to(
        torch.int32)
    probes = torch.stack([
        torch.randperm(f_pad, generator=gen, device="cuda")[:n_probe]
        for _ in range(len(sel))]).to(torch.int32)
    args = (x4, sel, probes, counts, csum, k)
    before = _build.launch_counts().get(ivf_ops.KERNEL, 0)
    negd, idx = ivf_ops.score_blocks(*args, g=g, q_blocks=q_blocks)
    torch.cuda.synchronize()
    assert _build.launch_counts()[ivf_ops.KERNEL] == before + 1
    pn, pi = ivf_ops.score_blocks_plain(*args, g=g, q_blocks=q_blocks)
    found = torch.isfinite(pn)
    assert bool((torch.isfinite(negd) == found).all())
    assert bool((idx[~found] == 0).all())
    err = torch.where(found, negd - pn, 0.0).abs() / torch.clamp(-pn, min=1.0)
    assert float(err.max()) <= F32_DIST_ATOL
    # same ids wherever the plain version's distances are not tied
    gap = torch.diff(torch.where(found, -pn, float("inf")), dim=2)
    untied = torch.ones_like(found)
    untied[..., 1:] &= ~(gap <= F32_DIST_ATOL)
    untied[..., :-1] &= ~(gap <= F32_DIST_ATOL)
    assert bool((idx == pi)[found & untied].all())
    # the same launch again: bit for bit the same
    again = ivf_ops.score_blocks(*args, g=g, q_blocks=q_blocks)
    assert torch.equal(again[0], negd) and torch.equal(again[1], idx)


def _assert_exact_topk(args, g, k):
    """The kernel's sorted distances equal the plain version's rank by rank
    (1e-4 of the row's k-th distance: both sum (q - x)^2 in float32), every
    row that probes its own block is at distance exactly 0 from itself, and
    a second launch gives the same bits."""
    negd, idx = ivf_ops.score_blocks(*args, k, g=g)
    torch.cuda.synchronize()
    pn, _ = ivf_ops.score_blocks_plain(*args, k, g=g)
    found = torch.isfinite(pn)
    assert bool((torch.isfinite(negd) == found).all())
    assert bool((idx[~found] == 0).all())
    dk, dp = torch.where(found, -negd, 0.0), torch.where(found, -pn, 0.0)
    scale = dp.amax(-1, keepdim=True)
    err = torch.where(scale > 0, (dk - dp).abs() / scale.clamp(min=1e-30),
                      (dk - dp).abs())
    assert float(err.max()) <= 1e-4
    again = ivf_ops.score_blocks(*args, k, g=g)
    assert torch.equal(again[0], negd) and torch.equal(again[1], idx)
    return negd, idx


@pytest.mark.gpu
@pytest.mark.parametrize("d", [3, 8, 12, 16, 20, 24, 28, 32, 40, 64, 96, 128])
@pytest.mark.parametrize("g,k", [(128, 1), (128, 15), (64, 64), (128, 128)])
def test_ivf_score_every_width_and_k(d, g, k):
    need_cuda()
    assert ivf_ops.kernel_d_pad(d) in ivf_ops.D_PADS
    gen, x4, counts, csum = _random_layout(48, g, d, n_dummy=4)
    sel = torch.arange(12, device="cuda", dtype=torch.int32)
    probes = torch.stack([
        torch.randperm(48, generator=gen, device="cuda")[:16]
        for _ in range(12)]).to(torch.int32)
    probes[:, 0] = sel  # every slot probes itself
    negd, idx = _assert_exact_topk((x4, sel, probes, counts, csum), g, k)
    live = (torch.arange(g, device="cuda")[None, :]
            < counts[sel.long()][:, None])
    assert bool((negd[..., 0][live] == 0).all())


@pytest.mark.gpu
@pytest.mark.parametrize("attack", ["offset", "tiny_spread", "far_centres",
                                    "duplicates", "identical_blocks"])
@pytest.mark.parametrize("g,k", [(128, 1), (128, 15), (64, 64), (128, 128)])
def test_ivf_score_filter_attacks(attack, g, k):
    """Inputs chosen against the TF32 candidate filter: a common offset a
    thousand times the spread, the same with a spread float32 barely
    resolves, local blocks around far-apart centres, every point four
    times, and blocks of identical rows."""
    need_cuda()
    d, f_pad = 20, 64
    gen, x4, counts, csum = _random_layout(f_pad, g, d, n_dummy=4,
                                           min_count=g // 3)
    if attack == "offset":
        x4[:, :, :d] += 1000.0
    elif attack == "tiny_spread":
        x4[:, :, :d] = x4[:, :, :d] * 1e-3 + 1000.0
    elif attack == "far_centres":
        x4[:, :, :d] += 500.0 * torch.randn(f_pad, 1, d, generator=gen,
                                            device="cuda")
    elif attack == "duplicates":
        flat = x4.reshape(-1, x4.shape[2])
        quarter = flat.shape[0] // 4
        perm = torch.randperm(flat.shape[0], generator=gen, device="cuda")
        for rep in range(1, 4):
            flat[perm[rep * quarter:(rep + 1) * quarter]] = \
                flat[perm[:quarter]]
    else:
        x4[0] = x4[0, :1]
        x4[1] = x4[0, :1]
        x4[2] = x4[2, :1]
    ns = 24
    sel = torch.arange(ns, device="cuda", dtype=torch.int32)
    probes = torch.stack([
        torch.randperm(f_pad - 4, generator=gen, device="cuda")[:32]
        for _ in range(ns)]).to(torch.int32)
    probes[:, 0] = sel
    probes[:, 1:4] = torch.arange(3, device="cuda", dtype=torch.int32)
    negd, _ = _assert_exact_topk((x4, sel, probes, counts, csum), g, k)
    live = (torch.arange(g, device="cuda")[None, :]
            < counts[sel.long()][:, None])
    assert bool((negd[..., 0][live] == 0).all())


@pytest.mark.gpu
def test_ivf_score_rejects_what_it_cannot_take():
    need_cuda()
    _, x4, counts, csum = _random_layout(32, 64, 5, n_dummy=2)
    sel = torch.arange(4, device="cuda", dtype=torch.int32)
    probes = torch.zeros((4, 16), device="cuda", dtype=torch.int32)
    with pytest.raises(ValueError, match="k <= 128"):
        ivf_ops.score_blocks(x4, sel, probes, counts, csum, 129, g=64)
    with pytest.raises(ValueError, match="multiple of 16"):
        ivf_ops.score_blocks(x4, sel, probes[:, :8].contiguous(), counts,
                             csum, 5, g=64)
    with pytest.raises(ValueError, match="is on"):
        ivf_ops.score_blocks(x4, sel.cpu(), probes, counts, csum, 5, g=64)


@pytest.mark.gpu
def test_ivf_neighbors_on_the_card_go_through_the_kernel():
    need_cuda()
    try:
        ct.config.set_device("cuda")
        ct.config.enable_x64(False)
        d, samplem = ct.data.synthetic_dataset(
            n_samples=20, cells_per_sample=1500, n_genes=20, seed=2)
        ct.pp.pca(d, n_comps=10)
        ct.ops.reset_launch_counts()
        ct.pp.neighbors(d, n_neighbors=15, method="ivf")
        assert ct.ops.launch_counts().get(ivf_ops.KERNEL, 0) >= 1
        assert knn_ops.KERNEL not in ct.ops.launch_counts()
        conn = d.obsp["connectivities"]
        assert isinstance(conn, DeviceConnectivities)
        assert conn.ell.device.type == "cuda"
        assert d.uns["neighbors"]["ivf"]["verify_recall"] >= 0.9
        # the same index twice: k-means has no atomics, so the same graph
        first = conn.tocsr()
        ct.pp.neighbors(d, n_neighbors=15, method="ivf")
        assert abs(first - d.obsp["connectivities"].tocsr()).max() == 0
        p = ct.tl.association(d, samplem["case"].astype(float), "id",
                              Nnull=200, seed=0)
        assert 0 < p <= 1
    finally:
        ct.config.set_device("cpu")
        ct.config.enable_x64(True)


@pytest.mark.gpu
def test_neighbors_on_the_card_goes_through_the_kernel():
    need_cuda()
    try:
        ct.config.set_device("cuda")
        ct.config.enable_x64(False)
        d, _ = ct.data.synthetic_dataset(n_samples=21, cells_per_sample=1000,
                                         n_genes=20, seed=2)
        ct.pp.pca(d, n_comps=10)
        ct.ops.reset_launch_counts()
        ct.pp.neighbors(d, n_neighbors=15)
        assert ct.ops.launch_counts() == {knn_ops.KERNEL: 1}
        params = d.uns["neighbors"]["params"]
        assert params["knn_method_resolved"] == "pallas"
        # on the card every method takes the device-resident graph branch
        conn = d.obsp["connectivities"]
        assert isinstance(conn, DeviceConnectivities)
        assert conn.ordering is None and conn.ell.device.type == "cuda"
        csr = conn.tocsr()
        assert abs(csr - csr.T).max() == 0
    finally:
        ct.config.set_device("cpu")
        ct.config.enable_x64(True)


def _banded_matrix(n, k, band, seed, far=0.05):
    rng = np.random.RandomState(seed)
    rows = np.repeat(np.arange(n), k)
    cols = np.clip(rows + rng.randint(-band, band + 1, n * k), 0, n - 1)
    n_far = int(n * k * far)
    rows = np.concatenate([rows, rng.randint(0, n, n_far)])
    cols = np.concatenate([cols, rng.randint(0, n, n_far)])
    keep = rows != cols
    a = sp.csr_matrix((rng.rand(int(keep.sum())) + 0.1,
                       (rows[keep], cols[keep])), shape=(n, n))
    return (a + a.T).tocsr()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n,s,row_tile,window", [
    (5000, 50, 256, 512), (5000, 1, 256, 512), (5000, 7, 256, 512),
    (3000, 200, 256, 512), (1000, 20, 256, 512), (777, 33, 64, 16),
    (600, 12, 128, 128)])
def test_banded_kernel_matches_plain(n, s, row_tile, window, dtype):
    need_cuda()
    a = _banded_matrix(n, 8, max(window // 3, 4), seed=n + s)
    g = banded_ops.banded_from_scipy(
        a, row_tile=row_tile, window=window, device="cuda",
        dtype=np.float64 if dtype == torch.float64 else np.float32)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    x = torch.rand((n, s), generator=gen, device="cuda", dtype=dtype)
    before = _build.launch_counts().get(banded_ops.KERNEL, 0)
    y = banded_ops.banded_inband(g, x)
    torch.cuda.synchronize()
    assert _build.launch_counts()[banded_ops.KERNEL] == before + 1
    ref = banded_ops.banded_spmm_plain(g.lidx, g.weights, g.slab_starts, x,
                                       g.row_tile, g.slab_rows)
    assert y.shape == ref.shape == (g.lidx.shape[0], s) and y.dtype == dtype
    assert float((y - ref).abs().max()) \
        <= BANDED_RTOL[dtype] * float(ref.abs().max())
    # the same launch again gives the same bits
    assert torch.equal(banded_ops.banded_inband(g, x), y)
    # the whole product (in-band kernel + spill gather + COO tail)
    full = banded_ops.banded_spmm(g, x)
    want = torch.as_tensor(a @ x.double().cpu().numpy(), device="cuda")
    tol = 1e-5 if dtype == torch.float32 else 1e-12
    assert float((full.double() - want).abs().max()) \
        <= tol * float(want.abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("fill", ["full", "ragged", "empty"])
def test_banded_kernel_full_ragged_and_empty_rows(fill, dtype):
    """Every slot in band; non-zero counts from 0 to K within every 32 rows,
    scattered in the row; and no edge at all."""
    need_cuda()
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    n, k, tile, window = 1024, 12, 256, 128
    rs = np.random.RandomState(6)
    starts = np.clip(np.arange(n // tile) * tile - window, 0,
                     n - (tile + 2 * window)).astype(np.int32)
    lidx = rs.randint(0, tile + 2 * window, (n, k)).astype(np.int32)
    w = (rs.rand(n, k) * 0.9 + 0.1).astype(np_dtype)
    counts = {"full": np.full(n, k), "ragged": np.arange(n) % (k + 1),
              "empty": np.zeros(n, int)}[fill]
    keep = np.arange(k)[None, :] < counts[:, None]
    keep = np.take_along_axis(keep, np.argsort(rs.rand(n, k), axis=1), axis=1)
    g = banded_ops.banded_from_arrays(
        np.where(keep, lidx, 0), np.where(keep, w, 0).astype(np_dtype),
        starts, np.zeros((n, 0), np.int32), np.zeros((n, 0), np_dtype),
        np.zeros(0, np.int32), np.zeros(0, np.int32), np.zeros(0, np_dtype),
        np.zeros(n, np_dtype), n, tile, tile + 2 * window, device="cuda")
    assert bool((g.compact.row_nnz.cpu() == torch.as_tensor(counts)).all())
    x = torch.rand((n, 50), device="cuda", dtype=dtype)
    ref = banded_ops.banded_spmm_plain(g.lidx, g.weights, g.slab_starts, x,
                                       tile, tile + 2 * window)
    y = banded_ops.banded_inband(g, x)
    assert float((y - ref).abs().max()) \
        <= BANDED_RTOL[dtype] * max(float(ref.abs().max()), 1.0)
    assert torch.equal(y, banded_ops.banded_inband(g, x))


@pytest.mark.gpu
def test_banded_kernel_rejects_what_it_cannot_take():
    need_cuda()
    a = _banded_matrix(600, 6, 20, seed=1)
    g = banded_ops.banded_from_scipy(a, device="cuda", dtype=np.float32)
    x = torch.rand((600, 4), device="cuda")
    with pytest.raises(TypeError, match="float32 or float64"):
        banded_ops.banded_inband(g, x.double())
    with pytest.raises(ValueError, match="is on"):
        banded_ops.banded_inband(g, x.cpu())
    # no slab is too long for the kernel: it stages none
    huge = banded_ops.banded_from_scipy(a, row_tile=256, window=40_000,
                                        device="cuda", dtype=np.float64)
    y = banded_ops.banded_inband(huge, x.double())
    ref = banded_ops.banded_spmm_plain(
        huge.lidx, huge.weights, huge.slab_starts, x.double(), huge.row_tile,
        huge.slab_rows)
    assert float((y - ref).abs().max()) <= 1e-12 * float(ref.abs().max())


@pytest.mark.gpu
def test_nam_under_banded_on_the_card_goes_through_the_kernel():
    need_cuda()
    try:
        ct.config.set_device("cuda")
        ct.config.enable_x64(False)
        d, samplem = ct.data.synthetic_dataset(
            n_samples=20, cells_per_sample=1500, n_genes=20, seed=2,
            structure="manifold")
        ct.pp.pca(d, n_comps=10)
        ct.pp.neighbors(d, n_neighbors=15)
        ct.tl.set_graph_format(d, "ell")
        nam_ell, keep_ell = ct.tl.nam(d, "id", nsteps=3)
        ct.tl.set_graph_format(d, "banded")
        ct.ops.reset_launch_counts()
        nam_b, keep_b = ct.tl.nam(d, "id", nsteps=3)
        assert ct.ops.launch_counts() == {banded_ops.KERNEL: 3}
        assert (keep_b == keep_ell).all()
        err = np.abs(nam_b.to_numpy() - nam_ell.to_numpy()).max()
        assert err <= 1e-4 * np.abs(nam_ell.to_numpy()).max()
        for fmt in ("block", "hybrid"):
            ct.tl.set_graph_format(d, fmt)
            nam_f, _ = ct.tl.nam(d, "id", nsteps=3)
            err = np.abs(nam_f.to_numpy() - nam_ell.to_numpy()).max()
            assert err <= 1e-4 * np.abs(nam_ell.to_numpy()).max()
        ct.tl.set_graph_format(d, "banded")
        p = ct.tl.association(d, samplem["case"].astype(float), "id",
                              Nnull=200, seed=0)
        assert 0 < p <= 1
    finally:
        ct.config.set_device("cpu")
        ct.config.enable_x64(True)


@pytest.mark.gpu
def test_select_hvg_on_the_card_keeps_the_cpus_genes():
    need_cuda()
    rng = np.random.RandomState(4)
    n, g = 3000, 4000
    x = rng.poisson(rng.lognormal(-2.0, 1.5, g), (n, g)).astype(np.float32)
    x[:, :30] *= rng.gamma(0.5, 2.0, (n, 1)).astype(np.float32)
    try:
        keeps = {}
        for dev in ("cuda", "cpu"):
            ct.config.set_device(dev)
            d = ct.CellData(X=sp.csr_matrix(x))
            keeps[dev] = ct.pp.select_hvg(d, n_top=300)
            assert sp.issparse(d.X) and d.X.shape == (n, 300)
        np.testing.assert_array_equal(keeps["cuda"], keeps["cpu"])
        assert keeps["cuda"][:30].all()
    finally:
        ct.config.set_device("cpu")
        ct.config.enable_x64(True)


@pytest.mark.gpu
def test_umap_engine_on_the_card():
    """The edges and groups sorted on the card equal the CPU's; three
    epochs on the card under the CPU's window draws stay as close to the
    same epochs in float64 as the CPU's float32 run does (within 4x, both
    being float32 rounding of the same sums); two card runs of one seed
    give the same bits."""
    import importlib

    um = importlib.import_module("cna_tpu_torch.pp.umap")
    need_cuda()
    try:
        ct.config.set_device("cpu")
        ct.config.enable_x64(True)
        d, _ = ct.data.synthetic_dataset(n_samples=20, cells_per_sample=100,
                                         n_genes=30, seed=3,
                                         dtype=np.float64)
        ct.pp.pca(d, n_comps=15)
        ct.pp.neighbors(d, n_neighbors=15)
        conn = d.obsp["connectivities"]
        n = d.n_obs
        groups = {}
        for dev in ("cpu", "cuda"):
            ct.config.set_device(dev)
            h, t, e = um._umap_edges(conn, 200)
            groups[dev] = um._period_structure(h, t, e, n)
        for gc, gg in zip(groups["cpu"], groups["cuda"]):
            assert gc["period"] == gg["period"]
            for key in ("heads", "tails", "ord", "bounds"):
                assert torch.equal(gc[key], gg[key].cpu()), key
        a, b = um._fit_ab()
        pos0, _ = um.initial_layout(d, conn, "spectral", seed=0)
        nw = n // 5
        rng = np.random.RandomState(0)
        table = {(i, gi): rng.randint(0, nw, g["heads"].shape[0])
                 for i in range(3) for gi, g in enumerate(groups["cpu"])}

        def draws(dev):
            return lambda i, gi, e_g, nw_: torch.as_tensor(
                table[i, gi], device=dev)

        run = {}
        for key, dev, dtype in (("cpu64", "cpu", torch.float64),
                                ("cpu32", "cpu", torch.float32),
                                ("cuda32", "cuda", torch.float32)):
            run[key] = um._optimize_layout(
                torch.as_tensor(pos0, device=dev, dtype=dtype), groups[dev],
                a, b, 3, _draws=draws(dev)).cpu().double()
        cpu_err = float((run["cpu32"] - run["cpu64"]).abs().max())
        card_err = float((run["cuda32"] - run["cpu64"]).abs().max())
        assert card_err <= 4 * max(cpu_err, 1e-6), (card_err, cpu_err)
        pos0_dev = torch.as_tensor(pos0, device="cuda")
        first = um._optimize_layout(pos0_dev, groups["cuda"], a, b, 20, seed=5)
        again = um._optimize_layout(pos0_dev, groups["cuda"], a, b, 20, seed=5)
        assert torch.equal(first, again)
    finally:
        ct.config.set_device("cpu")
        ct.config.enable_x64(True)


@pytest.mark.gpu
def test_float_checks_see_the_kernels_output(monkeypatch):
    """The CUDA kernels bypass the dispatcher; their wrappers hand the
    outputs to ``utils.checks.kernel_outputs``, which checks them while the
    NaN checks are on."""
    from cna_tpu_torch.utils import checks

    need_cuda()
    seen = []

    def spy(kernel, *outs):
        seen.append((kernel, [o.device.type for o in outs]))
        checks.kernel_outputs(kernel, *outs)

    monkeypatch.setattr(knn_ops, "kernel_outputs", spy)
    x = torch.randn(500, 8, device="cuda")
    with checks.FloatChecks():
        knn_ops.knn_exact(x, 5)
        bad = torch.full((3,), torch.nan, device="cuda")
        with pytest.raises(FloatingPointError, match="'knn_exact'"):
            checks.kernel_outputs(knn_ops.KERNEL, bad)
    assert seen == [(knn_ops.KERNEL, ["cuda", "cuda"])]


@pytest.mark.gpu
@pytest.mark.parametrize("perms", [1, 2])
def test_halo_step_on_the_card_matches_the_cpu(perms):
    """The halo step over four slots of one card (4 x 1 and 2 x 2) in
    float64 against the same step over CPU slots: one plan, the same
    sums (rtol 1e-12)."""
    from cna_tpu_torch.parallel import halo, make_mesh

    need_cuda()
    n = 3000
    a = sp.random(n, n, density=0.004, random_state=2, format="csr")
    a = (a + a.T).tocsr()
    cells = 4 // perms
    plan = halo.build_halo_plan_csr(a, cells, dtype=np.float64)
    n_pad = plan.n_shards * plan.shard_rows
    s = torch.from_numpy(np.pad(
        np.random.default_rng(1).standard_normal((n, 20)),
        ((0, n_pad - n), (0, 0))))
    card = make_mesh(["cuda:0"] * 4, perms=perms)
    host = make_mesh(["cpu"] * 4, perms=perms)
    got, ref = s, s
    for _ in range(3):
        got = halo.halo_diffusion_step(got, plan, card, 1.0)
        ref = halo.halo_diffusion_step(ref, plan, host, 1.0)
    assert all(t.device.type == "cuda" for t in got.shards.values())
    np.testing.assert_allclose(np.asarray(got)[:n], np.asarray(ref)[:n],
                               rtol=1e-12, atol=1e-14)
