"""The hand-written CUDA kernels against their plain versions, on the card.

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
    # the whole product (in-band kernel + spill gather + COO tail)
    full = banded_ops.banded_spmm(g, x)
    want = torch.as_tensor(a @ x.double().cpu().numpy(), device="cuda")
    tol = 1e-5 if dtype == torch.float32 else 1e-12
    assert float((full.double() - want).abs().max()) \
        <= tol * float(want.abs().max())


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
    # a slab of which not one column fits a block's shared memory
    huge = banded_ops.banded_from_scipy(a, row_tile=256, window=40_000,
                                        device="cuda", dtype=np.float64)
    with pytest.raises(ValueError, match="does not fit"):
        banded_ops.banded_inband(huge, x.double())


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
