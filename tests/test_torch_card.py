"""The hand-written CUDA kernels against their plain versions, on the card.

These tests need an NVIDIA card and skip without one.  This file imports
neither JAX nor cna_tpu, so it runs where the port runs; on the card's
machine (which has no JAX, while ``tests/conftest.py`` imports it):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_card.py -m gpu
"""

import pytest
import torch

import cna_tpu_torch as ct
from cna_tpu_torch.ops import _build
from cna_tpu_torch.ops import knn as knn_ops

from .torch_parity import need_cuda

# float32 squared distances summed in different orders
F32_DIST_ATOL = 1e-3


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
    finally:
        ct.config.set_device("cpu")
        ct.config.enable_x64(True)
