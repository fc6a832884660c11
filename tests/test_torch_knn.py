"""cna_tpu_torch's exact kNN (``ops.knn``, ``pp.knn``) against cna_tpu's.

The CUDA kernel runs only on a card; here its plain version (what a CPU
tensor takes) is held to the Pallas kernel of cna_tpu in interpret mode,
and ``pp.knn.knn_search`` to cna_tpu's blocked search.  The kernel itself
is held to its plain version on the card by ``test_torch_card.py`` (no
JAX there) and by ``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

from cna_tpu.ops.knn_pallas import knn_pallas
from cna_tpu.pp.knn import knn_search as tpu_knn_search
from cna_tpu_torch.ops import _build
from cna_tpu_torch.ops import knn as knn_ops
from cna_tpu_torch.pp.knn import knn_device, knn_search, resolve_method

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
