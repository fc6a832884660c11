"""The float32 path (the card's default) against the float64 path on the
same inputs, on the CPU: the PCA covariance and the fuzzy strengths are
computed in float64 whatever the working dtype, so the float32 results
stay within float32 rounding of the float64 ones (20,000 cells)."""

import importlib
import math

import numpy as np
import pytest
import torch

import cna_tpu_torch as ct

from .torch_parity import sign_align, torch_cpu_x64  # noqa: F401

nb = importlib.import_module("cna_tpu_torch.pp.neighbors")

# float32 rounding of the data and of the projection (the covariance
# itself in float64); a float32 covariance gave 1.3e-5 here
PCA_RTOL = 2e-6
# float32 rounding of the stored weights (the bisection in float64); a
# float32 bisection gave 3e-5 here, 1e-4 at 100,000 cells
STRENGTH_RTOL = 5e-7


@pytest.fixture(scope="module")
def scores():
    out = {}
    for x64 in (True, False):
        ct.config.enable_x64(x64)
        d, _ = ct.data.synthetic_dataset(
            n_samples=100, cells_per_sample=200, n_genes=50, seed=1,
            dtype=np.float64 if x64 else np.float32)
        ct.pp.pca(d, n_comps=20)
        out[x64] = np.asarray(d.obsm["X_pca"], dtype=np.float64)
    ct.config.enable_x64(True)
    return out


def test_pca_float32_within_rounding_of_float64(scores):
    a, b = scores[True], scores[False]
    s = sign_align(a, b)
    assert np.abs(b * s - a).max() / np.abs(a).max() <= PCA_RTOL


def test_strengths_float32_within_rounding_of_float64(scores):
    idx, dist = ct.pp.knn.knn_search(scores[True], 15)
    i_t = torch.as_tensor(idx)
    d32 = torch.as_tensor(dist.astype(np.float32))
    w32 = nb._strengths(d32, i_t, 15)
    w64 = nb._strengths(d32.double(), i_t, 15)
    assert w32.dtype == torch.float32 and w64.dtype == torch.float64
    rho, sigma = nb.smooth_knn_dist(d32.double(), math.log2(15))
    np.testing.assert_array_equal(
        w64.numpy(),
        nb.membership_strengths(d32.double(), rho, sigma, i_t).numpy())
    m = w64.numpy() > 0
    rel = np.abs(w32.double().numpy()[m] - w64.numpy()[m]) / w64.numpy()[m]
    assert rel.max() <= STRENGTH_RTOL
