"""Shared helpers of the cna_tpu_torch parity tests.

The port runs on the CPU in float64 here (``set_device("cpu")`` and
``enable_x64(True)``, as the TPU package's tests run on the CPU with x64
on); inputs are made with numpy from a seed and handed to both packages.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from cna_tpu_torch import config


@pytest.fixture(scope="module", autouse=True)
def torch_cpu_x64():
    """Every port test computes on the CPU in float64 (module scope, so
    that module-scoped data fixtures see it too)."""
    config.set_device("cpu")
    config.enable_x64(True)
    yield


def need_cuda():
    """Skip the calling test unless a CUDA card is present (decided at
    run time, never at import or collection)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card; chip_smoke.py covers the kernel "
                    "on the card")


def brute_knn(x, k):
    """Exact kNN by numpy brute force: (ids (N, k), squared dists (N, k))."""
    d2 = ((x[:, None, :] - x[None, :, :]) ** 2).sum(-1)
    order = np.argsort(d2, axis=1, kind="stable")[:, :k]
    return order, np.take_along_axis(d2, order, axis=1)


def sign_align(ref, other):
    """Per-column signs s with other * s ~ ref (eigenvector signs are
    arbitrary in both packages)."""
    s = np.sign(np.sum(np.asarray(ref) * np.asarray(other), axis=0))
    s[s == 0] = 1.0
    return s


def dyadic(a, bits=10):
    """``a`` with column signs fixed (largest |entry| positive) and rounded
    to multiples of 2**-bits.  Squared distances of such points are exact
    in float64, so the kNN expansion |q|^2 + |x|^2 - 2 q.x gives the same
    bits in both packages (its rounding noise otherwise differs between
    the two matmul libraries, and an exactly-zero versus a 1e-8 self
    distance changes rho of the fuzzy kernel)."""
    a = np.asarray(a, dtype=np.float64)
    lead = a[np.argmax(np.abs(a), axis=0), np.arange(a.shape[1])]
    a = a * np.where(lead < 0, -1.0, 1.0)
    return np.round(a * 2.0 ** bits) / 2.0 ** bits
