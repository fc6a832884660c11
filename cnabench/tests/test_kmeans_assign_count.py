"""CPU test of the ``kmeans_assign`` roofline count: the operations and
bytes by hand, and the wrapper as ``pp/ivf_fine.py`` calls it.
``python -m pytest cnabench/tests``."""

from __future__ import annotations

import torch

from cnabench import roofline


def test_kmeans_assign_count_by_hand_and_through_the_fit():
    """The counts, and the wrapper as pp/ivf_fine.py calls it: every Lloyd
    iteration and the assignment pass through the wrapped global."""
    from cna_tpu_torch.pp import ivf_fine

    mod = roofline.load("kmeans_assign")
    x, cent = torch.zeros((1000, 20)), torch.zeros((96, 20))
    flops, nbytes = mod.count((x, cent), {})()
    assert flops == 2.0 * 1000 * 96 * 20
    assert nbytes == 4.0 * (1000 * 20 + 96 * 20) + 8.0 * 1000
    x = torch.randn(300, 3)
    with roofline.counting(["kmeans_assign"]) as thunks:
        cent = ivf_fine._kmeans_fit_matmul(
            x, torch.ones(300, dtype=torch.bool), torch.arange(8), 8, 2, 64)
        ivf_fine._assign_chunked(x, cent, 64)
    assert [t() for t, _, _ in thunks["kmeans_assign"]] == \
        [(2.0 * 300 * 8 * 3, 4.0 * (300 * 3 + 8 * 3) + 8.0 * 300)] * 3
    assert ivf_fine.kmeans_assign.__module__ == "cna_tpu_torch.ops.kmeans"
