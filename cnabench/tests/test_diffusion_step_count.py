"""CPU test of the ``diffusion_step`` roofline count: the operations and
bytes by hand on a small graph, nonzero weights counted and padded slots
not, and the wrapper as ``tools/_nam.py`` calls it.
``python -m pytest cnabench/tests``."""

from __future__ import annotations

import numpy as np
import torch

import cna_tpu_torch as ct
from cna_tpu_torch.graph.device import DeviceConnectivities
from cna_tpu_torch.graph.ell import from_arrays
from cnabench import roofline


def test_diffusion_step_count_by_hand():
    """Four rows of width 3 (12 slots, 5 of them padding) and one COO
    edge: 8 edges, whatever the slots hold."""
    mod = roofline.load("diffusion_step")
    ids = np.array([[1, 2, 0], [0, 0, 0], [3, 1, 0], [2, 0, 0]], np.int32)
    w = np.array([[0.5, 0.25, 0.0], [0.5, 0.0, 0.0], [1.0, 0.25, 0.0],
                  [1.0, 0.0, 0.0]])
    g = from_arrays(ids, w, np.ones(4), [1], [3], [0.75], device="cpu")
    assert mod.nonzero_edges(g) == 7
    s = torch.zeros((4, 10), dtype=torch.float64)
    flops, nbytes = mod.count((s, g, g.colsums(1.0), 1.0), {})()
    assert flops == 2.0 * 7 * 10 + 3.0 * 4 * 10
    assert nbytes == 2.0 * 4 * 10 * 8 + 4 * 8 + (4.0 + 8) * 7
    flops32, nbytes32 = mod.count((s.float(), g), {"colsums": None})()
    assert flops32 == flops
    assert nbytes32 == 2.0 * 4 * 10 * 4 + 4 * 4 + (4.0 + 4) * 7


def test_diffusion_step_count_through_the_nam():
    """Every step of ``tl.nam`` passes through the wrapped global, and
    the count is the stored edges of the graph (its CSR's non-zeros),
    not its padded slots."""
    d, _ = ct.data.synthetic_dataset(n_samples=10, cells_per_sample=60,
                                     n_genes=10, seed=1)
    ct.config.set_device("cpu")
    ct.pp.pca(d, n_comps=5)
    ct.pp.neighbors(d, n_neighbors=8)
    mod = roofline.load("diffusion_step")
    with roofline.counting(["diffusion_step"]) as thunks:
        ct.tl.nam(d, "id", nsteps=3)
    assert len(thunks["diffusion_step"]) == 3
    conn = d.obsp["connectivities"]
    graph = conn.ell if isinstance(conn, DeviceConnectivities) else None
    n = d.n_obs
    flops, _ = thunks["diffusion_step"][0][0]()
    nnz = (flops - 3.0 * n * 10) / (2.0 * 10)
    assert nnz == conn.tocsr().nnz
    if graph is not None:
        assert mod.nonzero_edges(graph) == nnz
        slots = sum(int(np.prod(getattr(graph, f).shape))
                    for f in ("weights", "direct_weights")
                    if hasattr(graph, f))
        assert slots > nnz
