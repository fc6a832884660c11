"""IVF (inverted-file) approximate kNN: sub-quadratic search on the device.

Brute-force kNN (``ops.knn``) is exact but O(N^2); atlas-scale search
needs an index.  There is one implementation: the two-level fine-block
index in ``pp.ivf_fine`` (k-means clusters of about 96 rows packed into
g-row blocks, per-block own-centroid probe tables, results left on the
device in compact layout order), scored by the hand-written kernel of
``ops.ivf`` on cuda and by its plain version on the CPU.  Index
structure, probe selection, pilot calibration and held-out recall
verification are the same on both.

Total compute is about N * coverage * N * D multiply-adds, linear in N
for a fixed cluster geometry.  Recall follows probe coverage, which a
pilot calibrates against a measured exact-truth sample per dataset (with
a held-out verification half).

This module keeps the host-contract wrapper (``ivf_knn``), the
device-resident entry (``ivf_knn_device``) and the exact-truth recall
helpers shared by tests and the smoke run (the TPU package's
``pp/ivf.py``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.transfer import as_tensor, fetch
from .knn import _knn_query_block


def exact_knn_sample(x, q_ix, k, exact=True):
    """Reference kNN indices (numpy, (|q_ix|, k)) of the rows ``q_ix`` of
    ``x`` against all of ``x``: blocked (|q| x N) distance matmuls with a
    running ``torch.topk`` merge, cheap relative to an index build.

    ``exact`` is accepted for the TPU package's signature; both values run
    the exact merge (PyTorch has no counterpart of ``approx_max_k``)."""
    del exact
    x = x if isinstance(x, torch.Tensor) else as_tensor(x)
    n = x.shape[0]
    # wide key blocks at atlas scale: the loop's cost is per-step
    # overhead, and a (512, 131072) float32 tile is 256 MiB
    key_block = (131_072 if n > 262_144
                 else 32_768 if n > 32_768 else 8_192)
    q_ids = torch.as_tensor(np.asarray(q_ix), dtype=torch.int64,
                            device=x.device)
    sq = torch.sum(x * x, dim=1)
    _, true_idx = _knn_query_block(x, q_ids, sq, k, key_block)
    return fetch(true_idx)


def _recall_against(indices_rows, true_rows, k):
    hits = 0
    for row, truth in zip(indices_rows, true_rows):
        hits += len(np.intersect1d(row, truth, assume_unique=False))
    return hits / max(len(true_rows) * k, 1)


def measured_recall(x, indices, k, sample=512, seed=0, exact=True):
    """Recall@k of ``indices`` (host, (N, k)) against exact kNN on a
    random query sample."""
    n = x.shape[0]
    rng = np.random.RandomState(seed)
    m = min(sample, n)
    q_ix = rng.choice(n, m, replace=False)
    true_idx = exact_knn_sample(x, q_ix, k, exact=exact)
    return _recall_against(np.asarray(indices)[q_ix], true_idx, k)


def ivf_knn_device(points, k, **kw):
    """Device-resident IVF kNN (two-level fine-block index): returns a
    ``FineSearchResult`` with (indices, dists) on the device in compact
    layout coordinates plus the ``order`` permutation.  The atlas-scale
    entry point of ``pp.neighbors``.  See ``pp.ivf_fine``."""
    from .ivf_fine import ivf_knn_fine

    return ivf_knn_fine(points, k, **kw)


def ivf_knn(points, k, seed=0, min_recall=0.9, recall_sample=512, **fine_kw):
    """Approximate self-kNN via the fine-block IVF index.

    Returns (indices (N, k) int32, distances (N, k) float32) as numpy
    arrays sorted by increasing distance, each point its own first
    neighbor (the contract of ``knn_search``): the host-materializing
    wrapper over ``ivf_knn_device`` (which is what ``pp.neighbors``
    consumes).

    Recall depends on the data's metric structure (true of every
    approximate index), so the index measures it: recall@k is estimated
    against an exact-kNN sample and the probe count is calibrated on a
    pilot before the full search; while the measured recall is below
    ``min_recall`` the search re-runs with an escalated probe count.  A
    warning is raised if the floor is unreachable.  ``min_recall=None``
    disables the measurement.  Use ``method='pallas'`` (exact, O(N^2)) if
    in doubt.

    Extra ``fine_kw`` (``u0``, ``n_clusters``, ``g``, ``target_rows``,
    ``kmeans_sample``, ``kmeans_iters``, ...) pass through to
    ``ivf_knn_fine``.
    """
    res = ivf_knn_device(points, k, seed=seed, min_recall=min_recall,
                         recall_sample=recall_sample, **fine_kw)
    idx_c = fetch(res.indices)
    d_c = fetch(res.dists)
    order = res.order
    n = len(order)
    indices = np.empty((n, k), np.int32)
    dists = np.empty((n, k), np.float32)
    indices[order] = order[idx_c]
    dists[order] = d_c
    return indices, dists
