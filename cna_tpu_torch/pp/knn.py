"""Exact k-nearest-neighbor search on the device.

The reference outsources kNN to scanpy/pynndescent (approximate, CPU).
Here kNN is a first-class on-device primitive:

* ``'exact'``: blocked brute force in the input dtype, squared distances
  ``|q|^2 + |x|^2 - 2 q.x`` with the cross term a matmul and a running
  ``torch.topk`` merge across key blocks, so the full N x N distance
  matrix is never materialized (the TPU package's ``pp/knn.py``);
* ``'pallas'``: the exact hand-written kernel (``ops.knn``), float32; the
  name is kept so that scripts written for the TPU package run unchanged;
* ``'ivf'``: the sub-quadratic fine-block index (``pp.ivf``), whose scorer
  is the hand-written kernel of ``ops.ivf``.

Each point is its own first neighbor (distance 0), the scanpy convention
the fuzzy-connectivity code expects.
"""

from __future__ import annotations

import torch

from .. import config
from ..utils.transfer import as_tensor, fetch

_AUTO_EXACT_MAX_N = 20_000
_AUTO_IVF_MIN_N = 262_144
_METHODS = ("auto", "exact", "pallas", "approx", "ivf")


def resolve_method(n, method, device=None):
    """Resolve 'auto' to a concrete kNN method for ``n`` points on
    ``device`` (default: the configured device): exact up to 20,000
    points, 'ivf' above 262,144, and in between the exact kernel
    ('pallas') on cuda and the blocked search ('approx') elsewhere."""
    if method not in _METHODS:
        raise ValueError(f"unknown kNN method {method!r}; use one of "
                         f"{_METHODS}")
    if method != "auto":
        return method
    if n <= _AUTO_EXACT_MAX_N:
        return "exact"
    if n > _AUTO_IVF_MIN_N:
        return "ivf"
    dev = config.device() if device is None else torch.device(device)
    return "pallas" if dev.type == "cuda" else "approx"


def _knn_query_block(x, q_ids, sq_norms, k, key_block):
    """Top-k nearest rows of x for each query row x[q_ids] (``q_ids``: a
    1-D int64 tensor of row ids), merging over key blocks.

    The self pair's squared distance is set to exactly 0: the expansion
    leaves rounding noise there (about 1e-15 in float64), which would
    otherwise become ``rho`` of the fuzzy kernel in the rows where it
    rounds positive.

    Each key block's negated distances are written next to the running
    top-k in one (Q, k + key_block) buffer that every block reuses: a
    fresh tile per block costs its first-touch page faults on the CPU,
    which took most of the search's time there.

    Returns (neg_sq_dists (Q, k) descending, indices (Q, k) int64).
    """
    q = x[q_ids]
    nq = q.shape[0]
    n = x.shape[0]
    dev = q.device
    width = min(key_block, n)
    q_norms = sq_norms[q_ids, None]  # (Q, 1)
    cat_d = torch.empty((nq, k + width), dtype=q.dtype, device=dev)
    cat_d[:, :k] = -torch.inf
    cross_buf = torch.empty((nq, width), dtype=q.dtype, device=dev)
    best_i = torch.zeros((nq, k), dtype=torch.int64, device=dev)
    for start in range(0, n, key_block):
        xb = x[start:start + key_block]
        b = xb.shape[0]
        cross = cross_buf if b == width else torch.empty(
            (nq, b), dtype=q.dtype, device=dev)
        torch.mm(q, xb.T, out=cross)  # (Q, B)
        d2 = cat_d[:, k:k + b]
        torch.add(q_norms, sq_norms[None, start:start + b], out=d2)
        d2.sub_(cross, alpha=2.0)
        mine = torch.nonzero((q_ids >= start) & (q_ids < start + b))[:, 0]
        d2[mine, q_ids[mine] - start] = 0.0
        d2.neg_()
        best_d, pos = torch.topk(cat_d[:, :k + b], k, dim=1)
        best_i = torch.where(
            pos < k, torch.gather(best_i, 1, torch.clamp(pos, max=k - 1)),
            pos - k + start)
        cat_d[:, :k] = best_d
    return best_d, best_i


def knn_device(x, k, method, query_block=4096, key_block=8192):
    """kNN of the rows of tensor ``x`` for a resolved ``method``, left on
    ``x``'s device: (indices (N, k) int32, distances (N, k))."""
    if method == "pallas":
        from ..ops.knn import knn_exact

        neg_d, idx = knn_exact(x.to(torch.float32).contiguous(), k)
    elif method == "ivf":
        raise ValueError("knn_device serves the exact methods; the IVF "
                         "index is pp.ivf.ivf_knn_device")
    else:  # 'exact', and 'approx', which has no approximate search here
        sq_norms = torch.sum(x * x, dim=1)
        n = x.shape[0]
        rows = torch.arange(n, device=x.device)
        parts = [_knn_query_block(x, rows[s:s + query_block], sq_norms, k,
                                  key_block)
                 for s in range(0, n, query_block)]
        neg_d = torch.cat([p[0] for p in parts])
        idx = torch.cat([p[1] for p in parts]).to(torch.int32)
    # numerical floor: a duplicate point's distance can round negative
    return idx, torch.sqrt(torch.clamp(-neg_d, min=0.0))


def knn_search(points, k, query_block=4096, key_block=8192, method="auto"):
    """kNN of ``points`` against themselves, on the configured device.

    Returns (indices (N, k) int32, distances (N, k)) as numpy arrays, with
    neighbors sorted by increasing distance; each point is its own first
    neighbor.

    ``method``:
      * ``'exact'``: blocked ``torch.topk`` merge, in the input dtype;
      * ``'pallas'``: the exact hand-written kernel (``ops.knn``), in
        float32 — the CUDA kernel on cuda, its plain version on the CPU;
      * ``'approx'``: runs the exact blocked search (PyTorch has no
        counterpart of the TPU's ``approx_max_k``);
      * ``'ivf'``: the fine-block IVF index (``pp.ivf.ivf_knn``), float32,
        with measured recall (at least 0.9 by default);
      * ``'auto'`` (default): ``resolve_method``.
    """
    x = as_tensor(points)
    method = resolve_method(x.shape[0], method, x.device)
    if method == "ivf":
        from .ivf import ivf_knn

        return ivf_knn(x, k)
    idx, dists = knn_device(x, k, method, query_block, key_block)
    return fetch(idx), fetch(dists)
