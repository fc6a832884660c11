"""kNN graph + UMAP fuzzy-simplicial-set connectivities, on the device.

Replaces the external preprocessing the reference assumes
(``sc.pp.neighbors``; reference demo.ipynb cell 29, read at
``_nam.py:12-19``).  ``obsp['connectivities']`` follows umap-learn's
``fuzzy_simplicial_set`` construction (from the UMAP paper's
definitions):

1. per-point adaptive kernel: ``rho_i`` = distance to nearest neighbor,
   ``sigma_i`` solved by bisection so the smoothed neighbor weights sum to
   ``log2(n_neighbors)``;
2. directed membership strengths ``exp(-(d_ij - rho_i)+ / sigma_i)``;
3. probabilistic-union symmetrization ``A + A^T - A o A^T``.

The math runs on the device.  ``neighbors`` then takes one of the TPU
package's two branches (``pp/neighbors.py:393-430``): on the IVF path
(any device) and whenever the representation is on ``cuda``, the graph is
packed on the device (``graph.device.build_sym_ell``) and ``obsp`` holds
lazy faces; for the exact methods on the CPU the host assembles scipy CSR
matrices.
"""

from __future__ import annotations

import math

import numpy as np
import scipy.sparse as sp
import torch

from ..graph.device import (DeviceConnectivities, LazyDistances,
                            build_sym_ell)
from ..graph.reorder import Reordering
from ..utils.profiling import global_profiler
from ..utils.transfer import as_tensor, fetch
from .ivf import ivf_knn_device
from .knn import knn_device, resolve_method

_SMOOTH_K_TOLERANCE = 1e-5
_MIN_K_DIST_SCALE = 1e-3


def smooth_knn_dist(dists, target, n_iter=64):
    """Solve for (rho, sigma) per point given ascending kNN distances.

    ``dists``: (N, k) including the self distance 0 in column 0.
    ``target``: scalar, log2(n_neighbors).
    Follows umap-learn's ``smooth_knn_dist`` with local_connectivity=1:
    rho = smallest nonzero distance; sigma by 64-step bisection on
    ``sum_{j>=1} exp(-(d_ij - rho)+ / sigma) = target`` with the
    d <= rho terms contributing exactly 1.
    """
    inf = torch.full_like(dists, torch.inf)
    rho = torch.where(dists > 0, dists, inf).min(dim=1).values
    rho = torch.where(torch.isfinite(rho), rho, torch.zeros_like(rho))

    d_shift = dists[:, 1:] - rho[:, None]  # skip self column
    pos = d_shift > 0
    ones = torch.ones_like(d_shift)

    n = dists.shape[0]
    lo = torch.zeros(n, dtype=dists.dtype, device=dists.device)
    hi = torch.full((n,), torch.inf, dtype=dists.dtype, device=dists.device)
    mid = torch.ones(n, dtype=dists.dtype, device=dists.device)
    for _ in range(n_iter):
        val = torch.where(pos, torch.exp(-d_shift / mid[:, None]),
                          ones).sum(dim=1)
        done = torch.abs(val - target) < _SMOOTH_K_TOLERANCE
        too_big = val > target
        new_hi = torch.where(~done & too_big, mid, hi)
        new_lo = torch.where(~done & ~too_big, mid, lo)
        mid = torch.where(
            done,
            mid,
            torch.where(
                too_big,
                (lo + new_hi) / 2.0,
                torch.where(torch.isinf(new_hi), mid * 2.0,
                            (new_lo + new_hi) / 2.0),
            ),
        )
        lo, hi = new_lo, new_hi
    sigma = mid

    # clamp tiny sigmas relative to the mean local distance scale
    mean_d_local = dists.mean(dim=1)
    mean_d_global = dists.mean()
    sigma = torch.where(
        rho > 0,
        torch.maximum(sigma, _MIN_K_DIST_SCALE * mean_d_local),
        torch.maximum(sigma, _MIN_K_DIST_SCALE * mean_d_global),
    )
    return rho, sigma


def membership_strengths(dists, rho, sigma, indices=None):
    """Directed edge weights exp(-(d - rho)+ / sigma); self edges get 0.

    The self edge is identified by INDEX (``indices[i, j] == i``), as in
    umap-learn: with duplicate points the self entry can tie-break into
    any distance-0 column.  When ``indices`` is omitted, column 0 is
    assumed to be self (true for distinct points).
    """
    w = torch.exp(-torch.clamp(dists - rho[:, None], min=0.0)
                  / sigma[:, None])
    if indices is None:
        w = w.clone()
        w[:, 0] = 0.0
        return w
    rows = torch.arange(dists.shape[0], device=dists.device)[:, None]
    return torch.where(indices == rows, torch.zeros_like(w), w)


def _strengths(dists, indices, n_neighbors):
    """Directed strengths of kNN lists (``smooth_knn_dist`` +
    ``membership_strengths``), computed in float64 and returned in the
    distances' dtype.  In float32 the bisection stops at another step
    than in float64 (its tolerance, 1e-5 on a sum near log2(k), is met at
    a different mid), which moves the far weights of a row by up to
    1e-4 of themselves."""
    d64 = dists.to(torch.float64)
    rho, sigma = smooth_knn_dist(d64, math.log2(n_neighbors))
    return membership_strengths(d64, rho, sigma, indices).to(dists.dtype)


def fuzzy_union_device(indices, w, chunk_rows=65_536):
    """Symmetrized fuzzy-union strengths aligned to the kNN edge list.

    Returns (w_sym (N, k), code (N, k) int8) on the device:
    ``w_sym[i, s] = a + b - a*b`` for the directed edge
    i -> indices[i, s] with a = w[i, s] and b the reverse strength (0 if
    j's list lacks i), found with one gather of j's neighbor list and an
    equality mask.  ``code`` bit 0 says "emit (i, j, w_sym)", bit 1 says
    "also emit the mirror (j, i, w_sym)" (set exactly when the partner's
    own row will not emit it: the side with a > 0 owns the entry).  Both
    a and b come from the same weight tensor and a+b-a*b is evaluated
    identically from either side, so the matrix is float-exact symmetric.
    Row chunks bound the two (B, k, k) gather buffers.  Requires each
    row's neighbor list to be duplicate-free (true of every search in
    ``pp.knn``).
    """
    n = indices.shape[0]
    w_out, code_out = [], []
    for lo in range(0, n, chunk_rows):
        idx_chunk = indices[lo:lo + chunk_rows].long()
        w_chunk = w[lo:lo + chunk_rows]
        nbr_idx = indices[idx_chunk]  # (B, k, k) row gather
        nbr_w = w[idx_chunk]  # (B, k, k)
        i_of_edge = lo + torch.arange(idx_chunk.shape[0], device=w.device)
        match = nbr_idx == i_of_edge[:, None, None]
        b = torch.where(match, nbr_w, torch.zeros_like(nbr_w)).sum(dim=-1)
        pos = w_chunk > 0
        mirror = pos & ~(b > 0)
        code_out.append(pos.to(torch.int8) + 2 * mirror.to(torch.int8))
        w_out.append(w_chunk + b - w_chunk * b)
    return torch.cat(w_out), torch.cat(code_out)


def fuzzy_connectivities(indices, dists):
    """Symmetric fuzzy-union connectivity matrix from kNN lists.

    ``indices`` / ``dists``: (N, k) numpy arrays or tensors (tensors stay
    on their device; arrays go to the configured device).  Returns a scipy
    CSR (N x N): ``A + A^T - A o A^T``.  The bisection, the strengths and
    the union run on the device; the host pulls the (N, k) symmetric
    weights and emission codes and assembles the CSR with boolean
    gathers.
    """
    d_dev = dists if isinstance(dists, torch.Tensor) else as_tensor(dists)
    idx_dev = torch.as_tensor(indices, device=d_dev.device).to(torch.int32)
    n, k = idx_dev.shape
    w_dev = _strengths(d_dev, idx_dev, k)
    w_sym_dev, code_dev = fuzzy_union_device(idx_dev, w_dev)
    idx_np, w_sym, code = fetch(idx_dev), fetch(w_sym_dev), fetch(code_dev)

    rows2d = np.broadcast_to(np.arange(n, dtype=np.int32)[:, None], (n, k))
    direct = (code & 1).astype(bool)
    mirror = (code & 2).astype(bool)
    out_rows = np.concatenate([rows2d[direct], idx_np[mirror]])
    out_cols = np.concatenate([idx_np[direct], rows2d[mirror]])
    out_vals = np.concatenate([w_sym[direct], w_sym[mirror]])
    result = sp.csr_matrix((out_vals, (out_rows, out_cols)), shape=(n, n))
    result.eliminate_zeros()
    return result


def _neighbors_device(data, rep, n_neighbors, method, resolved):
    """Graph build with no (N, k)-sized host transfer.

    kNN lists stay on the device (the IVF fine index in compact layout
    order, or the exact searches in identity order); the fuzzy union and
    the symmetric-ELL pack (``graph.device.build_sym_ell``) consume them
    in place.  What lands in ``obsp`` are lazy faces that materialize
    scipy matrices only if something asks for them; ``tl.association``
    never does (it takes the packed graph and the reordering straight from
    ``DeviceConnectivities``).
    """
    prof = global_profiler()
    n = data.n_obs
    with prof.phase("knn", cells=n):
        if resolved == "ivf":
            res = ivf_knn_device(rep, n_neighbors)
            idx_dev, d_dev, order = res.indices, res.dists, res.order
        else:
            idx_dev, d_dev = knn_device(rep, n_neighbors, resolved)
            order = np.arange(n, dtype=np.int32)
    with prof.phase("fuzzy_graph", cells=n):
        w = _strengths(d_dev, idx_dev, n_neighbors)
        w_sym, code = fuzzy_union_device(idx_dev, w)
        ell = build_sym_ell(idx_dev, w_sym, code)
        if resolved == "ivf":
            inv = np.empty(n, dtype=order.dtype)
            inv[order] = np.arange(n, dtype=order.dtype)
            ordering = Reordering(perm=order, inv=inv)
        else:
            ordering = None  # identity: skip the permutation machinery
        conn = DeviceConnectivities(ell, ordering, n)

    data.obsp["connectivities"] = conn
    data.obsp["distances"] = LazyDistances(idx_dev, d_dev, order)
    data.uns["neighbors"] = _neighbors_meta(n_neighbors, method, resolved)
    if resolved == "ivf":
        # recall provenance: the operating point is a chosen spot on a
        # measured recall-vs-probes curve
        data.uns["neighbors"]["ivf"] = {
            "u": res.u,
            "coverage": res.u * res.index.g / max(n, 1),
            "verify_recall": res.recall,
            "pilot_curve": list(res.history),
        }
    return conn


def _neighbors_meta(n_neighbors, method, resolved):
    return {
        "connectivities_key": "connectivities",
        "distances_key": "distances",
        "params": {"n_neighbors": n_neighbors, "method": "umap",
                   "knn_method": method,
                   "knn_method_resolved": resolved,
                   "metric": "euclidean"},
    }


def neighbors(data, n_neighbors=15, n_pcs=None, use_rep=None, key_added=None,
              method="auto"):
    """Build the cell-cell graph: kNN + fuzzy connectivities.

    Drop-in for the role ``sc.pp.neighbors`` plays upstream of the
    reference: writes ``obsp['distances']`` (directed kNN distances),
    ``obsp['connectivities']`` (symmetric fuzzy weights, what ``tl``
    diffusion consumes), and ``uns['neighbors']`` metadata (including
    ``knn_method_resolved`` and, on the IVF path, the measured operating
    point under ``'ivf'``).  On ``cuda``, and on the IVF path
    (``method='ivf'``, or 'auto' above 262,144 cells) on any device, both
    obsp entries are device-resident lazy objects: scipy matrices
    materialize on demand (``.tocsr()``), and ``tl`` consumes the device
    graph directly.  The exact methods on the CPU store scipy CSR
    matrices.

    Representation: ``obsm[use_rep]`` if given, else ``obsm['X_pca']``
    (computed on the fly from ``data.X`` when absent), truncated to
    ``n_pcs`` components.  ``method``: see ``pp.knn.knn_search``.
    """
    from .pca import device_rep, pca

    prof = global_profiler()
    with prof.phase("neighbors"):
        if use_rep is None:
            if "X_pca" not in data.obsm:
                pca(data, n_comps=min(50, data.n_vars))
            rep = data.obsm["X_pca"]
        else:
            rep = data.obsm[use_rep]
        rep = device_rep(data, rep)  # skip the host round trip after pp.pca
        rep = rep if isinstance(rep, torch.Tensor) else as_tensor(rep)
        if n_pcs is not None:
            rep = rep[:, :n_pcs]

        resolved = resolve_method(data.n_obs, method, rep.device)
        if resolved == "ivf" or rep.device.type == "cuda":
            return _neighbors_device(data, rep, n_neighbors, method, resolved)

        with prof.phase("knn", cells=data.n_obs):
            idx_dev, d_dev = knn_device(rep, n_neighbors, resolved)
            # pull both (N, k) arrays exactly once, for the distances CSR
            indices, dists = fetch(idx_dev), fetch(d_dev)

        n = data.n_obs
        with prof.phase("fuzzy_graph", cells=n):
            # rows are already grouped: build the CSR directly from the kNN
            # layout (indptr is arithmetic) instead of a COO coalesce sort
            kk = n_neighbors - 1
            indptr = np.arange(0, n * kk + 1, kk, dtype=np.int64)
            dist_mat = sp.csr_matrix(
                (dists[:, 1:].ravel().copy(),
                 indices[:, 1:].ravel().astype(np.int32), indptr),
                shape=(n, n))
            dist_mat.sort_indices()

            conn = fuzzy_connectivities(idx_dev, d_dev)

        data.obsp["distances"] = dist_mat
        data.obsp["connectivities"] = conn
        data.uns["neighbors"] = _neighbors_meta(n_neighbors, method, resolved)
        return conn
