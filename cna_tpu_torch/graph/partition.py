"""Graph-aware cell-axis partitioning for halo-exchange sharding.

The TPU package's ``graph/partition.py``.  The halo plan
(``parallel.halo``) blocks the cell axis into contiguous shards; its
exchange volume is the number of DISTINCT remote rows each shard's edges
reference.  A geometric ordering (kd bisection of the embedding,
``blocks.cluster_ordering``) helps but ignores the graph: on noisy kNN
graphs a long-range-edge tail keeps the ghost volume near the all-gather
bound.  This module partitions with the graph itself:

1. k-means the embedding into many small clusters (device matmuls, the
   same Lloyd update the IVF index uses, ``pp.ivf_fine``);
2. build the cluster-level edge-weight matrix (one bincount over edges);
3. assemble shards greedily: grow each shard by repeatedly pulling the
   unassigned cluster with the most edge weight into it, seeding each new
   shard with the cluster least connected to the remainder;
4. order the grown shards as a ring path, so that heavy shard boundaries
   sit at ring offset +-1 (the halo pads each offset to its largest pair).

Cells are then ordered shard by shard (clusters in insertion order), so
equal-size contiguous blocks of the ordering coincide with the grown
shards up to one cluster of slack.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import config
from ..utils.transfer import fetch
from .reorder import Reordering


def embedding_clusters(embedding, n_clusters, kmeans_iters=8,
                       kmeans_sample=262_144, seed=0) -> np.ndarray:
    """Per-row k-means cluster id of ``embedding`` (the clustering half of
    ``partition_ordering``), computed on the configured device in float32.
    Independent of the shard count: compute once and pass as ``cid=`` when
    partitioning the same dataset at several shard counts."""
    from ..pp.ivf_fine import _kmeans_sample_fit, kmeans_assign
    from ..utils.profiling import global_profiler

    if isinstance(embedding, torch.Tensor):
        x = embedding.to(torch.float32)
    else:
        x = torch.as_tensor(np.asarray(embedding, dtype=np.float32),
                            device=config.device())
    cent = _kmeans_sample_fit(x, int(n_clusters),
                              np.random.RandomState(seed), kmeans_sample,
                              kmeans_iters, global_profiler())
    return fetch(kmeans_assign(x.contiguous(), cent)[0].long())


def partition_clusters(n, n_shards, cluster_cells=64, max_clusters=4096):
    """The cluster count ``partition_ordering`` uses for ``n`` cells."""
    return int(min(np.clip(n // cluster_cells, n_shards, max_clusters), n))


def partition_ordering(conn, embedding, n_shards, cluster_cells=64,
                       max_clusters=4096, kmeans_iters=8,
                       kmeans_sample=262_144, seed=0,
                       cid=None) -> Reordering:
    """Locality ordering whose ``n_shards`` equal blocks have a small
    graph boundary.

    ``conn``: (N, N) scipy sparse graph; ``embedding``: (N, d) array or
    tensor (e.g. PCA scores) used only to seed the k-means clusters.
    ``cid``: optional precomputed ``embedding_clusters`` result (reuse
    across shard counts).
    """
    import scipy.sparse as sp

    conn = sp.csr_matrix(conn)
    n = conn.shape[0]
    if cid is None:
        nc = partition_clusters(n, n_shards, cluster_cells, max_clusters)
        cid = embedding_clusters(embedding, nc, kmeans_iters,
                                 kmeans_sample, seed)
    else:
        cid = np.asarray(cid, dtype=np.int64)
        nc = int(cid.max()) + 1

    # cluster-level edge weights (symmetrized)
    coo = conn.tocoo()
    pair = cid[coo.row] * nc + cid[coo.col]
    w = np.bincount(pair, weights=np.abs(coo.data),
                    minlength=nc * nc).reshape(nc, nc)
    w = w + w.T
    np.fill_diagonal(w, 0.0)
    sizes = np.bincount(cid, minlength=nc)

    target = n / n_shards
    unassigned = np.ones(nc, dtype=bool)
    cluster_order = np.empty(nc, dtype=np.int64)
    shard_of_cluster = np.empty(nc, dtype=np.int64)
    shard_bounds = [0]
    pos = 0
    shard_fill = 0
    attraction = np.zeros(nc)  # edge weight into the shard being grown
    while pos < nc:
        cand = np.flatnonzero(unassigned)
        if shard_fill == 0:
            # seed: the cluster least connected to everything unassigned
            c0 = cand[np.argmin(w[cand][:, cand].sum(axis=1))]
        else:
            c0 = cand[np.argmax(attraction[cand])]
        cluster_order[pos] = c0
        shard_of_cluster[c0] = len(shard_bounds) - 1
        pos += 1
        unassigned[c0] = False
        shard_fill += sizes[c0]
        attraction += w[c0]
        if shard_fill >= target:
            shard_fill = 0
            attraction[:] = 0.0
            shard_bounds.append(pos)
    if shard_bounds[-1] != nc:
        shard_bounds.append(nc)
    n_grown = len(shard_bounds) - 1

    # ring path over the grown shards: start at the least-connected one,
    # then hop to the unvisited shard the current one talks to most
    onehot = np.zeros((nc, n_grown))
    onehot[np.arange(nc), shard_of_cluster] = 1.0
    ws = onehot.T @ w @ onehot
    np.fill_diagonal(ws, 0.0)
    visited = np.zeros(n_grown, dtype=bool)
    cur = int(np.argmin(ws.sum(axis=1)))
    path = [cur]
    visited[cur] = True
    for _ in range(n_grown - 1):
        nxt_w = np.where(visited, -1.0, ws[cur])
        cur = int(np.argmax(nxt_w))
        path.append(cur)
        visited[cur] = True
    cluster_order = np.concatenate([
        cluster_order[shard_bounds[s]:shard_bounds[s + 1]] for s in path])

    rank = np.empty(nc, dtype=np.int64)
    rank[cluster_order] = np.arange(nc)
    perm = np.argsort(rank[cid], kind="stable")
    inv = np.empty(n, dtype=np.int64)
    inv[perm] = np.arange(n)
    return Reordering(perm=perm, inv=inv)
