"""Halo-exchange scaling figures of the port: the counterpart of
``scripts/halo_scaling.py`` (with ``scripts/build_graph_cache.py`` as the
``--cache`` option).

For each shard count D in (2, 4, 8, 16, 32) on the CNA_BENCH_CELLS
(default 100,000) manifold cells of CNA_BENCH_SAMPLES (default 200)
samples: the graph-partitioned halo plan's ghost fraction, the true and
padded exchange bytes per diffusion step against the all-gather
alternative (an (N, samples) float32 state), the partition and plan
seconds, and the per-shard SpMM operations.  For D <= 8 (the TPU script's
virtual device count) one halo step is also run and timed on a mesh of D
slots: CPU slots by default, as the TPU script ran on its virtual CPU
devices, or ``--slots cuda:0`` for D slots of the card (CUDA events).

The graph is built on the card (``--cpu``: on the CPU).  ``--cache
FILE.npz`` loads it from FILE when that exists, and else builds it and
saves it there (CSR arrays and the PCA scores), so that several runs
share one graph.

Prints the JSON record as its last line and writes it to ``--out``:

    python scripts/halo_scaling_torch.py --out halo_scaling.json
    python scripts/halo_scaling_torch.py --slots cuda:0 --out h.json
    CNA_BENCH_CELLS=4000 python scripts/halo_scaling_torch.py --cpu
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

SHARD_COUNTS = (2, 4, 8, 16, 32)
# shard counts up to this are run as well as planned
MEASURE_MAX_SHARDS = 8
ITEM = 4  # float32 state


def load_or_build_graph(ct, n_cells, n_samples, cache):
    """(CSR connectivities, PCA scores) of the manifold data: from
    ``cache`` if it exists, else built with ``pp.pca`` +
    ``pp.neighbors`` (and saved to ``cache`` if given)."""
    import numpy as np
    import scipy.sparse as sp

    if cache and os.path.exists(cache):
        z = np.load(cache)
        conn = sp.csr_matrix((z["data"], z["indices"], z["indptr"]),
                             shape=tuple(z["shape"]))
        return conn, z["x_pca"], "loaded"
    d, _ = ct.data.synthetic_dataset(
        n_samples=n_samples, cells_per_sample=n_cells // n_samples,
        n_genes=50, seed=0, structure="manifold")
    ct.pp.pca(d, n_comps=20)
    ct.pp.neighbors(d, n_neighbors=15)
    conn = d.obsp["connectivities"]
    conn = sp.csr_matrix(conn.tocsr() if hasattr(conn, "tocsr") else conn)
    x_pca = np.asarray(d.obsm["X_pca"])
    if cache:
        np.savez(cache, data=conn.data.astype(np.float32),
                 indices=conn.indices, indptr=conn.indptr,
                 shape=np.asarray(conn.shape), x_pca=x_pca)
    return conn, x_pca, "built"


def step_seconds(plan, n_shards, slots, s_cols, reps=3):
    """Seconds of one halo diffusion step over ``n_shards`` slots of
    ``slots`` (after a warm-up step): CUDA events on the card, the host
    clock on CPU slots."""
    import numpy as np
    import torch

    from cna_tpu_torch.parallel import halo, make_mesh

    mesh = make_mesh([slots] * n_shards, perms=1)
    n_pad = plan.n_shards * plan.shard_rows
    rng = np.random.default_rng(0)
    s = torch.as_tensor(rng.standard_normal((n_pad, s_cols)),
                        dtype=torch.float32)
    plan = halo.place_plan(plan, mesh)
    cur = halo.halo_diffusion_step(s, plan, mesh, 1.0)
    if torch.device(slots).type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            cur = halo.halo_diffusion_step(cur, plan, mesh, 1.0)
        return (time.perf_counter() - t0) / reps
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        cur = halo.halo_diffusion_step(cur, plan, mesh, 1.0)
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / 1e3 / reps


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true",
                    help="build the graph on the CPU (default: the card)")
    ap.add_argument("--slots", default="cpu",
                    help="device of the mesh slots of the measured steps "
                         "(default cpu; cuda:0 for the card)")
    ap.add_argument("--cache", help="graph npz to load, or to write once")
    ap.add_argument("--out", help="write the JSON record here as well")
    args = ap.parse_args(argv)

    import numpy as np
    import scipy.sparse as sp

    import cna_tpu_torch as ct
    from cna_tpu_torch.graph.partition import (embedding_clusters,
                                               partition_clusters,
                                               partition_ordering)
    from cna_tpu_torch.graph.reorder import permute_graph_unsorted
    from cna_tpu_torch.parallel.halo import build_halo_plan_csr

    if args.cpu:
        ct.config.set_device("cpu")
    ct.config.device()  # raises here, before any work, without a card

    n_cells = int(os.environ.get("CNA_BENCH_CELLS", 100_000))
    n_samples = int(os.environ.get("CNA_BENCH_SAMPLES", 200))
    s_cols = n_samples  # the diffusion state is (cells, samples)

    t0 = time.perf_counter()
    conn, x_pca, how = load_or_build_graph(ct, n_cells, n_samples,
                                           args.cache)
    graph_s = time.perf_counter() - t0
    print(f"# graph {how}: {graph_s:.1f}s nnz={conn.nnz}", flush=True)

    # a throwaway plan first takes the one-time costs (imports, first
    # allocations) that would otherwise land on the first shard count
    warm = sp.random(4096, 4096, density=0.002, random_state=0,
                     format="csr")
    build_halo_plan_csr((warm + warm.T).tocsr(), 2)

    # the k-means clustering does not depend on the shard count: once
    t0 = time.perf_counter()
    cid = embedding_clusters(x_pca, partition_clusters(conn.shape[0],
                                                       max(SHARD_COUNTS)))
    t_cluster = time.perf_counter() - t0
    print(f"# clustering: {t_cluster:.1f}s", flush=True)

    rows = []
    for n_shards in SHARD_COUNTS:
        t0 = time.perf_counter()
        ordering = partition_ordering(conn, x_pca, n_shards, cid=cid)
        t_order = time.perf_counter() - t0
        t0 = time.perf_counter()
        plan = build_halo_plan_csr(permute_graph_unsorted(conn, ordering),
                                   n_shards)
        t_plan = time.perf_counter() - t0
        stats = plan.exchange_stats(s_cols, ITEM)
        row = {
            "n_shards": n_shards,
            "ghost_fraction": stats["ghost_fraction"],
            "ghost_bytes_per_step": stats["ghost_bytes"],
            "padded_bytes_per_step": stats["padded_bytes"],
            "allgather_bytes_per_step": stats["allgather_bytes"],
            "padded_vs_ghost": (stats["padded_bytes"]
                                / max(stats["ghost_bytes"], 1)),
            "bytes_vs_allgather": (stats["padded_bytes"]
                                   / stats["allgather_bytes"]),
            "exchange_rounds": stats["rounds"],
            # per-shard SpMM work a step: padded bucket area x state width
            "flops_per_shard_per_step": 2 * plan.padded_area() * s_cols,
            "partition_s": t_order,
            "plan_build_s": t_plan,
            "local_padded_area": plan.padded_area(),
        }
        if n_shards <= MEASURE_MAX_SHARDS:
            row["measured_step_s"] = step_seconds(plan, n_shards,
                                                  args.slots, s_cols)
        rows.append(row)
        print(f"# {json.dumps(row)}", flush=True)

    out = {
        "workload": {"cells": int(conn.shape[0]), "samples": n_samples,
                     "n_neighbors": 15, "structure": "manifold",
                     "state_cols": s_cols, "itemsize": ITEM},
        "graph": {"how": how, "seconds": graph_s, "nnz": int(conn.nnz),
                  "device": str(ct.config.device())},
        "slots": args.slots,
        "note": ("Per-diffusion-step exchange bytes of the graph-"
                 "partitioned halo plan against the all-gather, the plan's "
                 "cost and the per-shard SpMM operations, per shard count; "
                 "measured_step_s is one halo step on a mesh of that many "
                 "slots of one device, so it shows the plan running and "
                 "no interconnect."),
        "scaling": rows,
        "clustering_s": t_cluster,
    }
    line = json.dumps(out)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)


if __name__ == "__main__":
    main()
