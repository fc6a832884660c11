"""Recall-vs-search-time curve of the port's fine-block IVF at atlas
scale: the counterpart of ``scripts/recall_curve.py``.

Builds the index once at CNA_CELLS (default 1M cells of the default
archetype structure, the north-star bench's data), takes exact-kNN truth
on a held-out sample of 512 queries once, runs the production search
(pilot calibration to ``min_recall=0.9``), then runs the FULL search at
fixed probe counts u around the production operating point (0.5 to 2
times its u), timing each warm search with CUDA events and measuring
its recall on the shared truth sample.  Each point also gives the
seconds of its index build and of its scoring phase
(``utils.profiling``) and its kernel launches.

Prints the JSON record as its last line and writes it to ``--out``:

    python scripts/recall_curve_torch.py --out recall_curve.json
    CNA_CELLS=4000 python scripts/recall_curve_torch.py --cpu --out r.json
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def _timed(fn, on_card):
    """(seconds, result) of ``fn()``: CUDA events around it on the card
    (the device work included), the host clock on the CPU."""
    import torch

    if not on_card:
        t0 = time.perf_counter()
        out = fn()
        return time.perf_counter() - t0, out
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / 1e3, out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true",
                    help="compute on the CPU (default: the CUDA card)")
    ap.add_argument("--out", help="write the JSON record here as well")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    import cna_tpu_torch as ct
    from cna_tpu_torch.ops import launch_counts, reset_launch_counts
    from cna_tpu_torch.pp.ivf import _recall_against, exact_knn_sample
    from cna_tpu_torch.pp.ivf_fine import (_bucket16, build_fine_index,
                                           ivf_knn_fine)
    from cna_tpu_torch.pp.pca import device_rep
    from cna_tpu_torch.utils import profiling
    from cna_tpu_torch.utils.transfer import fetch

    if args.cpu:
        ct.config.set_device("cpu")
    dev = ct.config.device()
    on_card = dev.type == "cuda"

    n = int(os.environ.get("CNA_CELLS", 1_000_000))
    k = int(os.environ.get("CNA_K", 15))
    # the default archetype structure, the north-star bench's data
    # (manifold data saturates recall near 1.0 at every probe count)
    d, _ = ct.data.synthetic_dataset(n_samples=200,
                                     cells_per_sample=n // 200,
                                     n_genes=50, seed=0)
    t0 = time.perf_counter()
    ct.pp.pca(d, n_comps=20)
    rep = torch.as_tensor(device_rep(d, d.obsm["X_pca"]),
                          dtype=torch.float32, device=dev)
    n = rep.shape[0]
    print(f"# pca: {time.perf_counter() - t0:.2f}s", flush=True)

    # the truth sample, taken once and shared by every probe count
    rng = np.random.RandomState(7)
    q_ix = rng.choice(n, min(512, n), replace=False)
    truth_s, truth = _timed(lambda: exact_knn_sample(rep, q_ix, k), on_card)
    print(f"# exact truth sample: {truth_s:.2f}s", flush=True)

    # the production search first: its u anchors the grid, and its
    # pilot and verification are the production path
    prod_s, res = _timed(lambda: ivf_knn_fine(rep, k, seed=0,
                                              min_recall=0.9), on_card)
    u_star = int(res.u)
    print(f"# production search: u={u_star} recall={res.recall:.3f} "
          f"({prod_s:.2f}s incl pilot+verify)", flush=True)

    grid = sorted({_bucket16(max(16, int(u_star * f)))
                   for f in (0.5, 0.75, 1.0, 1.5, 2.0)})

    # the index build alone, once (every point below rebuilds it the same
    # way: total_s - build_s is about the scoring)
    build_s, _ = _timed(lambda: build_fine_index(rep, n, rep.shape[1],
                                                 seed=0), on_card)

    points = []
    for u in grid:
        prof = profiling.enable_profiling()
        reset_launch_counts()
        dt, r = _timed(lambda: ivf_knn_fine(rep, k, seed=0, min_recall=None,
                                            u0=u), on_card)
        launches = launch_counts()
        profiling.disable_profiling()
        inv = np.empty(n, dtype=np.int64)
        inv[r.order] = np.arange(n)
        got = fetch(r.indices[torch.as_tensor(inv[q_ix], device=dev)])
        rec = _recall_against(r.order[got], truth, k)
        phases = {p["phase"]: p["seconds"] for p in prof.phases}
        searches = [p for p in prof.phases if p["phase"] == "ivf_search"]
        pt = {"u": int(r.u), "coverage": r.u * r.index.g / n,
              "total_s": dt, "recall": rec,
              "search_s": sum(p["seconds"] for p in searches),
              "search_u": [p["u"] for p in searches],
              "kmeans_s": phases.get("ivf_kmeans"),
              "layout_s": phases.get("ivf_layout"),
              "launches": launches}
        points.append(pt)
        print(f"# {json.dumps(pt)}", flush=True)

    out = {
        "cells": n, "k": k,
        "device": (torch.cuda.get_device_name() if on_card else "cpu"),
        "timer": "cuda events" if on_card else "host clock",
        "production": {"u": u_star,
                       "verify_recall": float(res.recall),
                       "search_s_incl_pilot": prod_s,
                       "pilot_curve": [list(map(float, h))
                                       for h in res.history]},
        "curve": points,
        "index_build_s": build_s,
        "truth_s": truth_s,
        "note": ("Full warm searches at fixed probe counts; total_s "
                 "includes the per-call index rebuild (index_build_s, the "
                 "same for every point) and search_s is the scoring phase "
                 "alone. Recall on one shared exact-truth sample of 512 "
                 "queries. The production pilot picks u to reach "
                 "min_recall=0.9; the curve shows the recall-vs-time "
                 "tradeoff around that operating point."),
    }
    line = json.dumps(out)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)


if __name__ == "__main__":
    main()
