"""``pp.umap`` cost at scale on the port: the counterpart of
``scripts/umap_profile.py``.

Builds the graph of CNA_UMAP_CELLS (default 500k) manifold cells on the
card, then times each layout stage SEPARATELY:

* the edge preparation and the period groups of the epoch engine
  (``pp.umap``'s ``umap_edges``), once;
* the spectral init (host LOBPCG) once, unless CNA_UMAP_SKIP_SPECTRAL is
  set, and the PCA init (the ``auto`` choice above 200k cells);
* the SGD epoch loop warm, with CUDA events, at CNA_UMAP_EPOCHS and at
  four times as many epochs: the two points separate the per-call fixed
  cost from the per-epoch rate;
* the sequential host baseline: ``scripts/umap_host_baseline.cpp`` (a
  -O3 C++ transliteration of umap-learn's ``optimize_layout_euclidean``
  inner loop, single thread), compiled unchanged with ``g++`` into a
  temporary directory and run on the same edges and initial positions.
  Without ``g++`` it says so on stderr and records ``host_baseline:
  null``; nothing stands in for it.

Prints the JSON record as its last line and writes it to ``--out``:

    python scripts/umap_profile_torch.py --out umap_profile.json
    CNA_UMAP_CELLS=5000 python scripts/umap_profile_torch.py --cpu
"""

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

BASELINE_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "umap_host_baseline.cpp")


def host_baseline(heads, tails, eps_edge, pos0, epochs):
    """Compile and run the C++ sequential baseline on these edges; its
    JSON record, or None (with a note on stderr) where ``g++`` is
    missing."""
    import numpy as np

    gxx = shutil.which("g++")
    if gxx is None:
        print("# umap_profile_torch: g++ not found; the host baseline is "
              "left out (host_baseline: null)", file=sys.stderr)
        return None
    with tempfile.TemporaryDirectory() as tmp:
        exe = os.path.join(tmp, "umap_host_baseline")
        subprocess.run([gxx, "-O3", "-march=native", "-o", exe,
                        BASELINE_SRC], check=True)
        binf = os.path.join(tmp, "edges.bin")
        with open(binf, "wb") as f:
            np.asarray([len(heads)], np.int32).tofile(f)
            np.asarray(heads, np.int32).tofile(f)
            np.asarray(tails, np.int32).tofile(f)
            np.asarray(eps_edge, np.float32).tofile(f)
            np.asarray(pos0, np.float32).reshape(-1).tofile(f)
        out = subprocess.run([exe, binf, str(pos0.shape[0]), str(epochs)],
                             capture_output=True, text=True, check=True)
    return json.loads(out.stdout)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true",
                    help="compute on the CPU (default: the CUDA card)")
    ap.add_argument("--out", help="write the JSON record here as well")
    args = ap.parse_args(argv)

    import torch

    import cna_tpu_torch as ct
    from cna_tpu_torch.pp.umap import (_SPECTRAL_AUTO_MAX_N, _fit_ab,
                                       _optimize_layout, _period_structure,
                                       _umap_edges, initial_layout,
                                       spectral_init)
    from cna_tpu_torch.utils.transfer import fetch

    if args.cpu:
        ct.config.set_device("cpu")
    dev = ct.config.device()
    on_card = dev.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    n = int(os.environ.get("CNA_UMAP_CELLS", 500_000))
    probe_epochs = int(os.environ.get("CNA_UMAP_EPOCHS", 12))
    host_epochs = int(os.environ.get("CNA_UMAP_HOST_EPOCHS", 3))
    d, _ = ct.data.synthetic_dataset(n_samples=50, cells_per_sample=n // 50,
                                     n_genes=50, seed=0,
                                     structure="manifold")
    n = d.n_obs
    t0 = time.perf_counter()
    ct.pp.pca(d, n_comps=20)
    ct.pp.neighbors(d, n_neighbors=15)
    sync()
    t_graph = time.perf_counter() - t0

    # the edges and period groups of pp.umap, on the device
    n_epochs_default = 500 if n <= 10_000 else 200
    conn = d.obsp["connectivities"]
    t0 = time.perf_counter()
    heads, tails, eps_edge = _umap_edges(conn, n_epochs_default)
    groups = _period_structure(heads, tails, eps_edge, n)
    sync()
    t_edges = time.perf_counter() - t0

    if os.environ.get("CNA_UMAP_SKIP_SPECTRAL"):
        pos_spectral, init_mode, t_init = None, "skipped", None
    else:
        csr = conn.tocsr()
        t0 = time.perf_counter()
        pos_spectral, init_mode = spectral_init(csr, n_components=2,
                                                seed=0)
        t_init = time.perf_counter() - t0
    t0 = time.perf_counter()
    pos_pca, _ = initial_layout(d, conn, "pca")
    t_init_pca = time.perf_counter() - t0
    auto_init = "spectral" if n <= _SPECTRAL_AUTO_MAX_N else "pca"
    auto_init_s = t_init_pca if auto_init == "pca" else t_init
    pos0 = pos_pca if pos_spectral is None else pos_spectral
    pos0_dev = torch.as_tensor(pos0, device=dev)
    a, b = _fit_ab()

    def run_epochs(epochs, seed):
        """Seconds of one ``_optimize_layout`` call: CUDA events on the
        card, the host clock on the CPU."""
        if not on_card:
            t0 = time.perf_counter()
            fetch(_optimize_layout(pos0_dev, groups, a, b, n_epochs=epochs,
                                   seed=seed))
            return time.perf_counter() - t0
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        _optimize_layout(pos0_dev, groups, a, b, n_epochs=epochs, seed=seed)
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop) / 1e3

    t_cold = run_epochs(probe_epochs, 0)
    t_warm = run_epochs(probe_epochs, 1)
    t_warm4 = run_epochs(4 * probe_epochs, 2)
    per_epoch = (t_warm4 - t_warm) / (3 * probe_epochs)
    fixed_s = max(t_warm - probe_epochs * per_epoch, 0.0)

    host = host_baseline(fetch(heads), fetch(tails), fetch(eps_edge), pos0,
                         host_epochs)
    host_rec = None
    if host is not None:
        host_per_epoch = host["seconds"] / host["epochs"]
        host_rec = {
            "impl": "scripts/umap_host_baseline.cpp: sequential C++ -O3 "
                    "transliteration of umap-learn's "
                    "optimize_layout_euclidean, 1 thread, same edges",
            "epochs": host["epochs"],
            "seconds": host["seconds"],
            "per_epoch_s": host_per_epoch,
            "projected_default_run_s": host_per_epoch * n_epochs_default,
            "per_epoch_vs_card": host_per_epoch / per_epoch
            if per_epoch > 0 else None,
        }

    out = {
        "cells": n,
        "edges": int(heads.shape[0]),
        "device": torch.cuda.get_device_name() if on_card else "cpu",
        "timer": "cuda events" if on_card else "host clock",
        "graph_build_s": t_graph,
        "edge_prep_s": t_edges,
        "spectral_init_s": t_init,
        "pca_init_s": t_init_pca,
        "probe_epochs": probe_epochs,
        "probe_cold_s": t_cold,
        "probe_warm_s": t_warm,
        "probe_warm_4x_s": t_warm4,
        "per_epoch_s": per_epoch,
        "layout_fixed_s": fixed_s,
        "projected_default_run_s": (
            per_epoch * n_epochs_default + fixed_s + auto_init_s + t_edges
            if auto_init_s is not None else None),
        "default_epochs": n_epochs_default,
        "init": init_mode,
        "auto_init": auto_init,
        "period_groups": [[g["period"], int(g["heads"].shape[0])]
                          for g in groups],
        "host_baseline": host_rec,
        "note": ("per_epoch_s is the incremental rate of a two-point "
                 f"({probe_epochs}/{4 * probe_epochs}-epoch) fit; "
                 "layout_fixed_s the per-call rest (negative table, first "
                 "gathers). The host baseline runs the same edges from the "
                 "same initial positions on one host thread."),
    }
    line = json.dumps(out)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)


if __name__ == "__main__":
    main()
