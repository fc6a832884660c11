"""Benchmark driver of cna_tpu_torch: end-to-end CNA association on one
NVIDIA card, the counterpart of ``bench.py``.

Emits ONE JSON line on standard output:
  {"metric": ..., "value": ..., "unit": ..., "vs_baseline": ..., "extras": {...}}

Workload (``bench.py``'s): a synthetic multi-sample dataset
(``data.synthetic_dataset``, 50 genes), the kNN graph built on the
device (``pp.pca(n_comps=20)``, ``pp.neighbors(n_neighbors=15)``), then
the whole association (NAM diffusion, residualization, permutation
global test, local FDR test).  ``value`` is the second (warm)
association's wall-clock seconds.

The sequence is ``bench.py``'s: a cold graph build (seed 0, which also
compiles the CUDA kernels when their build directory is empty), warm
builds on the data of seeds 1 and 2 (the phase profile on the second),
a cold association (permutation seed 0) and a warm one (seed 1) under
``utils.profiling``.  Every time is host wall-clock ending in
``torch.cuda.synchronize()``.

``vs_baseline`` and ``extras.ref`` are null: ``bench.py`` times the
scipy reference on the host, which needs a checkout of the reference
implementation that this repository does not carry.  No other baseline
stands in for it.  Nothing is JIT-compiled here, so in place of
``bench.py``'s compile counts ``extras`` records the launches of the
hand-written kernels per graph build and per association
(``kernel_launches``), the ``nvcc`` seconds of the cold run
(``kernel_build_s``, 0 when the kernels were built already), the peak
device memory and the card (``device``).

Scale knobs via env (``bench.py``'s, same defaults):
  CNA_BENCH_CELLS    total cells            (default 100000)
  CNA_BENCH_NNULL    permutations           (default 1000)
  CNA_BENCH_SAMPLES  samples                (default 50; 200 = the atlas
                                             configuration)

    python bench_torch.py            # on the card (raises without one)
    python bench_torch.py --cpu      # on the CPU
    CNA_BENCH_CELLS=1000000 CNA_BENCH_SAMPLES=200 CNA_BENCH_NNULL=10000 \\
        python bench_torch.py        # the north-star configuration
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def _on_card() -> bool:
    from cna_tpu_torch import config

    return config.device().type == "cuda"


def _sync() -> None:
    import torch

    if _on_card():
        torch.cuda.synchronize()


def make_data(n_cells, n_samples, seed=0):
    """``bench.py``'s dataset: ``n_samples`` samples of ``n_cells //
    n_samples`` cells x 50 genes (the archetype recipe), and its sample
    metadata."""
    from cna_tpu_torch.data import synthetic_dataset

    return synthetic_dataset(
        n_samples=n_samples, cells_per_sample=n_cells // n_samples,
        n_genes=50, seed=seed)


def _phase_seconds(prof, out):
    """Add the seconds of each phase ``prof`` recorded into ``out``."""
    for p in prof.phases:
        out[p["phase"]] = out.get(p["phase"], 0.0) + p["seconds"]
    return out


def build_graph(d, phases_out=None):
    """``pp.pca`` + ``pp.neighbors`` on ``d``; returns the seconds, the
    device work included.  ``phases_out``: a dict that receives the
    seconds of each ``utils.profiling`` phase of the build."""
    from cna_tpu_torch import pp
    from cna_tpu_torch.utils import profiling

    prof = profiling.enable_profiling() if phases_out is not None else None
    t0 = time.perf_counter()
    pp.pca(d, n_comps=20)
    pp.neighbors(d, n_neighbors=15)
    _sync()
    dt = time.perf_counter() - t0
    if prof is not None:
        _phase_seconds(prof, phases_out)
        profiling.disable_profiling()
    return dt


def run_association(d, y, nnull, seed=0, null_y=None):
    """``tl.association(d, y, "id", Nnull=nnull, seed=seed)``; returns
    (seconds, the full result).  ``null_y``: precomputed null phenotypes
    in place of the seeded permutations."""
    import cna_tpu_torch as ct

    t0 = time.perf_counter()
    res = ct.tl.association(d, y, "id", Nnull=nnull, seed=seed,
                            null_y=null_y, return_full=True)
    _sync()
    return time.perf_counter() - t0, res


def _card():
    """The card's name and its ``nvidia-smi`` name / power-limit line
    (None where there is no card or no ``nvidia-smi``)."""
    import torch

    if not _on_card():
        return {"name": "cpu", "nvidia_smi": None}
    line = None
    smi = shutil.which("nvidia-smi")
    if smi is not None:
        res = subprocess.run(
            [smi, "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
        if res.returncode == 0 and res.stdout.strip():
            line = res.stdout.strip().splitlines()[0]
    return {"name": torch.cuda.get_device_name(), "nvidia_smi": line}


def bench(n_cells=100_000, nnull=1000, n_samples=50, keep=None):
    """Run ``bench.py``'s sequence on the configured device; returns the
    record that ``main`` prints.  ``keep``: a dict that receives the
    cold-graph dataset (``d``), its phenotype (``y``) and the two
    association results (``res_cold``, ``res_warm``), for callers that
    check them further."""
    import torch

    from cna_tpu_torch.ops import _build, launch_counts, reset_launch_counts
    from cna_tpu_torch.utils import profiling

    def err(*parts):
        print(*parts, file=sys.stderr, flush=True)

    on_card = _on_card()
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    launches = {}

    def counted(name, fn, *args, **kw):
        reset_launch_counts()
        out = fn(*args, **kw)
        launches[name] = launch_counts()
        return out

    built = sum(_build.build_seconds().values())
    d, samplem = make_data(n_cells, n_samples)
    y = samplem["case"].astype(float)
    graph_cold_s = counted("graph_cold", build_graph, d)
    kernel_build_s = sum(_build.build_seconds().values()) - built
    err(f"# graph build ({n_cells} cells): cold {graph_cold_s:.2f}s "
        f"(kernel build {kernel_build_s:.2f}s of it)")

    # warm graph builds on new datasets in the same process; the second
    # one's phase profile makes its number attributable
    d2, _ = make_data(n_cells, n_samples, seed=1)
    graph_warm_first_s = counted("graph_warm_first", build_graph, d2)
    d2, _ = make_data(n_cells, n_samples, seed=2)
    graph_phases = {}
    graph_warm_s = counted("graph_warm", build_graph, d2,
                           phases_out=graph_phases)
    neighbors = d2.uns.get("neighbors", {})
    method = neighbors.get("params", {}).get("knn_method_resolved")
    err(f"# graph build ({n_cells} cells): warm {graph_warm_first_s:.2f}s "
        f"then {graph_warm_s:.2f}s method={method} "
        f"launches={launches['graph_warm']} phases={graph_phases}")

    cold_s, res_cold = counted("assoc_cold", run_association, d, y, nnull,
                               seed=0)
    prof = profiling.enable_profiling()
    warm_s, res_warm = counted("assoc_warm", run_association, d, y, nnull,
                               seed=1)
    profiling.disable_profiling()
    assoc_phases = _phase_seconds(prof, {})
    err(f"# association: cold {cold_s:.2f}s warm {warm_s:.2f}s "
        f"(p={res_warm.p:.4g}, k={res_warm.k}) phases={assoc_phases}")

    extras = {
        "graph_build_cold_s": graph_cold_s,
        "graph_build_warm_s": graph_warm_s,
        "graph_build_warm_first_s": graph_warm_first_s,
        "graph_warm_phases_s": graph_phases,
        "knn_method_resolved": method,
        **({"ivf": neighbors["ivf"]} if "ivf" in neighbors else {}),
        "assoc_cold_s": cold_s,
        "assoc_warm_phases_s": assoc_phases,
        "p": [float(res_cold.p), float(res_warm.p)],
        "k": [int(res_cold.k), int(res_warm.k)],
        "e2e_warm_s": graph_warm_s + warm_s,
        "kernel_launches": launches,
        "kernel_build_s": kernel_build_s,
        "peak_device_gb": (torch.cuda.max_memory_allocated() / 1e9
                           if on_card else None),
        "device": _card(),
        "cells": n_cells,
        "samples": n_samples,
        "nnull": nnull,
        # bench.py's reference timing needs the reference implementation,
        # which is not in this repository
        "ref": None,
    }
    if keep is not None:
        keep.update(d=d, y=y, res_cold=res_cold, res_warm=res_warm)
    return {
        "metric": f"association_e2e_{n_cells // 1000}k_cells_{nnull}perm",
        "value": warm_s,
        "unit": "s",
        "vs_baseline": None,
        "extras": extras,
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true",
                    help="compute on the CPU (default: the CUDA card)")
    args = ap.parse_args(argv)

    import warnings

    import cna_tpu_torch as ct

    if args.cpu:
        ct.config.set_device("cpu")
    warnings.filterwarnings("ignore")
    rec = bench(n_cells=int(os.environ.get("CNA_BENCH_CELLS", 100_000)),
                nnull=int(os.environ.get("CNA_BENCH_NNULL", 1000)),
                n_samples=int(os.environ.get("CNA_BENCH_SAMPLES", 50)))
    print(json.dumps(rec))


if __name__ == "__main__":
    main()
