#!/usr/bin/env python3
"""Smoke run of cna_tpu_torch on one NVIDIA card (H100).

    python3 chip_smoke.py

Phases, each of which must pass (any failure exits non-zero):

1. card: name and power limit (``nvidia-smi``);
2. build: every CUDA kernel of the package, compiled by ``nvcc`` from
   ``cna_tpu_torch/csrc`` into ``cna_tpu_torch/_build`` (one ``nvcc`` per
   source, started together);
3. kernels: each kernel against its plain PyTorch version on the card, at
   its main path's shape and at extra shapes (for the two kNN kernels also
   inputs that attack their TF32 candidate filter: a large common offset,
   a tiny spread, duplicated points, blocks of identical rows; for the
   banded kernel rows that are all full and counts from 0 to K within a
   warp); timed with CUDA events beside its bound and a PyTorch library
   yardstick;
4. the 100,000-cell path: synthetic data (50 samples x 2,000 cells x 50
   genes) -> ``pp.pca`` -> ``pp.neighbors`` (the exact kNN kernel, the
   device-resident graph) -> ``tl.association`` with 1,000 permutations;
5. the 1,000,000-cell path: 50 samples x 20,000 cells x 50 genes ->
   ``pp.pca`` (chunked) -> ``pp.neighbors`` (auto -> the IVF index and its
   scoring kernel -> the device-resident graph) -> ``tl.association`` with
   1,000 permutations; then the scoring kernel against its plain version
   on that index's own layout and calibrated probe count, and the k-means
   assignment kernel at that build's shapes (its 524,288 sampled rows
   against 10,416 initial centroids) held to float64 and to its plain
   version, timed beside its bound, the plain version and the step it
   replaced;
6. IVF against exact at 100,000 cells: the data of phase 4 through
   ``method='ivf'``, held to phase 4's exact-graph result;
7. card vs CPU: the same chain at 5,000 cells on cuda in float32 and on
   the CPU in float64, stage by stage (PCA scores, kNN lists up to
   near-ties, fuzzy graph weights, the NAM diffused from the card's own
   graph) and end to end (diffusion steps, k);
8. the banded path: 1,000,000 cells on continuous trajectories (50
   samples x 20,000 cells x 50 genes, ``structure="manifold"``) ->
   ``pp.pca`` -> ``pp.neighbors`` -> ``tl.association`` under the default
   graph format, then ``tl.set_graph_format(d, 'banded')`` (host packing
   of the locality-ordered graph, timed by phase) and the same call
   twice, every diffusion step through the banded SpMM kernel; held to
   the default format's result, and the kernel timed at that graph's own
   shape beside its plain version, its bound and ``torch.sparse.mm``;
9. 'block' and 'hybrid' at 100,000 cells (manifold), each held to 'ell';
10. the atlas entry path at 100,000 cells: a sparse count matrix of 50
    samples x 2,000 cells x 20,000 genes (about 1,000 non-zeros a cell,
    the first 50 genes carrying the case signal of the trajectory data)
    made on the card ->
    ``pp.select_hvg(n_top=2000)`` (the same genes as on the CPU from the
    same matrix, the 50 signal genes among them) -> ``pp.pca(n_comps=50)``
    -> ``pp.neighbors`` (one exact kNN kernel launch) -> ``tl.association``
    (p < 0.05) -> ``pp.umap`` twice (spectral init, 200 epochs, the same
    bits both times, ``tests/test_umap.py``'s layout quality bar).  With
    h5py the matrix first goes through ``write_h5ad`` -> ``read_h5ad``
    and the result through ``CellData.write`` -> ``read_h5ad`` (X, obs,
    obsm and obsp equal bit for bit); with matplotlib ``pl.umap_ncorr``
    and ``pl.violinplot`` draw a PNG.  Neither package is a dependency of
    the port: without h5py the path starts from and stops at the
    in-memory CellData, without matplotlib it draws no picture, and the
    line before the path says which steps ran.  The file and plot layers
    are held to the TPU package by the CPU tests
    (``tests/test_torch_io.py``, ``tests/test_torch_umap.py``);
11. mesh, several slots on this one card (``parallel``): (a) phase 8's
    1,000,000-cell manifold graph, default format, through
    ``tl.association(mesh=)`` under ``make_mesh(["cuda:0"] * 4)`` (4
    cells x 1 perm) and ``perms=2`` (2 x 2, which takes the mesh FDR):
    path 'halo', p and k equal to phase 8's single-device result,
    ``ncorrs`` and the NAM within phase 8's format gates; the halo plan's
    seconds (partition, plan), ghost fraction, rounds and bytes per step,
    and ms per halo step (CUDA events) beside the default format's step;
    (b) phase 5's 1,000,000 archetype points through
    ``pp.ivf_knn(devices=["cuda:0", "cuda:0"])``: ids and distances equal
    to the one-device search bit for bit, ``ivf_score`` launched once per
    device; (c) a process group of one over NCCL (``launch.
    initialize_distributed`` on a ``file://`` store), ``launch.global_mesh``
    of two slots and phase 4's association through it, with
    ``assert_agreement`` on p and ``ncorrs`` through NCCL's all-gather.
    One card shows the partition, the plan, the exchange rounds and the
    sharded nulls running; it cannot show an interconnect (the exchange
    is device-local copies) or a two-card NCCL exchange.

12. the north-star configuration (``bench.py``'s knobs
    ``CNA_BENCH_CELLS=1000000 CNA_BENCH_SAMPLES=200 CNA_BENCH_NNULL=10000``)
    through ``bench_torch.bench``: 200 samples x 5,000 cells, a cold graph
    build and warm ones on two more datasets (auto -> IVF -> the scoring
    kernel), two associations of 10,000 permutations; its JSON line is
    logged and (a) gated: kNN method 'ivf', verify recall >= 0.9, at least
    one scoring kernel launch per graph build, finite p in (0, 1] and
    k >= 1 for both associations.  (b) The cold association's seed again:
    equal p and k, ``ncorrs`` correlation above 0.99999 (the COO tail sums
    with atomics); ms per diffusion step of that graph at 200 and at 50
    columns.  (c) The local test's fused FDR branch (1M cells x 1,000
    nulls) against the dense (cells x nulls) matrix on one residualized
    NAM and one ``null_y``.  (d) Phase 7 again at 200 samples x 500 cells
    (100,000 cells), with its limits.  (e) ``bench_torch.bench()`` at its
    defaults (100,000 cells x 50 samples x 1,000 permutations): one exact
    kNN kernel launch per graph build.
13. the diffusion step's gather SpMM at the main paths' shapes: phase
    4's 100,000-cell graph at 50 columns, and the graph of the
    tuberculosis-atlas deployment (``cnabench/configs/tb_500k.json``:
    500,089 cells, auto -> IVF) at 259 columns: one launch a step, held
    to the plain step and to the float64 CPU step, two launches
    bit-identical; the kernel, the whole step, the plain step and
    ``torch.sparse.mm`` of the same graph's CSR (the library yardstick,
    never called by the package) timed with CUDA events beside the
    step's bytes bound; the peak memory a step adds, kernel and plain.

Phase 5 also lays out its 1,000,000-cell IVF graph with ``pp.umap``
(init 'auto' -> 'pca', 200 epochs): the edge, init and SGD seconds, ms per
epoch (CUDA events, a second run of the epochs held to the first bit for
bit), the least bytes an epoch moves and their time at the card's memory
rate, and the layout quality bar on 2,000 cells.

Each path of phases 4, 5, 8, 10 and 11 (b) runs with the kernel launch
counts set to 0 just before it (phase 10: before ``pp.neighbors``) and
read just after; phase 12's bench does so around each graph build and
each association.

The last two lines of standard output are a JSON object describing each
kernel and the ``{"ok": true, "device": ...}`` line.  Without a CUDA
device, or without the package beside this file, it exits non-zero and
prints no result.

    python3 chip_smoke.py --against DIR

also runs the package of another checkout at DIR (for example the parent
commit, unpacked with ``git archive``) in a second process on the same
card: its ``knn_exact`` on the inputs of every ``KNN_CASES`` shape and
attack case, and its 100,000-cell path (phase 4); the ids and distances,
and the path's p, k, ``ncorrs`` and NAM, must equal this checkout's bit
for bit.
"""

from __future__ import annotations

import importlib.util
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# published H100 SXM peaks (data sheet, 700 W): float32 outside the
# tensor cores, dense TF32 on them, and HBM3 bandwidth
PEAK_FP32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_BYTES_PER_S = 3.35e12
# the dense bf16/fp16 peak that cnabench/peaks.json charges every kernel's
# roofline with, whatever type it computes in
PEAK_DENSE_FLOPS = 989e12
# MMA passes the scoring kernel spends on a distance tile (1: operands
# centred on the query block's centroid, one TF32 product; 3 would be the
# hi/lo split)
IVF_MMA_PASSES = 1

KNN_CASES = [(100_000, 20, 15), (1_037, 7, 5), (20_011, 50, 64)]
# inputs chosen against knn_exact's TF32 candidate filter and the corners of
# its dispatch, (label, n, d, k, kind): a common offset 1,000 times the
# spread; a spread of 1e-3 around it, which float32 resolves to a few
# digits; every point four times (ties at every rank, a first distance of 0
# that belongs to the lowest id of the copies); a block of 300 identical
# rows, longer than a thread block's 128; N not a multiple of 128; every D
# of the list {3, 7, 50, 128} and every k of {1, 15, 64, 128}
KNN_ATTACKS = [
    ("offset 1e3 x spread", 4_000, 20, 15, "offset"),
    ("spread 1e-3 around 1e3", 4_000, 20, 15, "tiny_spread"),
    ("every point four times, k=1", 4_000, 20, 1, "duplicates"),
    ("every point four times, k=15", 4_000, 20, 15, "duplicates"),
    ("every point four times, k=64", 4_000, 20, 64, "duplicates"),
    ("300 identical rows, k=128", 3_000, 20, 128, "identical"),
    ("N=5,001", 5_001, 20, 15, "random"),
    ("D=3, k=64", 3_000, 3, 64, "random"),
    ("D=7, k=1", 3_000, 7, 1, "random"),
    ("D=50, k=128", 3_000, 50, 128, "random"),
    ("D=128, k=15", 3_000, 128, 15, "random"),
]
# MMA passes knn_exact spends on a distance tile (one TF32 product, the
# operands centred on the mean of x)
KNN_MMA_PASSES = 1
DIST_ATOL = 1e-3  # float32 squared distances summed in different orders
# the kNN kernels' sorted distances against the plain versions', rank by
# rank, relative to the row's k-th distance (both are direct float32 sums of
# (q - x)^2; the plain versions go through a square root): holds at any
# scale of the data, where DIST_ATOL is blind below 1e-3
RANK_RTOL = 1e-4
# the k-means assignment at the 1M IVF build's shapes: its 524,288 sampled
# rows (seed 0) against the initial 10,416 centroids (n // 96), d = 20
KMEANS_SAMPLE = 524_288
KMEANS_ROWS_PER_CLUSTER = 96
KMEANS_CHUNK = 32_768  # the yardstick's row chunk
# the plain version picks by |c|^2 - 2 q.c in float32, each side within
# about (d + 2) 2^-24 (|q|^2 + 2 |c|^2) of its value, so two centroids it
# cannot tell apart lie within twice that of each other in float64: a row
# where kernel and plain differ must hold |D(a) - D(p)| <= KMEANS_TIE_ULPS
# (d + 2) 2^-24 (|q|^2 + |c_a|^2 + |c_p|^2)
KMEANS_TIE_ULPS = 4.0
# the exact path's float32 sum of d squares is within (d + 4) 2^-24 of its
# float64 value, relatively (csrc/dist_tile.cuh, item 6); the kernel's pick
# must lie within twice that of the float64 nearest centroid
KMEANS_EXACT_ULPS = 2.0
# the scoring kernel at the 1M-cell index is held to its plain version on
# every IVF_SHARE-th slot (the plain version's direct-difference distance
# tiles take minutes over all slots); the kernel alone is also timed over
# all slots
IVF_SHARE = 32
IVF_MIN_RECALL = 0.9
# IVF graph against the exact graph at 100,000 cells
IVF_NCORR_MIN = 0.97
# card (float32) vs CPU (float64) at 5,000 cells, each stage on the same
# input: float32 PCA scores; kNN lists that differ only by near-ties (a
# float32 distance is off by ~1e-6 relative); fuzzy weights from the same
# kNN lists; the NAM diffused from the same graph
PCA_RTOL = 1e-4
KNN_SHARE_MIN = 0.9999
TIE_ATOL = 1e-4
GRAPH_RTOL = 1e-4
NAM_RTOL = 1e-4
# fuzzy weights from the same PCA scores: a weight's exponent
# (d - rho) / sigma carries the float32 distance error divided by sigma,
# so the error is absolute, w * delta <= delta (a CPU float32 run: 4.4e-5)
GRAPH_F32_DIST_ATOL = 5e-4


# banded SpMM kernel vs its plain version on the card, relative to max|y|:
# float32 sums in another order; float64 likewise at its own precision
BANDED_RTOL = {"float32": 1e-5, "float64": 1e-12}
# the banded format against the default format at 1,000,000 cells, and the
# block formats against 'ell' at 100,000 (float32 states, other sum order)
FORMAT_NAM_RTOL = 1e-4
FORMAT_NCORR_MIN = 0.9999
FORMAT_NSTEPS = 3  # diffusion steps of the fixed-step NAM comparisons
# phase 13, the gather SpMM: the kernel's step against the plain step on
# the card, relative to max|y| (float32 sums in another order), and against
# the float64 step of the same graph and state on the CPU (float32 inputs
# and arithmetic: about 22 rounded terms a row)
GATHER_RTOL = 1e-5
GATHER_CPU_RTOL = 1e-5
GATHER_REPS = 20

# phase 12, the north-star configuration: bench.py's knobs
# CNA_BENCH_CELLS=1000000 CNA_BENCH_NNULL=10000 CNA_BENCH_SAMPLES=200 (the
# configuration of BENCH_NORTHSTAR_r05.json) through bench_torch.bench, as
# (cells, permutations, samples)
NORTHSTAR = (1_000_000, 10_000, 200)
# card vs CPU again at 200 samples x 500 cells, the north-star's width
WIDE_CARD_VS_CPU = (200, 500)
# one seed twice on the card: the default format's COO tail sums with
# index_add_ atomics (ops/spmm.py), so the two NAMs differ in the last bits
# and ncorrs correlate, not agree bit for bit
SAME_SEED_NCORR_MIN = 0.99999
# the fused FDR branch against the dense one on the same inputs: both
# bucket float32 null coefficients, the fused one scaled by a float32 1/n
# and computed in 32,768-cell blocks, the dense one divided by n in one
# product, so a coefficient within an ulp of a threshold may land on the
# other side of it (a few of the 1e9); and the dense curve divides its
# counts in float32, the fused one in float64 (~1e-7 relative)
FDR_FUSED_RTOL = 1e-4
FDR_FUSED_ATOL = 1e-6

# phase 10, the atlas entry path: 20,000 genes, the first 50 carrying
# synthetic_dataset's case signal (its continuous trajectories, structure
# 'manifold') as Poisson counts of SIGNAL_SCALE * exp(SIGNAL_GAIN * z), z
# each gene's values standardised; the rest background genes whose means
# are lognormal, exp(N(-3.95, 1.5^2)): about 1,000 non-zeros a cell in all
ATLAS_GENES = 20_000
SIGNAL_GENES = 50
SIGNAL_SCALE = 2.0
SIGNAL_GAIN = 1.0
BACKGROUND_LOG_MEAN = -3.95
BACKGROUND_LOG_SD = 1.5
HVG_TOP = 2000
# tests/test_umap.py's layout quality bar
UMAP_RATIO_MAX = 0.35
UMAP_NULL_MIN = 0.8


def log(*parts):
    print(*parts, flush=True)


def card_line():
    smi = shutil.which("nvidia-smi")
    if smi is None:
        return None
    res = subprocess.run(
        [smi, "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    return res.stdout.strip().splitlines()[0] if res.returncode == 0 else None


def cuda_ms(fn, reps):
    """Mean milliseconds per call of ``fn`` on the card, after a warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def library_knn(x, k, block=4096):
    """The yardstick: blocked ``torch.cdist`` + ``torch.topk`` (never used
    by the package)."""
    import torch

    for s in range(0, x.shape[0], block):
        torch.topk(torch.cdist(x[s:s + block], x), k, dim=1, largest=False)


def knn_input(kind, n, d, seed):
    """An (n, d) float32 input on the card for ``check_knn_case``: 'random'
    (standard normal) or one of the attacks of ``KNN_ATTACKS``."""
    import torch

    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    x = torch.randn(n, d, generator=gen, device="cuda")
    if kind == "offset":
        x = x + 1000.0
    elif kind == "tiny_spread":
        x = x * 1e-3 + 1000.0
    elif kind == "duplicates":
        base = x[: n // 4]
        x = base.repeat(4, 1)[torch.randperm(n, generator=gen,
                                             device="cuda")]
    elif kind == "identical":
        x[100:400] = x[100]
    elif kind != "random":
        raise ValueError(f"unknown kNN input {kind!r}")
    return x.contiguous()


def check_knn_case(label, x, k, timed):
    """knn_exact vs its plain version on one input; returns a record (with
    times, bound, yardstick, exact-path share and a digest of the output
    when ``timed``)."""
    import torch

    from cna_tpu_torch.ops import knn

    n, d = x.shape
    stats = torch.zeros(knn.N_STATS, dtype=torch.int64, device="cuda")
    negd, idx = knn.knn_exact(x, k, stats=stats)
    torch.cuda.synchronize()
    counters = [int(v) for v in stats.cpu()]
    again = knn.knn_exact(x, k)
    if not (torch.equal(again[0], negd) and torch.equal(again[1], idx)):
        raise AssertionError(f"knn_exact {label}: two runs on the same input "
                             "differ")
    del again
    p_negd, p_idx = knn.knn_exact_plain(x, k)
    torch.cuda.synchronize()
    dk, dp = -negd, -p_negd
    what = f"knn_exact {label} ({n}x{d}, k={k})"

    # the first distance is exactly 0 and belongs to the lowest id among
    # the row and its exact copies (the row itself where it has none)
    if bool((dk[:, 0] != 0).any()):
        raise AssertionError(f"{what}: a first distance is not exactly 0")
    _, group = torch.unique(x, dim=0, return_inverse=True)
    rows = torch.arange(n, device="cuda")
    first = torch.full((n,), n, device="cuda", dtype=torch.int64).scatter_reduce(
        0, group, rows, reduce="amin")
    if not bool((idx[:, 0].long() == first[group]).all()):
        raise AssertionError(f"{what}: a row does not start with the lowest "
                             "id of its copies")
    if not bool((torch.diff(dk, dim=1) >= 0).all()):
        raise AssertionError(f"{what}: distances not ascending")
    # among equal distances the lower id comes first
    tied = dk[:, 1:] == dk[:, :-1]
    if not bool((idx[:, 1:] > idx[:, :-1])[tied].all()):
        raise AssertionError(f"{what}: ids at equal distance do not ascend")
    err = float((dk - dp).abs().max())
    if err > DIST_ATOL:
        raise AssertionError(f"{what}: sorted distances differ from the "
                             f"plain version by {err}")
    kth = dp[:, -1:]
    rank_err = float(torch.where(kth > 0, (dk - dp).abs() / kth.clamp(
        min=1e-30), (dk - dp).abs()).max())
    if rank_err > RANK_RTOL:
        raise AssertionError(f"{what}: sorted distances differ from the "
                             f"plain version by {rank_err} of the row's "
                             "k-th distance")
    # the ids must carry the distances reported for them, bit for bit: the
    # kernel's arithmetic is one fmaf chain in coordinate order, which
    # torch's sum is not, so within float32 rounding
    recomputed = ((x[idx.long()] - x[:, None, :]) ** 2).sum(-1)
    id_err = float(torch.where(kth > 0, (recomputed - dk).abs()
                               / kth.clamp(min=1e-30),
                               (recomputed - dk).abs()).max())
    if id_err > RANK_RTOL:
        raise AssertionError(f"{what}: ids disagree with their distances by "
                             f"{id_err}")
    # recall with ties allowed: an id the plain version lacks counts as a
    # miss only if it is strictly closer than the plain k-th distance
    same = (idx.long()[:, :, None] == p_idx.long()[:, None, :]).any(-1)
    tie = dk >= kth * (1.0 - RANK_RTOL)
    recall = float((same | tie).float().mean())
    if recall != 1.0:
        raise AssertionError(f"{what}: recall {recall}")

    rec = dict(label=label, n=n, d=d, k=k, max_abs_err=err,
               max_rank_err=rank_err, recall=recall,
               same_id_share=float(same.float().mean()),
               # candidates whose exact float32 distance the kernel
               # computed, of the (row, candidate) pairs it met
               exact_candidates=counters[0], pairs=counters[1],
               exact_share=counters[0] / max(counters[1], 1))
    if timed:
        cycles = sum(counters[2:])
        rec["mma_warp_cycles"] = dict(
            waiting_for_keys=counters[2] / cycles,
            filter=counters[3] / cycles, exact_path=counters[4] / cycles)
        rec["digest"] = knn_digest(negd, idx)
        rec["device_us_by_kernel"] = device_us_by_kernel(
            lambda: knn.knn_exact(x, k), 3)
        rec["ms"] = cuda_ms(lambda: knn.knn_exact(x, k), 5)
        rec["plain_ms"] = cuda_ms(lambda: knn.knn_exact_plain(x, k), 2)
        rec["library_ms"] = cuda_ms(lambda: library_knn(x, k), 2)
        rec.update(knn_bound(n, d, k))
    return rec


def device_us_by_kernel(fn, reps):
    """Device microseconds per call of each CUDA kernel that ``fn``
    launches (``torch.profiler``, mean over ``reps`` calls), or the reason
    the profiler gave none."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        out = {}
        for ev in prof.key_averages():
            us = getattr(ev, "device_time_total", None)
            if us is None:
                us = getattr(ev, "cuda_time_total", 0.0)
            if us > 0:
                name = ev.key.replace("(anonymous namespace)::", "")
                out[name.replace("void ", "").split("(")[0][:60]] = us / reps
        return out or "no device time in the trace"
    except Exception as exc:  # the trace is a reading, not a gate
        return f"not measured: {exc}"


def knn_digest(negd, idx):
    """SHA-256 of the bytes of a kNN result, ids and distances apart, so
    that a later kernel's output can be held to this one's."""
    import hashlib

    return dict(
        ids=hashlib.sha256(idx.cpu().numpy().tobytes()).hexdigest(),
        neg_sq_dists=hashlib.sha256(negd.cpu().numpy().tobytes()).hexdigest())


def knn_bound(n, d, k):
    """The least time the card could take for an exact self-kNN: its 2 N^2
    D operations at the card's peak for the type the kernel runs them in,
    dense TF32 on the tensor cores, times the MMA passes the design spends
    on them, against its bytes (x read once, the output written once).
    ``fp32_bound_ms`` keeps the figure the kernel's row had while it ran on
    the CUDA cores: the same operations at the float32 peak."""
    flops = 2.0 * n * n * d
    nbytes = 4.0 * n * d + 8.0 * n * k
    t_ops = KNN_MMA_PASSES * flops / PEAK_TF32_FLOPS
    t_bytes = nbytes / PEAK_BYTES_PER_S
    return dict(flops=flops, bytes=nbytes, bound_ms=1e3 * max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes",
                mma_passes=KNN_MMA_PASSES,
                fp32_bound_ms=1e3 * max(flops / PEAK_FP32_FLOPS, t_bytes))


def knn_inputs():
    """(label, x, k) of every ``KNN_CASES`` shape and ``KNN_ATTACKS``
    input, made from their seeds on the card."""
    out = [(f"{n}x{d} k={k}", knn_input("random", n, d, seed=i), k)
           for i, (n, d, k) in enumerate(KNN_CASES)]
    out += [(label, knn_input(kind, n, d, seed=100 + i), k)
            for i, (label, n, d, k, kind) in enumerate(KNN_ATTACKS)]
    return out


def random_layout(f_pad, g, d, seed, n_dummy, min_count):
    """A random fine-block layout on the card: (x4, counts, csum) with
    ragged live counts and ``n_dummy`` trailing dummy (count-0) blocks."""
    import torch

    from cna_tpu_torch.ops import ivf

    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    x4 = torch.randn(f_pad, g, ivf.kernel_d_pad(d), generator=gen,
                     device="cuda")
    x4[:, :, d:] = 0.0
    counts = torch.randint(min_count, g + 1, (f_pad,), generator=gen,
                           device="cuda", dtype=torch.int32)
    if n_dummy:
        counts[-n_dummy:] = 0
    csum = (torch.cumsum(counts, 0) - counts).to(torch.int32)
    return x4, counts, csum


def library_score(x4, sel, probes, counts, k, g, q_blocks, batch=8):
    """The yardstick: blocked ``torch.bmm`` + ``torch.topk`` over the
    gathered candidate blocks (never used by the package)."""
    import torch

    f_pad, _, d_pad = x4.shape
    within = torch.arange(g, device=x4.device)
    for lo in range(0, sel.shape[0], batch):
        s = sel[lo:lo + batch].long()
        nb = s.shape[0]
        qblk = s[:, None] * q_blocks + torch.arange(q_blocks,
                                                    device=x4.device)
        q = x4[qblk].reshape(nb, q_blocks * g, d_pad)
        ids = probes[lo:lo + nb].long()
        cand = x4[ids].reshape(nb, -1, d_pad)
        d2 = ((q * q).sum(-1)[:, :, None] + (cand * cand).sum(-1)[:, None, :]
              - 2.0 * torch.bmm(q, cand.transpose(1, 2)))
        live = (within[None, None, :] < counts[ids].long()[:, :, None])
        d2 = torch.where(live.reshape(nb, 1, -1), d2, float("inf"))
        torch.topk(d2, k, dim=2, largest=False)


def check_ivf_case(label, x4, sel, probes, counts, csum, k, g, q_blocks,
                   timed):
    """The scoring kernel vs its plain version on one input; returns a
    record (with times, bound and yardstick when ``timed``)."""
    import torch

    from cna_tpu_torch.ops import ivf

    args = (x4, sel, probes, counts, csum, k)
    stats = torch.zeros(2, dtype=torch.int64, device="cuda")
    negd, idx = ivf.score_blocks(*args, g=g, q_blocks=q_blocks, stats=stats)
    torch.cuda.synchronize()
    n_exact, n_pairs = (int(v) for v in stats.cpu())
    again = ivf.score_blocks(*args, g=g, q_blocks=q_blocks)
    if not (torch.equal(again[0], negd) and torch.equal(again[1], idx)):
        raise AssertionError(f"ivf_score {label}: two runs on the same "
                             "input differ")
    del again
    p_negd, p_idx = ivf.score_blocks_plain(*args, g=g, q_blocks=q_blocks)
    torch.cuda.synchronize()
    ns, mq, _ = negd.shape
    f_pad, _, d_pad = x4.shape

    qblk = (sel.long()[:, None] * q_blocks
            + torch.arange(q_blocks, device="cuda"))  # (ns, q_blocks)
    within = torch.arange(g, device="cuda")
    live = (within[None, None, :]
            < counts[qblk].long()[:, :, None]).reshape(ns, mq)
    found, p_found = torch.isfinite(negd), torch.isfinite(p_negd)
    self_blocks = (probes.long()[:, None, :] == qblk[:, :, None]).any(-1)
    self_rows = (self_blocks[:, :, None] & live.reshape(ns, q_blocks, g)
                 ).reshape(ns, mq)
    if bool((negd[..., 0][self_rows] != 0).any()):
        raise AssertionError(f"ivf_score {label}: a row that probes its own "
                             "block is not at distance exactly 0 from "
                             "itself")
    if not bool((found == p_found).all()):
        raise AssertionError(f"ivf_score {label}: the kernel and the plain "
                             "version disagree on which entries exist")
    if bool(found[~live].any()) or bool((idx[~found] != 0).any()):
        raise AssertionError(f"ivf_score {label}: a dead row or a missing "
                             "entry is not (-inf, id 0)")
    dk = torch.where(found, -negd, 0.0)
    dp = torch.where(found, -p_negd, 0.0)
    asc = torch.where(found, -negd, float("inf"))  # missing entries last
    if not bool((asc[..., 1:] >= asc[..., :-1]).all()):
        raise AssertionError(f"ivf_score {label}: distances not ascending")
    # within 1e-3, absolute and relative
    err = float(((dk - dp).abs() / torch.clamp(dp, min=1.0)).max())
    abs_err = float((dk - dp).abs().max())
    if err > DIST_ATOL:
        raise AssertionError(f"ivf_score {label}: sorted distances differ "
                             f"from the plain version by {err}")
    row_scale = dp.amax(-1, keepdim=True)
    rank_err = float(torch.where(row_scale > 0,
                                 (dk - dp).abs() / row_scale.clamp(min=1e-30),
                                 (dk - dp).abs()).max())
    if rank_err > RANK_RTOL:
        raise AssertionError(f"ivf_score {label}: sorted distances differ "
                             f"from the plain version by {rank_err} of the "
                             "row's k-th distance")
    # the ids must carry the distances reported for them: compact id ->
    # layout row, then the distance recomputed from the layout
    total = int(counts.sum())
    blk_of = torch.repeat_interleave(
        torch.arange(f_pad, device="cuda"), counts.long())
    layout_of = blk_of * g + (torch.arange(total, device="cuda")
                              - csum.long()[blk_of])
    flat = x4.reshape(-1, d_pad)
    q = x4[qblk].reshape(ns, mq, d_pad)
    id_err = 0.0
    for lo in range(0, ns, 256):  # bound the (slots, rows, k, d) gather
        nbr = flat[layout_of[idx[lo:lo + 256].long()]]
        rec_d = ((nbr - q[lo:lo + 256, :, None, :]) ** 2).sum(-1)
        e = (torch.where(found[lo:lo + 256], rec_d - dk[lo:lo + 256], 0.0)
             .abs() / torch.clamp(dp[lo:lo + 256], min=1.0))
        id_err = max(id_err, float(e.max()))
    if id_err > DIST_ATOL:
        raise AssertionError(f"ivf_score {label}: ids disagree with their "
                             f"distances by {id_err}")
    # recall with ties allowed, as for knn_exact
    same = (idx.long()[..., :, None] == p_idx.long()[..., None, :]).any(-1)
    kth = torch.where(p_found, -p_negd, float("-inf")).amax(-1, keepdim=True)
    tie = dk >= kth - DIST_ATOL * torch.clamp(kth, min=1.0)
    ok = same | tie | ~found
    recall = float(ok.float().mean())
    if recall != 1.0:
        raise AssertionError(f"ivf_score {label}: recall {recall}")

    rec = dict(label=label, slots=ns, f_pad=f_pad, g=g, d_pad=d_pad,
               q_blocks=q_blocks, probes=int(probes.shape[1]), k=k,
               live_rows=int(live.sum()), max_abs_err=abs_err,
               max_rel_err=err, max_rank_err=rank_err, recall=recall,
               same_id_share=float((same | ~found).float().mean()),
               # candidates whose exact float32 distance the kernel
               # computed, of the live (row, candidate) pairs it met
               exact_candidates=n_exact, pairs=n_pairs,
               exact_share=n_exact / max(n_pairs, 1))
    if timed:
        rec["ms"] = cuda_ms(
            lambda: ivf.score_blocks(*args, g=g, q_blocks=q_blocks), 3)
        rec["plain_ms"] = cuda_ms(
            lambda: ivf.score_blocks_plain(*args, g=g, q_blocks=q_blocks), 1)
        rec["library_ms"] = cuda_ms(
            lambda: library_score(x4, sel, probes, counts, k, g, q_blocks), 2)
        rec.update(ivf_bound(x4, sel, probes, counts, k, g, q_blocks))
    return rec


def ivf_bound(x4, sel, probes, counts, k, g, q_blocks):
    """The least time the card could take for this input: the operations
    its live rows and live candidates need (2 * rows * candidates * d flop)
    at the card's peak for the type the kernel runs them in, dense TF32 on
    the tensor cores, times the MMA passes the design spends on them,
    against its bytes (every input read once, every output written once).
    ``fp32_bound_ms`` keeps the figure the kernel's row had while it ran on
    the CUDA cores: the same operations at the float32 peak."""
    import torch

    f_pad, _, d_pad = x4.shape
    ns = sel.shape[0]
    d = int((x4 != 0).any(dim=0).any(dim=0).sum())
    qblk = (sel.long()[:, None] * q_blocks
            + torch.arange(q_blocks, device=x4.device))
    rows = counts[qblk].long().sum(dim=1)  # live query rows per slot
    cands = counts[probes.long()].long().sum(dim=1)  # live candidates
    flops = 2.0 * float((rows * cands).sum()) * d
    nbytes = (4.0 * x4.numel() + 4.0 * (sel.numel() + probes.numel()
                                        + 2 * counts.numel())
              + 8.0 * ns * q_blocks * g * k)
    probed_bytes = 4.0 * d_pad * float(cands.sum()) * q_blocks
    t_ops = IVF_MMA_PASSES * flops / PEAK_TF32_FLOPS
    t_bytes = nbytes / PEAK_BYTES_PER_S
    return dict(flops=flops, bytes=nbytes, bound_ms=1e3 * max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes",
                mma_passes=IVF_MMA_PASSES,
                fp32_bound_ms=1e3 * max(flops / PEAK_FP32_FLOPS, t_bytes),
                probed_block_bytes_ms=1e3 * probed_bytes / PEAK_BYTES_PER_S)


def ivf_odd_cases():
    """Two shapes off the main path: (a) g=64 with four query blocks to a
    slot, every slot scored; (b) ragged counts with dummy blocks, a probe
    list whose middle 16 entries are all dummies, and k=64."""
    import torch

    gen = torch.Generator(device="cuda")
    gen.manual_seed(11)
    recs = []
    x4, counts, csum = random_layout(64, 64, 12, seed=3, n_dummy=4,
                                     min_count=20)
    sel = torch.arange(16, device="cuda", dtype=torch.int32)
    probes = torch.stack([torch.randperm(64, generator=gen, device="cuda")[:32]
                          for _ in range(16)]).to(torch.int32)
    recs.append(check_ivf_case("g=64 q_blocks=4", x4, sel, probes, counts,
                               csum, 10, 64, 4, timed=False))
    x4, counts, csum = random_layout(96, 128, 20, seed=4, n_dummy=24,
                                     min_count=1)
    sel = torch.tensor([0, 5, 17, 40, 71, 95, 80], device="cuda",
                       dtype=torch.int32)  # 95 and 80 are dummy slots
    probes = torch.stack([torch.randperm(72, generator=gen, device="cuda")[:48]
                          for _ in range(len(sel))]).to(torch.int32)
    probes[:, 16:32] = torch.randint(72, 96, (len(sel), 16), generator=gen,
                                     device="cuda", dtype=torch.int32)
    recs.append(check_ivf_case("ragged, dummy step, k=64", x4, sel, probes,
                               counts, csum, 64, 128, 1, timed=False))
    return recs


def ivf_attack_cases():
    """Inputs chosen against the TF32 candidate filter, each held to the
    plain version like any other case: coordinates with a common offset
    1,000 times the spread (norms a thousand times the neighbour
    distances), with and without locality of the blocks; every point
    present several times (ties at every rank, keys that differ only by
    rounding); blocks of identical rows; and tiny spreads around a large
    offset, where float32 itself resolves few digits."""
    import torch

    gen = torch.Generator(device="cuda")
    gen.manual_seed(23)
    recs = []

    def probes_for(f_pad, n_live, ns, width):
        # every slot probes itself first, then random live blocks
        own = torch.arange(ns, device="cuda")[:, None]
        rest = torch.stack([torch.randperm(n_live, generator=gen,
                                           device="cuda")[:width - 1]
                            for _ in range(ns)])
        return torch.cat([own, rest], 1).to(torch.int32)

    d, g, f_pad, n_dummy = 20, 128, 64, 4
    n_live = f_pad - n_dummy
    sel = torch.arange(24, device="cuda", dtype=torch.int32)
    for label, offset, spread, k in (
            ("offset 1e3 x spread", 1000.0, 1.0, 15),
            ("offset 1e3, spread 1e-3", 1000.0, 1e-3, 15),
            ("offset 1e3 x spread, k=128", 1000.0, 1.0, 128)):
        x4, counts, csum = random_layout(f_pad, g, d, seed=31, n_dummy=n_dummy,
                                         min_count=40)
        x4[:, :, :d] = x4[:, :, :d] * spread + offset
        recs.append(check_ivf_case(label, x4, sel,
                                   probes_for(f_pad, n_live, 24, 32), counts,
                                   csum, k, g, 1, timed=False))
    # local blocks around far-apart centres: what centring is for
    x4, counts, csum = random_layout(f_pad, g, d, seed=32, n_dummy=n_dummy,
                                     min_count=40)
    centres = 500.0 * torch.randn(f_pad, 1, d, generator=gen, device="cuda")
    x4[:, :, :d] = x4[:, :, :d] + centres
    recs.append(check_ivf_case("local blocks, far centres", x4, sel,
                               probes_for(f_pad, n_live, 24, 32), counts,
                               csum, 15, g, 1, timed=False))
    # every point four times, spread over the blocks
    x4, counts, csum = random_layout(f_pad, g, d, seed=33, n_dummy=n_dummy,
                                     min_count=g)
    flat = x4.reshape(-1, x4.shape[2])
    quarter = flat.shape[0] // 4
    perm = torch.randperm(flat.shape[0], generator=gen, device="cuda")
    for rep in range(1, 4):
        flat[perm[rep * quarter:(rep + 1) * quarter]] = flat[perm[:quarter]]
    recs.append(check_ivf_case("every point four times", x4, sel,
                               probes_for(f_pad, n_live, 24, 32), counts,
                               csum, 15, g, 1, timed=False))
    # blocks of identical rows (block 0 probed by everyone, block 1 its
    # own copy of the same point, block 2 another point)
    x4, counts, csum = random_layout(f_pad, g, d, seed=34, n_dummy=n_dummy,
                                     min_count=40)
    x4[0] = x4[0, :1]
    x4[1] = x4[0, :1]
    x4[2] = x4[2, :1]
    probes = probes_for(f_pad, n_live, 24, 32)
    probes[:, 1] = 0
    probes[:, 2] = 1
    probes[:, 3] = 2
    for k in (1, 15, 64):
        recs.append(check_ivf_case(f"identical blocks, k={k}", x4, sel,
                                   probes, counts, csum, k, g, 1,
                                   timed=False))
    return recs


def check_ivf_main_shape(scores_dev, u, k):
    """The scoring kernel on the 1M-cell path's own index (rebuilt from
    the same PCA scores and seed, so the same layout) at the calibrated
    probe count: against the plain version on every IVF_SHARE-th slot,
    and timed alone over all slots."""
    import torch

    from cna_tpu_torch.ops import ivf
    from cna_tpu_torch.pp import ivf_fine

    n, d = scores_dev.shape
    index = ivf_fine.build_fine_index(scores_dev.to(torch.float32), n, d,
                                      seed=0)
    table = ivf_fine._rank_blocks_centroid(index.cents, u)
    sel_all = torch.arange(index.n_slots, device="cuda", dtype=torch.int32)
    sel = sel_all[::IVF_SHARE].contiguous()
    rec = check_ivf_case(
        f"1M-cell index, every {IVF_SHARE}th slot", index.x4, sel,
        table[sel.long()].contiguous(), index.blk_counts_dev,
        index.blk_csum_dev, k, index.g, index.q_blocks, timed=True)
    args = (index.x4, sel_all, table, index.blk_counts_dev,
            index.blk_csum_dev, k)
    stats = torch.zeros(2, dtype=torch.int64, device="cuda")
    ivf.score_blocks(*args, g=index.g, q_blocks=index.q_blocks, stats=stats)
    n_exact, n_pairs = (int(v) for v in stats.cpu())
    rec["all_slots"] = dict(
        slots=int(sel_all.shape[0]), f_real=index.f_real,
        ms=cuda_ms(lambda: ivf.score_blocks(*args, g=index.g,
                                            q_blocks=index.q_blocks), 3),
        exact_candidates=n_exact, pairs=n_pairs,
        exact_share=n_exact / max(n_pairs, 1),
        **ivf_bound(index.x4, sel_all, table, index.blk_counts_dev, k,
                    index.g, index.q_blocks))
    return rec


def kmeans_library_step(x, cent, chunk=KMEANS_CHUNK):
    """The yardstick: the plain step the kernel replaced, the (chunk, C)
    distance tile, its argmin, the one-hot and ``oh.T @ x`` (never called
    by the package)."""
    import torch

    c = cent.shape[0]
    iot = torch.arange(c, device=x.device)[None, :]
    cn = torch.sum(cent * cent, dim=1)[None, :]
    sums = torch.zeros_like(cent)
    cnts = torch.zeros(c, dtype=x.dtype, device=x.device)
    for lo in range(0, x.shape[0], chunk):
        xb = x[lo:lo + chunk]
        oh = (torch.argmin(cn - 2.0 * (xb @ cent.T), dim=1)[:, None]
              == iot).to(x.dtype)
        sums = sums + oh.T @ xb
        cnts = cnts + oh.sum(dim=0)
    return sums, cnts


def kmeans_held(x, cent, ids, dist, plain_ids, what, block=8192):
    """kmeans_assign's output against float64 and its plain version:
    every pick within ``KMEANS_EXACT_ULPS`` of the float64 nearest
    centroid, every distance its pick's float32 distance, and where the
    plain version picked another centroid, the two within the expansion's
    rounding of each other (``KMEANS_TIE_ULPS``).  Returns the readings."""
    import torch

    d = x.shape[1]
    u = 2.0 ** -24
    x64, c64 = x.double(), cent.double()
    cn = (c64 * c64).sum(1)
    qn = (x64 * x64).sum(1)
    own = ((x64 - c64[ids.long()]) ** 2).sum(1)
    # the float64 nearest, by the expansion on coordinates centred on the
    # centroids' mean (so that a large common offset costs no digits)
    mid = c64.mean(0)
    xc, cc = x64 - mid, c64 - mid
    qcn, ccn = (xc * xc).sum(1), (cc * cc).sum(1)
    best = torch.cat([
        (qcn[lo:lo + block, None] - 2.0 * (xc[lo:lo + block] @ cc.T)
         + ccn[None, :]).min(1).values
        for lo in range(0, x.shape[0], block)])
    slack = (KMEANS_EXACT_ULPS * (d + 4) * u * best
             + 1e-12 * (qcn + ccn.max()))
    excess = float((own - best - slack).max())
    if excess > 0:
        raise AssertionError(f"{what}: a pick lies {excess} beyond the "
                             "float64 nearest centroid's rounding")
    dist_err = float(((dist.double() - own).abs()
                      / own.clamp(min=1e-300)).max())
    if dist_err > KMEANS_EXACT_ULPS * (d + 4) * u:
        raise AssertionError(f"{what}: a distance is {dist_err} off its "
                             "pick's")
    diff = ids != plain_ids
    a, p = ids[diff].long(), plain_ids[diff].long()
    d_p = ((x64[diff] - c64[p]) ** 2).sum(1)
    tol = KMEANS_TIE_ULPS * (d + 2) * u * (qn[diff] + cn[a] + cn[p])
    tie_ratio = float(((own[diff] - d_p).abs() / tol).max()) \
        if bool(diff.any()) else 0.0
    if tie_ratio > 1.0:
        raise AssertionError(f"{what}: kernel and plain differ beyond a "
                             f"near-tie ({tie_ratio} of the tolerance)")
    return dict(differ_share=float(diff.double().mean()),
                tie_ratio_max=tie_ratio, dist_rel_err=dist_err,
                nearest_excess=excess)


def kmeans_phase(x):
    """The k-means assignment at the 1M IVF build's shapes, from the 1M
    path's PCA scores ``x`` (1,000,000 x 20 on the card): the kernel held
    to float64 and to its plain version (``kmeans_held``), two launches
    bit-identical, then timed beside its bound, the plain version, the
    yardstick (``kmeans_library_step``) and the whole new fit; returns a
    record."""
    import torch

    from cna_tpu_torch.ops import kmeans
    from cna_tpu_torch.pp import ivf_fine

    n, d = x.shape
    c = n // KMEANS_ROWS_PER_CLUSTER
    rng = np.random.RandomState(0)
    sub = np.sort(rng.choice(n, KMEANS_SAMPLE, replace=False))
    fit_x = x[torch.as_tensor(sub, device=x.device)].contiguous()
    init = torch.as_tensor(rng.choice(KMEANS_SAMPLE, c, replace=False),
                           device=x.device)
    cent = fit_x[init].contiguous()
    rows = fit_x.shape[0]
    stats = torch.zeros(kmeans.N_STATS, dtype=torch.int64, device="cuda")
    ids, dist = kmeans.kmeans_assign(fit_x, cent, stats=stats)
    again = kmeans.kmeans_assign(fit_x, cent)
    if not (torch.equal(again[0], ids) and torch.equal(again[1], dist)):
        raise AssertionError("kmeans_assign: two launches differ")
    del again
    plain_ids, _ = kmeans.kmeans_assign_plain(fit_x, cent)
    rec = dict(rows=rows, c=c, d=d, **kmeans_held(
        fit_x, cent, ids, dist, plain_ids, f"kmeans_assign {rows}x{c}x{d}"))
    counters = [int(v) for v in stats.cpu()]
    rec.update(exact_candidates=counters[0], pairs=counters[1],
               exact_share=counters[0] / max(counters[1], 1))
    rec["device_us_by_kernel"] = device_us_by_kernel(
        lambda: kmeans.kmeans_assign(fit_x, cent), 3)
    rec["ms"] = cuda_ms(lambda: kmeans.kmeans_assign(fit_x, cent), 10)
    rec["plain_ms"] = cuda_ms(
        lambda: kmeans.kmeans_assign_plain(fit_x, cent), 3)
    rec["library_ms"] = cuda_ms(lambda: kmeans_library_step(fit_x, cent),
                                3)
    rec["update_ms"] = cuda_ms(
        lambda: ivf_fine._lloyd_update(fit_x, ids, cent), 10)
    rec["fit_8_iterations_ms"] = cuda_ms(
        lambda: ivf_fine._kmeans_fit_matmul(fit_x, init, 8), 2)
    flops = 2.0 * rows * c * d
    nbytes = 4.0 * (rows * d + c * d) + 8.0 * rows
    t_bytes = nbytes / PEAK_BYTES_PER_S
    rec.update(flops=flops, bytes=nbytes,
               bound_ms=1e3 * max(flops / PEAK_DENSE_FLOPS, t_bytes),
               bound_by="operations",
               tf32_bound_ms=1e3 * max(flops / PEAK_TF32_FLOPS, t_bytes),
               fp32_bound_ms=1e3 * max(flops / PEAK_FP32_FLOPS, t_bytes))
    return rec


def main_path(ct):
    """The 100,000-cell path at full size; returns (launch counts,
    record, the association result, the data, the phenotype)."""
    d, y = dataset(ct, cells_per_sample=2000)
    counts, rec, res = drive_path(ct, d, y, method="auto")
    if rec["knn_method_resolved"] != "pallas":
        raise AssertionError("pp.neighbors resolved kNN to "
                             f"{rec['knn_method_resolved']!r}, not the "
                             "exact kernel")
    if counts.get("knn_exact", 0) != 1:
        raise AssertionError("the main path did not launch knn_exact exactly "
                             f"once: {counts}")
    conn = d.obsp["connectivities"].tocsr()
    if conn.shape != (d.n_obs, d.n_obs) or abs(conn - conn.T).max() != 0:
        raise AssertionError("connectivities are not a symmetric N x N CSR")
    return counts, rec, res, d, y


def dataset(ct, cells_per_sample):
    """Synthetic data of 50 samples x ``cells_per_sample`` cells x 50
    genes (seed 0) and the case/control phenotype."""
    ct.config.set_device("cuda")
    ct.config.enable_x64(False)
    d, samplem = ct.data.synthetic_dataset(
        n_samples=50, cells_per_sample=cells_per_sample, n_genes=50, seed=0)
    return d, samplem["case"].astype(float)


def drive_path(ct, d, y, method):
    """``pp.pca`` -> ``pp.neighbors`` -> ``tl.association`` (twice) on the
    card through the public entry points, with the launch counts set to 0
    just before and read just after the first pass.  Checks what every
    path must give; returns (launch counts, record, first result)."""
    import torch

    from cna_tpu_torch.graph.device import DeviceConnectivities
    from cna_tpu_torch.ops import launch_counts, reset_launch_counts
    from cna_tpu_torch.utils import profiling

    prof = profiling.enable_profiling()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    reset_launch_counts()
    t0 = time.perf_counter()
    ct.pp.pca(d, n_comps=20)
    ct.pp.neighbors(d, n_neighbors=15, method=method)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    res = ct.tl.association(d, y, "id", Nnull=1000, seed=0,
                            return_full=True)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    counts = launch_counts()

    n_first = len(prof.phases)
    steps = diffusion_launches(prof.phases[:n_first], counts, "association")
    res2 = ct.tl.association(d, y, "id", Nnull=1000, seed=0,
                             return_full=True)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    phases = [(p["phase"], round(p["seconds"], 4)) for p in prof.phases]

    if not np.isfinite(res.p) or not 0 < res.p <= 1:
        raise AssertionError(f"association p = {res.p}")
    if res2.p != res.p or res2.k != res.k:
        raise AssertionError("a second association call disagreed")
    for col in ("coef", "coef_fdr"):
        if col not in d.obs:
            raise AssertionError(f"obs[{col!r}] was not written")
    coef = d.obs["coef"].to_numpy()
    fdr = d.obs["coef_fdr"].to_numpy()
    kept = res.kept
    if not (np.isfinite(coef[kept]).all() and kept.sum() > 0):
        raise AssertionError("obs['coef'] is not finite on kept cells")
    if not ((fdr >= 0) & (fdr <= 1)).all():
        raise AssertionError("obs['coef_fdr'] outside [0, 1]")
    conn = d.obsp["connectivities"]
    if not isinstance(conn, DeviceConnectivities) \
            or conn.shape != (d.n_obs, d.n_obs):
        raise AssertionError("obsp['connectivities'] is not a device-"
                             f"resident N x N graph: {conn!r}")

    rec = dict(cells=d.n_obs,
               knn_method_resolved=d.uns["neighbors"]["params"][
                   "knn_method_resolved"],
               graph=repr(conn), p=res.p, k=res.k, kept=int(kept.sum()),
               diffusion_steps=steps,
               graph_s=t1 - t0, association_first_s=t2 - t1,
               association_second_s=t3 - t2, phases_first=phases[:n_first],
               phases_second_association=phases[n_first:],
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    return counts, rec, res


def diffusion_launches(records, counts, what):
    """The diffusion steps of the span ``records`` of one run of ``what``,
    checked against the kernel: every ``diffusion`` span's ``spmm_kernel``
    equals its ``steps``, and the run's ``gather_spmm`` launches (``counts``,
    set to 0 just before it) equal their sum; returns that sum."""
    diff = [r for r in records if r["phase"] == "diffusion"]
    steps = sum(r["steps"] for r in diff)
    if not diff or counts.get("gather_spmm", 0) != steps \
            or any(r.get("spmm_kernel") != r["steps"] for r in diff):
        spans = [(r["steps"], r.get("spmm_kernel")) for r in diff]
        raise AssertionError(
            f"{what}: gather_spmm launches {counts.get('gather_spmm', 0)}, "
            f"diffusion spans (steps, spmm_kernel) {spans}")
    return steps


def atlas_path(ct):
    """The 1,000,000-cell path at full size, nothing cut, then ``pp.umap``
    on its IVF graph (``umap_record``); returns (launch counts, record, the
    PCA scores on the card, the calibrated u)."""
    import warnings

    from cna_tpu_torch.pp.pca import device_rep

    t0 = time.perf_counter()
    d, y = dataset(ct, cells_per_sample=20_000)
    make_s = time.perf_counter() - t0
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        counts, rec, _ = drive_path(ct, d, y, method="auto")
    recall_warnings = [str(w.message) for w in caught
                       if "pp.ivf" in str(w.message)]
    rec["make_data_s"] = make_s
    info = d.uns["neighbors"].get("ivf")
    rec["ivf"] = info
    if rec["knn_method_resolved"] != "ivf" or info is None:
        raise AssertionError("pp.neighbors resolved kNN to "
                             f"{rec['knn_method_resolved']!r}, not the IVF "
                             "index")
    if counts.get("ivf_score", 0) < 1:
        raise AssertionError(f"the 1M path launched no ivf_score: {counts}")
    if recall_warnings or not info["verify_recall"] >= IVF_MIN_RECALL:
        raise AssertionError(f"IVF recall below {IVF_MIN_RECALL}: {info}; "
                             f"{recall_warnings}")
    scores_dev = device_rep(d, d.obsm["X_pca"])
    rec["umap"] = umap_record(ct, d, "cuda", cells=2000, timed=True)
    return counts, rec, scores_dev, int(info["u"])


def ivf_vs_exact(ct, exact_res):
    """The 100,000-cell data through ``method='ivf'`` on the card, held to
    the exact-graph result of the same data."""
    d, y = dataset(ct, cells_per_sample=2000)
    counts, rec, res = drive_path(ct, d, y, method="ivf")
    if counts.get("ivf_score", 0) < 1:
        raise AssertionError(f"method='ivf' launched no ivf_score: {counts}")
    r = float(np.corrcoef(np.asarray(exact_res.ncorrs),
                          np.asarray(res.ncorrs))[0, 1])
    out = dict(ncorrs_corr=r, p_exact=exact_res.p, p_ivf=res.p,
               k=(exact_res.k, res.k), ivf=d.uns["neighbors"]["ivf"],
               graph_s=rec["graph_s"], launches=counts)
    if r <= IVF_NCORR_MIN or (exact_res.p < 0.05) != (res.p < 0.05):
        raise AssertionError(f"IVF and exact graphs disagree: {out}")
    return out


def knn_lists(d):
    """(ids, dists) (N, k) from ``obsp['distances']``, self in column 0."""
    dm = d.obsp["distances"]
    n = d.n_obs
    ids = np.concatenate([np.arange(n)[:, None], dm.indices.reshape(n, -1)],
                         axis=1)
    dists = np.concatenate([np.zeros((n, 1)), dm.data.reshape(n, -1)],
                           axis=1)
    return ids, dists


def card_vs_cpu(ct, card="cuda", n_samples=50, cells_per_sample=100):
    """The chain at ``n_samples`` x ``cells_per_sample`` cells (5,000 by
    default) on the card in float32 against the CPU in float64, stage by
    stage (each CPU stage takes the card's input to that stage, so that
    float32 rounding upstream cannot move it), and end to end.  ``card``
    is the device of the float32 run."""
    import importlib

    import scipy.sparse as sp

    nb = importlib.import_module("cna_tpu_torch.pp.neighbors")
    from cna_tpu_torch.tools._nam import nam_arrays

    def run(dev, x64, scores=None, conn=None):
        ct.config.set_device(dev)
        ct.config.enable_x64(x64)
        d, samplem = ct.data.synthetic_dataset(
            n_samples=n_samples, cells_per_sample=cells_per_sample,
            n_genes=50, seed=1, dtype=np.float64 if x64 else np.float32)
        if scores is None:
            ct.pp.pca(d, n_comps=20)
        else:
            d.obsm["X_pca"] = scores
        ct.pp.neighbors(d, n_neighbors=15)
        # the card stores a device-resident graph; compare CSR matrices
        knn, own_conn = knn_lists(d), d.obsp["connectivities"].tocsr()
        if conn is not None:
            d.obsp["connectivities"] = conn
        y = samplem["case"].astype(float)
        arrays, _ = nam_arrays(d, "id")
        res = ct.tl.association(d, y, "id", Nnull=1000, null_y=null_y,
                                return_full=True)
        return dict(d=d, knn=knn, conn=own_conn, nsteps=arrays.nsteps,
                    k=res.k, p=res.p, nam=res.nam.to_numpy())

    _, samplem = ct.data.synthetic_dataset(
        n_samples=n_samples, cells_per_sample=cells_per_sample, n_genes=50,
        seed=1)
    ys = samplem["case"].astype(float).to_numpy()
    ys = (ys - ys.mean()) / ys.std(ddof=0)
    rng = np.random.RandomState(7)
    null_y = np.stack([ys[rng.permutation(len(ys))] for _ in range(1000)],
                      axis=1)

    cpu = run("cpu", True)
    gpu = run(card, False)
    g_scores = np.asarray(gpu["d"].obsm["X_pca"], dtype=np.float64)
    g_conn = gpu["conn"]
    # the CPU's float64 stages on the card's inputs: kNN on the card's
    # PCA scores, and the NAM / test / FDR on the card's own graph
    same = run("cpu", True, scores=g_scores, conn=g_conn.astype(np.float64))
    rec = {}

    # PCA, up to a sign per column
    c_scores = np.asarray(cpu["d"].obsm["X_pca"])
    sign = np.sign(np.sum(c_scores * g_scores, axis=0))
    rec["pca_rel_err"] = float(np.max(np.abs(g_scores * sign - c_scores))
                               / np.max(np.abs(c_scores)))

    # kNN lists on the same scores: a list may differ only by a near-tie,
    # which shows as equal sorted float64 distances of the two id lists
    g_ids, g_d = gpu["knn"]
    s_ids, s_d = same["knn"]
    rec["knn_same_share"] = float(np.mean(np.sort(g_ids, 1)
                                          == np.sort(s_ids, 1)))
    differ = np.flatnonzero((np.sort(g_ids, 1) != np.sort(s_ids, 1)).any(1))
    g_exact = np.sqrt(((g_scores[g_ids[differ]]
                        - g_scores[differ, None, :]) ** 2).sum(-1))
    tie_gap = np.abs(np.sort(g_exact, 1) - np.sort(s_d[differ], 1))
    rec["knn_rows_differ"] = int(len(differ))
    rec["knn_tie_gap"] = float(tie_gap.max()) if len(differ) else 0.0

    # the fuzzy graph: the card's own kNN lists through the float64 build
    ct.config.set_device("cpu")
    ct.config.enable_x64(True)
    ref = nb.fuzzy_connectivities(g_ids, g_d.astype(np.float64))
    same_csr = (np.array_equal(ref.indptr, g_conn.indptr)
                and np.array_equal(ref.indices, g_conn.indices))
    rec["graph_same_csr"] = same_csr
    rec["graph_rel_err"] = (float(np.max(np.abs(g_conn.data - ref.data)
                                         / ref.data)) if same_csr else None)
    # and against the float64 graph of the same scores, where both kNN
    # lists agree on every row an entry touches
    ok_rows = np.ones(g_ids.shape[0], bool)
    ok_rows[differ] = False
    coo = sp.coo_matrix(same["conn"])
    keep = ok_rows[coo.row] & ok_rows[coo.col]
    g_at = np.asarray(g_conn.tocsr()[coo.row[keep], coo.col[keep]]).ravel()
    rec["graph_vs_f64_scores_abs_err"] = float(
        np.max(np.abs(g_at - coo.data[keep])))

    # NAM / test / FDR on the same (card's) graph
    rec["same_graph"] = dict(
        nsteps=(same["nsteps"], gpu["nsteps"]), k=(same["k"], gpu["k"]),
        nam_rel_err=float(np.max(np.abs(gpu["nam"] - same["nam"]))
                          / np.max(np.abs(same["nam"]))))
    # end to end, each device on its own PCA and graph
    rec["end_to_end"] = dict(
        nsteps=(cpu["nsteps"], gpu["nsteps"]), k=(cpu["k"], gpu["k"]),
        p=(cpu["p"], gpu["p"]),
        nam_rel_err=float(np.max(np.abs(gpu["nam"] - cpu["nam"]))
                          / np.max(np.abs(cpu["nam"]))))

    failed = []
    if rec["pca_rel_err"] > PCA_RTOL:
        failed.append("PCA scores")
    if rec["knn_same_share"] < KNN_SHARE_MIN or rec["knn_tie_gap"] > TIE_ATOL:
        failed.append("kNN lists")
    if not same_csr or rec["graph_rel_err"] > GRAPH_RTOL \
            or rec["graph_vs_f64_scores_abs_err"] > GRAPH_F32_DIST_ATOL:
        failed.append("fuzzy graph")
    for key in ("same_graph", "end_to_end"):
        r = rec[key]
        if r["nsteps"][0] != r["nsteps"][1] or r["k"][0] != r["k"][1]:
            failed.append(f"nsteps or k ({key})")
    if rec["same_graph"]["nam_rel_err"] > NAM_RTOL:
        failed.append("NAM")
    if failed:
        raise AssertionError(f"card and CPU disagree on {failed}: {rec}")
    return rec


def banded_random_matrix(n, k, band, seed, long_range_frac=0.05):
    """A seeded symmetric weighted matrix with mostly-local neighbours:
    ``k`` per row within ``band`` of the diagonal and a share of
    ``long_range_frac`` anywhere (scipy CSR, float64)."""
    import scipy.sparse as sp

    rng = np.random.RandomState(seed)
    rows = np.repeat(np.arange(n), k)
    cols = np.clip(rows + rng.randint(-band, band + 1, size=n * k), 0, n - 1)
    n_far = int(n * k * long_range_frac)
    rows = np.concatenate([rows, rng.randint(0, n, n_far)])
    cols = np.concatenate([cols, rng.randint(0, n, n_far)])
    keep = rows != cols
    w = rng.rand(int(keep.sum())) * 0.9 + 0.1
    a = sp.csr_matrix((w, (rows[keep], cols[keep])), shape=(n, n))
    return (a + a.T).tocsr()


def check_banded_case(label, graph, x):
    """The banded kernel's in-band product against its plain version on
    the card, on one packed graph and state; returns a record."""
    import torch

    from cna_tpu_torch.ops import spmm_banded as sb

    ref = sb.banded_spmm_plain(graph.lidx, graph.weights, graph.slab_starts,
                               x, graph.row_tile, graph.slab_rows)
    torch.cuda.synchronize()
    dtype = str(x.dtype).replace("torch.", "")
    scale = float(ref.abs().max())
    y = sb.banded_inband(graph, x)
    torch.cuda.synchronize()
    if y.shape != (graph.lidx.shape[0], x.shape[1]) or y.dtype != x.dtype:
        raise AssertionError(f"banded_spmm {label}: output {tuple(y.shape)} "
                             f"{y.dtype}")
    if not bool(torch.isfinite(y).all()):
        raise AssertionError(f"banded_spmm {label}: non-finite output")
    if not torch.equal(y, sb.banded_inband(graph, x)):
        raise AssertionError(f"banded_spmm {label}: two runs on the same "
                             "input differ")
    err = float((y - ref).abs().max())
    rel = err / scale if scale > 0 else err
    if rel > BANDED_RTOL[dtype]:
        raise AssertionError(f"banded_spmm {label}: differs from the plain "
                             f"version by {err} (relative {rel})")
    return dict(label=label, dtype=dtype, n=graph.n_rows_true,
                n_pad=int(graph.lidx.shape[0]), k=int(graph.lidx.shape[1]),
                s=int(x.shape[1]), row_tile=graph.row_tile,
                slab_rows=graph.slab_rows, max_abs_err=err, max_rel_err=rel,
                max_abs_y=scale)


def banded_odd_cases(dev="cuda"):
    """The banded kernel off its main shape: S of 1, not a multiple of 4,
    at and just above one column chunk, and a cohort of 200; N below the
    slab and not a multiple of the row tile; K of 0 and K not a multiple
    of 4; a spill of width 0; a small geometry; float32 and float64."""
    import torch

    from cna_tpu_torch.ops import spmm_banded as sb

    gen = torch.Generator(device=dev)
    gen.manual_seed(5)

    def state(graph, s):
        return torch.rand((graph.n_rows_true, s), generator=gen,
                          device=dev, dtype=graph.dtype)

    recs = []
    a = banded_random_matrix(5000, 12, 300, seed=1)
    for dtype in (np.float32, np.float64):
        g = sb.banded_from_scipy(a, dtype=dtype, device=dev)
        if g.spill_indices.shape[1] == 0 or g.lidx.shape[0] == 5000:
            raise AssertionError("the odd-shape graph has no spill or no "
                                 "row padding")
        for s in (1, 7, 45, 46, 50, 200):
            recs.append(check_banded_case(f"N=5000 S={s}", g, state(g, s)))
        # K not a multiple of 4: one more empty slot per row
        pad = g.lidx.new_zeros((g.lidx.shape[0], 1))
        odd = sb.banded_from_arrays(
            torch.cat([g.lidx, pad], 1), torch.cat(
                [g.weights, pad.to(g.dtype)], 1), g.slab_starts,
            g.spill_indices, g.spill_weights, g.overflow_rows,
            g.overflow_cols, g.overflow_weights, g.colsums_raw,
            g.n_rows_true, g.row_tile, g.slab_rows, device=dev)
        recs.append(check_banded_case("K not a multiple of 4", odd,
                                      state(odd, 13)))
        # one tile set whose slab is longer than the data
        small = sb.banded_from_scipy(
            banded_random_matrix(1000, 8, 200, seed=2), dtype=dtype,
            device=dev)
        if small.slab_rows <= small.lidx.shape[0]:
            raise AssertionError("the N < slab case is not below its slab")
        recs.append(check_banded_case("N=1000 < slab", small,
                                      state(small, 20)))
        # no long-range edge: a spill of width 0
        tight = sb.banded_from_scipy(
            banded_random_matrix(3000, 8, 100, seed=3, long_range_frac=0.0),
            dtype=dtype, device=dev)
        if tight.spill_indices.shape[1] != 0:
            raise AssertionError("the in-band-only graph has a spill")
        recs.append(check_banded_case("spill width 0", tight,
                                      state(tight, 9)))
        # K = 0
        empty = sb.banded_from_arrays(
            np.zeros((512, 0), np.int32), np.zeros((512, 0), dtype),
            np.zeros(2, np.int32), np.zeros((300, 0), np.int32),
            np.zeros((300, 0), dtype), np.zeros(0, np.int32),
            np.zeros(0, np.int32), np.zeros(0, dtype), np.zeros(300, dtype),
            300, 256, 1280, device=dev)
        recs.append(check_banded_case("K=0", empty, state(empty, 5)))
        # a small geometry (row_tile 64, window 16)
        g64 = sb.banded_from_scipy(
            banded_random_matrix(777, 6, 12, seed=4), row_tile=64,
            window=16, dtype=dtype, device=dev)
        recs.append(check_banded_case("row_tile=64 window=16", g64,
                                      state(g64, 33)))
        # every slot in band (no empty slot to skip), and non-zero counts
        # that run from 0 to K within every 32 rows
        n, k, tile, window = 1024, 12, 256, 128
        rs = np.random.RandomState(6)
        starts = np.clip(np.arange(n // tile) * tile - window, 0,
                         n - (tile + 2 * window)).astype(np.int32)
        lidx = rs.randint(0, tile + 2 * window, (n, k)).astype(np.int32)
        w = (rs.rand(n, k) * 0.9 + 0.1).astype(dtype)
        keep = np.arange(k)[None, :] < (np.arange(n) % (k + 1))[:, None]
        scattered = np.take_along_axis(
            keep, np.argsort(rs.rand(n, k), axis=1), axis=1)
        for label, mask in (("all rows full", np.ones((n, k), bool)),
                            ("counts 0..K within a warp", scattered)):
            gr = sb.banded_from_arrays(
                np.where(mask, lidx, 0), np.where(mask, w, 0).astype(dtype),
                starts, np.zeros((n, 0), np.int32), np.zeros((n, 0), dtype),
                np.zeros(0, np.int32), np.zeros(0, np.int32),
                np.zeros(0, dtype), np.zeros(n, dtype), n, tile,
                tile + 2 * window, device=dev)
            nnz = gr.compact.row_nnz.cpu().numpy()
            if not np.array_equal(nnz, mask.sum(1)):
                raise AssertionError(f"{label}: row_nnz is not the number "
                                     "of non-zero slots")
            recs.append(check_banded_case(label, gr, state(gr, 50)))
    return recs


def banded_library_csr(graph, n):
    """The in-band edges of ``graph`` as one CSR tensor (N_pad, n) for the
    ``torch.sparse.mm`` yardstick (never used by the package)."""
    import torch

    n_pad, k = graph.lidx.shape
    starts = torch.repeat_interleave(graph.slab_starts.long(),
                                     graph.row_tile)
    live = graph.weights != 0
    cols = (starts[:, None] + graph.lidx.long())[live]
    crow = torch.zeros(n_pad + 1, dtype=torch.int64, device=live.device)
    crow[1:] = torch.cumsum(live.sum(dim=1), 0)
    return torch.sparse_csr_tensor(crow, cols, graph.weights[live],
                                   size=(n_pad, n))


def banded_bound(graph, n, s):
    """The least time the card could take for the in-band product: the
    bytes the work needs, an index and a weight per in-band EDGE, x read
    once and y written once, at the card's memory rate (2 flop per edge
    and column are far below the float32 rate).  Also, under their own
    keys, the figure that counts every padded slot of the packed arrays
    (what the first kernel was held to), and that figure with every tile
    reading its whole slab of x."""
    n_pad, k = graph.lidx.shape
    item = graph.weights.element_size()
    edges = float(graph.compact.row_nnz.sum())
    state_bytes = item * float(s) * (n + n_pad)
    nbytes = edges * (4 + item) + state_bytes
    flops = 2.0 * edges * s
    slot_bytes = (float(n_pad) * k * (4 + item)
                  + 4.0 * graph.slab_starts.numel() + state_bytes)
    slab_bytes = slot_bytes + item * float(s) * n * (
        graph.slab_rows / graph.row_tile - 1)
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES_PER_S
    return dict(flops=flops, bytes=nbytes,
                bound_ms=1e3 * max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes",
                all_slots_bound_ms=1e3 * slot_bytes / PEAK_BYTES_PER_S,
                whole_slab_bytes_ms=1e3 * slab_bytes / PEAK_BYTES_PER_S)


def banded_referenced_rows(graph):
    """Per row tile, the span of slab rows its in-band edges refer to:
    (largest span, mean span) in rows: what a kernel that staged only the
    referenced range of a slab in shared memory, at full S, would have to
    hold there."""
    import torch

    n_pad, k = graph.lidx.shape
    tiles = n_pad // graph.row_tile
    live = (graph.weights != 0).reshape(tiles, -1)
    li = graph.lidx.reshape(tiles, -1)
    lo = torch.where(live, li, graph.slab_rows).amin(1)
    hi = torch.where(live, li, -1).amax(1)
    span = (hi - lo + 1).clamp(min=0).float()
    return float(span.max()), float(span.mean())


def pack_phases(prof, first):
    """Seconds of the graph_pack phases recorded since phase ``first``."""
    out = {}
    for p in prof.phases[first:]:
        if p["phase"].startswith("graph_pack"):
            out[p["phase"]] = out.get(p["phase"], 0.0) + p["seconds"]
    return out


def step_ms(d, fmt, s_cols, reps=5, dev="cuda"):
    """Milliseconds per diffusion step of ``d``'s graph under ``fmt`` on a
    random (rows, s_cols) state (CUDA events)."""
    import torch

    from cna_tpu_torch.ops import spmm
    from cna_tpu_torch.tools._nam import get_device_graph

    graph, _ = get_device_graph(d, fmt=fmt)
    gen = torch.Generator(device=dev)
    gen.manual_seed(9)
    state = torch.rand((graph.n_rows, s_cols), generator=gen, device=dev,
                       dtype=graph.dtype)
    colsums = graph.colsums(1)
    return cuda_ms(lambda: spmm.diffusion_step(state, graph, colsums, 1),
                   reps)


def nam_rel_err(ref, other):
    """max |other - ref| / max |ref| of two NAM DataFrames."""
    a, b = ref.to_numpy(), other.to_numpy()
    if a.shape != b.shape or not np.isfinite(b).all():
        raise AssertionError("NAMs differ in shape or are not finite")
    return float(np.max(np.abs(b - a)) / np.max(np.abs(a)))


def banded_path(ct, dev="cuda", cells_per_sample=20_000):
    """The banded path at full width: 1,000,000 cells on trajectories, the
    association under the default format and under 'banded' (twice), the
    two held together; then the kernel alone at this graph's shape.
    Returns (launch counts of the path, record, kernel record, and for the
    mesh phase the data, the phenotype and the default format's
    result)."""
    import torch

    from cna_tpu_torch.ops import (launch_counts, reset_launch_counts,
                                   spmm_banded as sb)
    from cna_tpu_torch.tools._nam import get_device_graph, nam_arrays
    from cna_tpu_torch.utils import profiling

    ct.config.set_device(dev)
    ct.config.enable_x64(False)
    t0 = time.perf_counter()
    d, samplem = ct.data.synthetic_dataset(
        n_samples=50, cells_per_sample=cells_per_sample, n_genes=50,
        seed=0,
        structure="manifold")
    y = samplem["case"].astype(float)
    make_s = time.perf_counter() - t0
    prof = profiling.enable_profiling()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    def assoc():
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = ct.tl.association(d, y, "id", Nnull=1000, seed=0,
                                return_full=True)
        torch.cuda.synchronize()
        return res, time.perf_counter() - t

    reset_launch_counts()
    t0 = time.perf_counter()
    ct.pp.pca(d, n_comps=20)
    ct.pp.neighbors(d, n_neighbors=15)
    torch.cuda.synchronize()
    graph_s = time.perf_counter() - t0
    res_def, def_s = assoc()
    n_before = len(prof.phases)
    ct.tl.set_graph_format(d, "banded")
    res_b1, banded_first_s = assoc()
    counts = launch_counts()
    packs = pack_phases(prof, n_before)

    # the steps of one association, and the launches they cost
    reset_launch_counts()
    arrays, _ = nam_arrays(d, "id")
    per_nam = launch_counts().get(sb.KERNEL, 0)
    res_b2, banded_second_s = assoc()
    ct.tl.set_graph_format(d, "bucketed")
    arrays_def, _ = nam_arrays(d, "id")
    nam_def, _ = ct.tl.nam(d, "id", nsteps=FORMAT_NSTEPS)
    ct.tl.set_graph_format(d, "banded")
    nam_b, _ = ct.tl.nam(d, "id", nsteps=FORMAT_NSTEPS)
    nam_err = nam_rel_err(nam_def, nam_b)
    del nam_def, nam_b

    graph, ordering = get_device_graph(d)
    if not isinstance(graph, sb.BandedGraph) or ordering is None:
        raise AssertionError(f"the packed graph is {type(graph).__name__}")
    r = float(np.corrcoef(np.asarray(res_def.ncorrs),
                          np.asarray(res_b1.ncorrs))[0, 1])
    rec = dict(
        cells=d.n_obs, samples=50, make_data_s=make_s, graph_s=graph_s,
        knn_method_resolved=d.uns["neighbors"]["params"][
            "knn_method_resolved"],
        band_fraction=graph.band_fraction(), k=int(graph.lidx.shape[1]),
        spill_width=int(graph.spill_indices.shape[1]),
        coo_tail=int(graph.overflow_rows.shape[0]),
        tiles=int(graph.slab_starts.shape[0]), row_tile=graph.row_tile,
        slab_rows=graph.slab_rows, graph_pack_s=packs,
        nsteps=(arrays_def.nsteps, arrays.nsteps),
        banded_launches_per_nam=per_nam,
        association_default_s=def_s,
        association_banded_first_s=banded_first_s,
        association_banded_second_s=banded_second_s,
        p=(res_def.p, res_b1.p, res_b2.p),
        k_pcs=(res_def.k, res_b1.k, res_b2.k), ncorrs_corr=r,
        nam_rel_err=nam_err,
        step_ms_banded=step_ms(d, "banded", 50, dev=dev),
        step_ms_default=step_ms(d, "bucketed", 50, dev=dev),
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)

    failed = []
    if counts.get(sb.KERNEL, 0) < arrays.nsteps or per_nam != arrays.nsteps:
        failed.append("fewer banded_spmm launches than diffusion steps")
    if arrays.nsteps != arrays_def.nsteps:
        failed.append("diffusion steps")
    if not (res_def.k == res_b1.k == res_b2.k) or res_b1.p != res_b2.p:
        failed.append("k, or p of the second call")
    if (res_def.p < 0.05) != (res_b1.p < 0.05):
        failed.append("decision at p < 0.05")
    if not r > FORMAT_NCORR_MIN:
        failed.append("ncorrs")
    if not nam_err <= FORMAT_NAM_RTOL:
        failed.append("NAM")
    if failed:
        raise AssertionError(f"banded and default formats disagree on "
                             f"{failed}: {rec}")

    # the kernel alone at this graph's shape: the in-band product
    n, s = d.n_obs, 50
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    x = torch.rand((n, s), generator=gen, device=dev, dtype=graph.dtype)
    krec = check_banded_case("1M-cell manifold graph", graph, x)
    csr = banded_library_csr(graph, n)
    lib_y = torch.sparse.mm(csr, x)
    lib_err = float((lib_y - sb.banded_inband(graph, x)).abs().max())
    if lib_err > BANDED_RTOL["float32"] * krec["max_abs_y"]:
        raise AssertionError("torch.sparse.mm of the in-band edges differs "
                             f"from the kernel by {lib_err}")
    del lib_y
    krec["ms"] = cuda_ms(lambda: sb.banded_inband(graph, x), 20)
    span_max, span_mean = banded_referenced_rows(graph)
    krec["referenced_slab_rows"] = dict(
        max=span_max, mean=span_mean,
        max_bytes_at_full_s=span_max * s * x.element_size())
    krec["compact_slots"] = int(graph.compact.lidx.shape[0])
    krec["plain_ms"] = cuda_ms(lambda: sb.banded_spmm_plain(
        graph.lidx, graph.weights, graph.slab_starts, x, graph.row_tile,
        graph.slab_rows), 3)
    krec["library_ms"] = cuda_ms(lambda: torch.sparse.mm(csr, x), 5)
    krec["in_band_edges"] = int(csr.values().shape[0])
    krec.update(banded_bound(graph, n, s))
    return counts, rec, krec, (d, y, res_def)


def block_formats(ct, dev="cuda", cells_per_sample=2000):
    """'block' and 'hybrid' once each at 100,000 cells (manifold): the NAM
    of a fixed number of steps against 'ell'."""
    import torch

    from cna_tpu_torch.tools._nam import get_device_graph
    from cna_tpu_torch.utils import profiling

    ct.config.set_device(dev)
    ct.config.enable_x64(False)
    d, _ = ct.data.synthetic_dataset(
        n_samples=50, cells_per_sample=cells_per_sample, n_genes=50,
        seed=0,
        structure="manifold")
    prof = profiling.enable_profiling()
    ct.pp.pca(d, n_comps=20)
    ct.pp.neighbors(d, n_neighbors=15)
    ct.tl.set_graph_format(d, "ell")
    nam_ell, _ = ct.tl.nam(d, "id", nsteps=FORMAT_NSTEPS)
    out = dict(step_ms_ell=step_ms(d, "ell", 50, dev=dev))
    for fmt in ("block", "hybrid"):
        n_before = len(prof.phases)
        ct.tl.set_graph_format(d, fmt)
        nam_f, _ = ct.tl.nam(d, "id", nsteps=FORMAT_NSTEPS)
        err = nam_rel_err(nam_ell, nam_f)
        graph, _ = get_device_graph(d)
        block = graph.block if fmt == "hybrid" else graph
        rec = dict(nam_rel_err=err, pairs=block.n_pairs,
                   block_size=block.block_size,
                   tile_gb=block.tiles.numel() * block.tiles.element_size()
                   / 1e9,
                   graph_pack_s=pack_phases(prof, n_before),
                   step_ms=step_ms(d, fmt, 50, dev=dev))
        if fmt == "hybrid":
            rec["stray_ell_width"] = graph.ell.max_degree
        out[fmt] = rec
        if not err <= FORMAT_NAM_RTOL:
            raise AssertionError(f"{fmt!r} and 'ell' NAMs differ: {out}")
        del graph, block, nam_f
        ct.tl.set_graph_format(d, "ell")
        torch.cuda.empty_cache()
    return out


def halo_phases(prof, first):
    """Seconds of the halo planning phases recorded since phase ``first``."""
    out = {}
    for p in prof.phases[first:]:
        if p["phase"].startswith("halo_"):
            out[p["phase"]] = out.get(p["phase"], 0.0) + p["seconds"]
    return out


def tensor_rel_err(ref, other):
    """max |other - ref| / max |ref| of two tensors (on the card)."""
    if ref.shape != other.shape or not bool(other.isfinite().all()):
        raise AssertionError("NAMs differ in shape or are not finite")
    return float((other - ref).abs().max() / ref.abs().max())


def halo_step_ms(d, plan, mesh, s_cols, reps=5, dev="cuda"):
    """Milliseconds per halo diffusion step of ``d``'s plan over ``mesh``
    on a random (rows, s_cols) state (CUDA events)."""
    import torch

    from cna_tpu_torch.parallel import halo
    from cna_tpu_torch.parallel.mesh import cell_rows, place

    placed = halo.place_plan(plan, mesh)
    gen = torch.Generator(device=dev)
    gen.manual_seed(9)
    state = place(torch.rand((plan.n_shards * plan.shard_rows, s_cols),
                             generator=gen, device=dev,
                             dtype=plan.dtype), cell_rows(mesh))
    return cuda_ms(lambda: halo.halo_diffusion_step(state, placed, mesh, 1),
                   reps)


def mesh_association(ct, d, y, res_single, step_ms_default, dev="cuda"):
    """Phase mesh (a): the 1M-cell manifold graph of phase 8 (default
    format) under 4 x 1 and 2 x 2 meshes of slots on this one card: the
    association through the halo exchange, held to the single-device
    result of phase 8 (p, k equal; ``ncorrs`` and the NAM within phase 8's
    format gates), and the plan's exchange figures."""
    import torch

    from cna_tpu_torch.parallel import make_mesh
    from cna_tpu_torch.tools._nam import (_DIFFUSION_PATH_KEY, _FORMAT_KEY,
                                          get_halo_plan, nam_arrays)
    from cna_tpu_torch.utils import profiling

    ct.config.set_device(dev)
    ct.config.enable_x64(False)
    slot = "cuda:0" if dev == "cuda" else dev
    d.uns.pop(_FORMAT_KEY, None)  # back to the default format
    nam_single = nam_arrays(d, "id", nsteps=FORMAT_NSTEPS)[0].nam
    prof = profiling.enable_profiling()
    out = {}
    for perms in (1, 2):
        mesh = make_mesh([slot] * 4, perms=perms)
        cells = 4 // perms
        sync(dev)
        torch.cuda.reset_peak_memory_stats()
        n_before = len(prof.phases)
        t0 = time.perf_counter()
        res = ct.tl.association(d, y, "id", Nnull=1000, seed=0, mesh=mesh,
                                return_full=True)
        sync(dev)
        first_s = time.perf_counter() - t0
        path = d.uns[_DIFFUSION_PATH_KEY]
        t0 = time.perf_counter()
        res2 = ct.tl.association(d, y, "id", Nnull=1000, seed=0, mesh=mesh,
                                 return_full=True)
        sync(dev)
        second_s = time.perf_counter() - t0
        arrays, _ = nam_arrays(d, "id", nsteps=FORMAT_NSTEPS, mesh=mesh)
        nam_err = tensor_rel_err(nam_single, arrays.nam)
        del arrays
        plan, _ = get_halo_plan(d, cells)
        r = float(np.corrcoef(np.asarray(res_single.ncorrs),
                              np.asarray(res.ncorrs))[0, 1])
        rec = dict(
            mesh=mesh.shape, path=path, plan_s=halo_phases(prof, n_before),
            association_first_s=first_s, association_second_s=second_s,
            p=(res_single.p, res.p, res2.p), k=(res_single.k, res.k, res2.k),
            ncorrs_corr=r, nam_rel_err=nam_err,
            ghost_fraction=plan.ghost_fraction(), rounds=len(plan.rounds),
            exchange_bytes=plan.exchange_stats(s_cols=50, itemsize=4),
            shard_rows=plan.shard_rows, padded_area=plan.padded_area(),
            step_ms_halo=halo_step_ms(d, plan, mesh, 50, dev=dev),
            step_ms_default=step_ms_default,
            phases=[(p["phase"], round(p["seconds"], 4))
                    for p in prof.phases[n_before:]],
            peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
        out[f"{cells}x{perms}"] = rec
        failed = []
        if path != "halo":
            failed.append("path")
        if not (res.p == res2.p == res_single.p
                and res.k == res2.k == res_single.k):
            failed.append("p or k")
        if not r > FORMAT_NCORR_MIN:
            failed.append("ncorrs")
        if not nam_err <= FORMAT_NAM_RTOL:
            failed.append("NAM")
        if failed:
            raise AssertionError(f"the {cells} x {perms} mesh disagrees with "
                                 f"one device on {failed}: {rec}")
        torch.cuda.empty_cache()
    return out


def ivf_devices(ct, scores_dev, k=15):
    """Phase mesh (b): the 1M archetype points of phase 5 through
    ``ivf_knn(devices=["cuda:0", "cuda:0"])``: ids and distances equal to
    the one-device search bit for bit, ``ivf_score`` launched once per
    device where the one-device search launches once.  Returns (launch
    counts of the two-device search, record)."""
    import torch

    from cna_tpu_torch.ops import launch_counts, reset_launch_counts
    from cna_tpu_torch.pp.ivf import ivf_knn_device

    dev = scores_dev.device
    slot = str(torch.device(dev.type, dev.index or 0)) \
        if dev.type == "cuda" else "cpu"
    runs = {}
    for devices in (None, [slot, slot]):
        sync(dev)
        reset_launch_counts()
        t0 = time.perf_counter()
        res = ivf_knn_device(scores_dev, k, seed=0, devices=devices)
        sync(dev)
        runs[devices is not None] = (res, time.perf_counter() - t0,
                                     launch_counts())
    (one, one_s, one_counts), (two, two_s, two_counts) = runs[False], \
        runs[True]
    rec = dict(cells=scores_dev.shape[0], u=(one.u, two.u),
               recall=(one.recall, two.recall), seconds=(one_s, two_s),
               launches=(one_counts, two_counts),
               ids_equal=torch.equal(one.indices, two.indices),
               dists_equal=torch.equal(one.dists, two.dists))
    n_one = one_counts.get("ivf_score", 0)
    launched = (dev.type != "cuda"  # the plain version on a CPU rehearsal
                or (n_one >= 1
                    and two_counts.get("ivf_score", 0) == 2 * n_one))
    if not (rec["ids_equal"] and rec["dists_equal"] and launched):
        raise AssertionError(f"ivf_knn(devices=) differs from one device: "
                             f"{rec}")
    return two_counts, rec


def nccl_association(ct, d, y, res_single, workdir, dev="cuda"):
    """Phase mesh (c): one process joins a process group of one over NCCL
    (a ``file://`` store, no network), builds ``launch.global_mesh`` of
    two slots on this card and runs the association of phase 4's 100,000
    cells through it; ``assert_agreement`` on p and ``ncorrs`` goes
    through NCCL's all-gather."""
    import torch

    from cna_tpu_torch.parallel import launch
    from cna_tpu_torch.tools._nam import _DIFFUSION_PATH_KEY

    # NCCL's bootstrap needs an interface even for a world of one; the
    # machine has no network, so it takes the loopback
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    ct.config.set_device(dev)
    ct.config.enable_x64(False)
    slot = "cuda:0" if dev == "cuda" else dev
    launch.initialize_distributed(f"file://{workdir}/pg", num_processes=1,
                                  process_id=0)
    try:
        backend = torch.distributed.get_backend()
        mesh = launch.global_mesh(perms=1, local_devices=[slot] * 2)
        t0 = time.perf_counter()
        res = ct.tl.association(d, y, "id", Nnull=1000, seed=0, mesh=mesh,
                                return_full=True)
        sync(dev)
        seconds = time.perf_counter() - t0
        launch.assert_agreement(res.p, "global_p")
        launch.assert_agreement(res.ncorrs, "ncorrs")
        rec = dict(backend=backend, info=launch.process_info(),
                   mesh=mesh.shape, path=d.uns[_DIFFUSION_PATH_KEY],
                   seconds=seconds, p=(res_single.p, res.p),
                   k=(res_single.k, res.k),
                   ncorrs_corr=float(np.corrcoef(
                       np.asarray(res_single.ncorrs),
                       np.asarray(res.ncorrs))[0, 1]))
    finally:
        torch.distributed.destroy_process_group()
    want = "nccl" if dev == "cuda" else "gloo"
    if not (backend == want and rec["path"] == "halo"
            and res.p == res_single.p and res.k == res_single.k
            and rec["ncorrs_corr"] > FORMAT_NCORR_MIN):
        raise AssertionError(f"the NCCL mesh association: {rec}")
    return rec


def sync(dev):
    import torch

    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def count_data(ct, dev, n_samples, cells_per_sample, n_genes, chunk=4096):
    """An atlas-like sparse count matrix made on ``dev`` from fixed seeds:
    ``n_samples`` x ``cells_per_sample`` cells x ``n_genes`` genes, a
    scipy CSR float32 X on the host.  Its first ``SIGNAL_GENES`` genes carry
    ``synthetic_dataset``'s case signal (trajectories, seed 0) as Poisson
    counts of ``SIGNAL_SCALE * exp(SIGNAL_GAIN * z)``, z each gene's values
    standardised; the rest are background genes, Poisson counts of gene
    means drawn lognormal (seed 1).  Returns (CellData, phenotype)."""
    import pandas as pd
    import scipy.sparse as sp
    import torch

    ct.config.set_device(dev)
    ct.config.enable_x64(False)
    base, samplem = ct.data.synthetic_dataset(
        n_samples=n_samples, cells_per_sample=cells_per_sample,
        n_genes=SIGNAL_GENES, seed=0, structure="manifold")
    n = base.n_obs
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    mu = torch.exp(BACKGROUND_LOG_MEAN + BACKGROUND_LOG_SD * torch.randn(
        n_genes - SIGNAL_GENES, generator=gen, device=dev))
    x_sig = torch.as_tensor(base.X, device=dev)
    x_sig = (x_sig - x_sig.mean(0)) / x_sig.std(0)
    row_nnz, cols, vals = [], [], []
    for lo in range(0, n, chunk):
        lam = torch.cat([SIGNAL_SCALE * torch.exp(
            SIGNAL_GAIN * x_sig[lo:lo + chunk]),
                         mu.expand(min(chunk, n - lo), -1)], dim=1)
        counts = torch.poisson(lam, generator=gen)
        nz = counts.nonzero()  # row-major
        row_nnz.append(torch.bincount(nz[:, 0], minlength=lam.shape[0]).cpu())
        cols.append(nz[:, 1].to(torch.int32).cpu())
        vals.append(counts[nz[:, 0], nz[:, 1]].cpu())
    indptr = np.zeros(n + 1, np.int64)
    np.cumsum(torch.cat(row_nnz).numpy(), out=indptr[1:])
    x = sp.csr_matrix((torch.cat(vals).numpy(), torch.cat(cols).numpy(),
                       indptr), shape=(n, n_genes))
    var = pd.DataFrame(index=pd.Index([f"gene_{i}" for i in range(n_genes)],
                                      name="gene"))
    d = ct.CellData(X=x, obs=base.obs, var=var, samplem=samplem,
                    sid_name="id")
    return d, samplem["case"].astype(float)


def layout_ratio(emb, knn, cells, seed):
    """``tests/test_umap.py``'s layout quality on ``cells`` sampled cells
    (``knn``: the directed kNN CSR): mean 2-D distance to their kNN
    neighbours over that to random cells, for the layout and for a
    shuffled copy of it.  Returns (ratio, shuffled ratio)."""
    rng = np.random.RandomState(seed)
    n = emb.shape[0]
    sample = rng.choice(n, cells, replace=False)

    def ratio(e):
        num, den = [], []
        for i in sample:
            nbrs = knn.indices[knn.indptr[i]:knn.indptr[i + 1]]
            rand = rng.randint(0, n, len(nbrs))
            num.append(np.linalg.norm(e[nbrs] - e[i], axis=1).mean())
            den.append(np.linalg.norm(e[rand] - e[i], axis=1).mean())
        return float(np.mean(num) / np.mean(den))

    return ratio(emb), ratio(emb[rng.permutation(n)])


def epoch_bytes(groups, n, n_epochs, r_neg=5):
    """Least bytes an epoch of the UMAP engine moves, averaged over
    ``n_epochs``: each due edge reads its two endpoint rows (8 B each), its
    head and tail ids (4 B each), its window index (4 B) and its window of
    ``r_neg`` rows (8 B each); the negative table's refresh reads its ids
    and rows and writes its rows (4 + 8 + 8 B an entry); the positions are
    read and written once (8 B a row each way)."""
    per_edge = 2 * 8 + 2 * 4 + 4 + r_neg * 8
    table = (n // r_neg) * r_neg * (4 + 8 + 8)
    total = 0.0
    for i in range(n_epochs):
        due = sum(g["heads"].shape[0] for g in groups
                  if (i + 1) % g["period"] == 0)
        total += due * per_edge + table + 2 * 8 * n
    return total / n_epochs


def umap_record(ct, d, dev, cells, timed, n_epochs=200):
    """``pp.umap`` on ``d``'s graph (init 'auto', seed 0) through the
    public entry point, then again with the same seed, held to the first
    run bit for bit: with ``timed``, its epochs alone on the same start
    and groups, timed with CUDA events; else a second ``pp.umap``.  The
    layout quality on ``cells`` sampled cells.  Returns a record."""
    import importlib

    import torch

    from cna_tpu_torch.utils import profiling

    um = importlib.import_module("cna_tpu_torch.pp.umap")
    prof = profiling.global_profiler()
    first = len(prof.phases)
    t0 = time.perf_counter()
    emb = ct.pp.umap(d, seed=0)
    rec = dict(cells=d.n_obs, umap_s=time.perf_counter() - t0,
               phases={p["phase"]: p["seconds"]
                       for p in prof.phases[first:]},
               init=d.uns["umap"]["init"], epochs=n_epochs)
    conn = d.obsp["connectivities"]
    heads, tails, eps = um._umap_edges(conn, n_epochs)
    groups = um._period_structure(heads, tails, eps, d.n_obs)
    rec["edges"] = int(heads.shape[0])
    rec["groups"] = [(g["period"], int(g["heads"].shape[0]))
                     for g in groups]
    if timed:
        pos0, _ = um.initial_layout(d, conn, rec["init"], seed=0)
        pos0 = torch.as_tensor(pos0, device=dev)
        a, b = um._fit_ab()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        again = um._optimize_layout(pos0, groups, a, b, n_epochs, seed=0)
        stop.record()
        torch.cuda.synchronize()
        rec["ms_per_epoch"] = start.elapsed_time(stop) / n_epochs
        again = again.cpu().numpy()
    else:
        again = ct.pp.umap(d, seed=0, key_added="X_umap_again")
        del d.obsm["X_umap_again"]
    rec["same_bits_twice"] = bool(np.array_equal(again, emb))
    nbytes = epoch_bytes(groups, d.n_obs, n_epochs)
    rec["epoch_bytes"] = nbytes
    rec["epoch_bound_ms"] = 1e3 * nbytes / PEAK_BYTES_PER_S
    ratio, ratio_null = layout_ratio(emb, d.obsp["distances"].tocsr(),
                                     cells, seed=0)
    rec.update(quality_ratio=ratio, shuffled_ratio=ratio_null,
               finite=bool(np.isfinite(emb).all()))
    failed = []
    if not rec["same_bits_twice"]:
        failed.append("two runs of the same seed differ")
    if not (rec["finite"] and emb.shape == (d.n_obs, 2)):
        failed.append("layout shape or finiteness")
    if not (ratio < UMAP_RATIO_MAX and ratio_null > UMAP_NULL_MIN):
        failed.append("layout quality")
    if failed:
        raise AssertionError(f"pp.umap at {d.n_obs} cells: {failed}: {rec}")
    return rec


def frames_equal(a, b):
    """Two DataFrames hold the same columns with the same values (and the
    same index labels), bit for bit."""
    if list(a.columns) != list(b.columns) or not np.array_equal(
            a.index.to_numpy().astype(str), b.index.to_numpy().astype(str)):
        return False
    return all(np.array_equal(np.asarray(a[c]), np.asarray(b[c]))
               for c in a.columns)


def csr_equal(a, b):
    return (a.shape == b.shape and np.array_equal(a.indptr, b.indptr)
            and np.array_equal(a.indices, b.indices)
            and np.array_equal(a.data, b.data) and a.dtype == b.dtype)


def atlas_entry_path(ct, dev="cuda", n_samples=50, cells_per_sample=2000,
                     n_genes=ATLAS_GENES, with_files=True, with_plots=True,
                     workdir=None):
    """Phase 10: a sparse count atlas through the user's whole path on
    ``dev``: (``write_h5ad`` -> ``read_h5ad``, with h5py) ->
    ``pp.select_hvg`` (held to the CPU's choice from the same matrix) ->
    ``pp.pca(n_comps=50)`` -> ``pp.neighbors`` (one ``knn_exact`` launch,
    counts reset before and read after) -> ``tl.association`` -> ``pp.umap``
    (spectral, 200 epochs, twice) -> (``pl.umap_ncorr`` and
    ``pl.violinplot`` to a PNG, with matplotlib) -> (``CellData.write`` ->
    ``read_h5ad``, equal bit for bit, with h5py).  Returns (launch counts,
    record)."""
    import torch

    from cna_tpu_torch.ops import launch_counts, reset_launch_counts
    from cna_tpu_torch.utils import profiling

    t0 = time.perf_counter()
    d, y = count_data(ct, dev, n_samples, cells_per_sample, n_genes)
    rec = dict(cells=d.n_obs, genes=n_genes, nnz=int(d.X.nnz),
               nnz_per_cell=d.X.nnz / d.n_obs,
               make_data_s=time.perf_counter() - t0,
               with_files=with_files, with_plots=with_plots)
    # the CPU's choice from the same matrix
    t0 = time.perf_counter()
    ct.config.set_device("cpu")
    keep_cpu = ct.pp.select_hvg(ct.CellData(X=d.X), n_top=HVG_TOP,
                                subset=False)
    ct.config.set_device(dev)
    rec["cpu_select_hvg_s"] = time.perf_counter() - t0

    prof = profiling.enable_profiling()
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    t_path = time.perf_counter()
    if with_files:
        path = os.path.join(workdir, "atlas.h5ad")
        x_written = d.X
        ct.data.write_h5ad(d, path)
        rec["file_mb"] = os.path.getsize(path) / 1e6
        d = ct.read_h5ad(path)
        rec["read_X_equal"] = csr_equal(x_written, d.X)
        del x_written
    keep = ct.pp.select_hvg(d, n_top=HVG_TOP)
    ct.pp.pca(d, n_comps=50)
    reset_launch_counts()
    ct.pp.neighbors(d, n_neighbors=15)
    sync(dev)
    counts = launch_counts()
    res = ct.tl.association(d, y, "id", Nnull=1000, seed=0,
                            return_full=True)
    rec["umap"] = umap_record(ct, d, dev, cells=500, timed=False)
    if with_plots:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        t0 = time.perf_counter()
        fig, axes = plt.subplots(1, 2, figsize=(12, 5))
        ct.pl.umap_ncorr(d, ax=axes[0])
        ct.pl.violinplot(d, "batch", ax=axes[1])
        png = os.path.join(workdir, "atlas_umap.png")
        fig.savefig(png, dpi=80)
        plt.close(fig)
        rec["plots_s"] = time.perf_counter() - t0
        rec["png_kb"] = os.path.getsize(png) / 1e3
    if with_files:
        path = os.path.join(workdir, "atlas_result.h5ad")
        d.write(path)
        back = ct.read_h5ad(path)
        rec["round_trip"] = dict(
            X=csr_equal(d.X, back.X), obs=frames_equal(d.obs, back.obs),
            obsm={k: bool(np.array_equal(np.asarray(d.obsm[k]),
                                         back.obsm[k]))
                  for k in ("X_pca", "X_umap")},
            obsp={k: csr_equal(d.obsp[k].tocsr(), back.obsp[k])
                  for k in ("connectivities", "distances")})
    sync(dev)
    rec["path_s"] = time.perf_counter() - t_path
    rec["phases"] = [(p["phase"], round(p["seconds"], 4))
                     for p in prof.phases]
    rec.update(p=res.p, k=res.k, hvg_same_as_cpu=bool(np.array_equal(
        keep, keep_cpu)), signal_genes_kept=int(keep[:SIGNAL_GENES].sum()),
        knn_method_resolved=d.uns["neighbors"]["params"][
            "knn_method_resolved"], launches=counts)
    if torch.device(dev).type == "cuda":
        rec["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9

    failed = []
    if not rec["hvg_same_as_cpu"]:
        failed.append("HVG set differs from the CPU's")
    if rec["signal_genes_kept"] != SIGNAL_GENES:
        failed.append("signal genes not all among the HVGs")
    if d.X.shape != (d.n_obs, HVG_TOP):
        failed.append("X not subset to the HVGs")
    if not res.p < 0.05:
        failed.append("p >= 0.05")
    if torch.device(dev).type == "cuda" and counts.get("knn_exact", 0) != 1:
        failed.append("knn_exact not launched exactly once")
    if with_files and not (rec["read_X_equal"] and all(
            v if isinstance(v, bool) else all(v.values())
            for v in rec["round_trip"].values())):
        failed.append("file round trip")
    if failed:
        raise AssertionError(f"atlas entry path: {failed}: {rec}")
    return counts, rec


def fused_vs_dense(ct, d, y, nnull, seed=3):
    """The local test's two FDR branches on the same residualized NAM and
    the same ``null_y``: the fused tail counts that an association of
    ``d`` takes (cells x 1,000 local nulls above
    ``_FUSED_FDR_MIN_ELEMENTS``) against the dense (cells x 1,000) null
    coefficient matrix.  Both run ``tools._association._association`` on
    one NAM, so that the diffusion's atomics cannot move the thresholds."""
    import torch

    from cna_tpu_torch.tools import _association as assoc
    from cna_tpu_torch.tools._nam import _resid_nam

    batches, keep = assoc.check_inputs(d, y, "id", None, None, None, False)
    arrays, _, batches, _, _, keep = assoc._compute_nam_arrays_and_reindex(
        d, y, "id", batches, None, None, keep, None, False)
    n = int(keep.sum())
    res = _resid_nam(arrays, None, batches[keep],
                     npcs=min(n, max(10, int(0.15 * n))))
    dev = res._dev
    ys = y[keep].to_numpy()
    ys = (ys - ys.mean()) / ys.std(ddof=0)
    rng = np.random.RandomState(seed)
    null_y = np.stack([ys[rng.permutation(n)] for _ in range(nnull)], 1)
    n_cells = int(dev.namresid.shape[1])
    if n_cells * min(1000, nnull) <= assoc._FUSED_FDR_MIN_ELEMENTS:
        raise AssertionError(f"{n_cells} cells do not take the fused branch")

    def run():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = assoc._association(
            (dev.u, dev.svs, dev.v), dev.namresid, dev.m, dev.r,
            y[keep].values, batches[keep].values, None, Nnull=nnull,
            null_y=null_y)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0, \
            torch.cuda.max_memory_allocated() / 1e9

    fused, fused_s, fused_gb = run()
    threshold = assoc._FUSED_FDR_MIN_ELEMENTS
    assoc._FUSED_FDR_MIN_ELEMENTS = n_cells * 1000
    try:
        dense, dense_s, dense_gb = run()
    finally:
        assoc._FUSED_FDR_MIN_ELEMENTS = threshold
    a = fused.fdrs.fdr.to_numpy(dtype=np.float64)
    b = dense.fdrs.fdr.to_numpy(dtype=np.float64)
    rec = dict(cells=n_cells, nulls=min(1000, nnull),
               fused_s=fused_s, dense_s=dense_s, fused_peak_gb=fused_gb,
               dense_peak_gb=dense_gb, thresholds=len(b),
               p=(fused.p, dense.p), k=(fused.k, dense.k))
    same_grid = np.array_equal(fused.fdrs.threshold, dense.fdrs.threshold)
    rec["same_grid"] = same_grid
    if same_grid:
        diff = np.abs(a - b)
        rec["fdr_max_abs_diff"] = float(diff.max())
        rec["fdr_max_rel_diff"] = float(np.max(
            np.divide(diff, b, out=np.zeros_like(diff), where=b > 0)))
        rec["fdr_thresholds_differ"] = int(np.count_nonzero(diff))
    if not (same_grid and fused.p == dense.p and fused.k == dense.k
            and np.isfinite(a).all()
            and np.array_equal(fused.fdrs.num_detected,
                               dense.fdrs.num_detected)
            and np.allclose(a, b, rtol=FDR_FUSED_RTOL,
                            atol=FDR_FUSED_ATOL)):
        raise AssertionError(f"the fused and dense FDR branches disagree: "
                             f"{rec}")
    return rec


def northstar_phase(ct):
    """Phase 12: the north-star configuration and bench.py's default one
    through ``bench_torch.bench``, with gates (a) to (e) (module
    docstring).  Returns (north-star record, default record, checks)."""
    import torch

    import bench_torch

    cells, nnull, samples = NORTHSTAR
    ct.config.set_device("cuda")
    ct.config.enable_x64(False)
    t0 = time.perf_counter()
    keep = {}
    ns = bench_torch.bench(cells, nnull, samples, keep=keep)
    checks = {"northstar_bench_s": time.perf_counter() - t0}
    log("north-star bench:", json.dumps(ns))
    ex = ns["extras"]
    failed = []
    if ex["knn_method_resolved"] != "ivf":
        failed.append(f"kNN method {ex['knn_method_resolved']!r}")
    if not ex.get("ivf", {}).get("verify_recall", 0) >= IVF_MIN_RECALL:
        failed.append("IVF recall")
    for build in ("graph_cold", "graph_warm_first", "graph_warm"):
        if ex["kernel_launches"][build].get("ivf_score", 0) < 1:
            failed.append(f"no ivf_score launch in {build}")
    for p, k in zip(ex["p"], ex["k"]):
        if not (np.isfinite(p) and 0 < p <= 1 and k >= 1):
            failed.append(f"p {p}, k {k}")
    if failed:
        raise AssertionError(f"north-star bench: {failed}")

    # (b) the cold association's seed again
    d, y, cold = keep["d"], keep["y"], keep["res_cold"]
    again_s, again = bench_torch.run_association(d, y, nnull, seed=0)
    r = float(np.corrcoef(cold.ncorrs, again.ncorrs)[0, 1])
    checks["same_seed"] = dict(p=(cold.p, again.p), k=(cold.k, again.k),
                               ncorrs_corr=r, seconds=again_s)
    if cold.p != again.p or cold.k != again.k \
            or not r > SAME_SEED_NCORR_MIN:
        raise AssertionError(f"one seed twice: {checks['same_seed']}")
    # a diffusion step of this graph at the north-star's width and at the
    # 50 samples of every earlier path
    checks["step_ms"] = {f"s{s}": step_ms(d, "bucketed", s)
                         for s in (samples, 50)}
    del cold, again, keep

    # (c) the fused FDR branch against the dense one at this size
    checks["fdr_fused_vs_dense"] = fused_vs_dense(ct, d, y, nnull)
    del d, y
    torch.cuda.empty_cache()

    # (d) card vs CPU at the north-star's width
    t0 = time.perf_counter()
    checks["card_vs_cpu_200"] = card_vs_cpu(
        ct, n_samples=WIDE_CARD_VS_CPU[0],
        cells_per_sample=WIDE_CARD_VS_CPU[1])
    checks["card_vs_cpu_200_s"] = time.perf_counter() - t0
    ct.config.set_device("cuda")
    ct.config.enable_x64(False)

    # (e) bench.py's defaults: 100,000 cells x 50 samples x 1,000
    # permutations, the exact kNN kernel once per graph build
    t0 = time.perf_counter()
    default = bench_torch.bench()
    checks["default_bench_s"] = time.perf_counter() - t0
    log("default bench:", json.dumps(default))
    ex = default["extras"]
    launches = ex["kernel_launches"]
    if ex["knn_method_resolved"] != "pallas" or any(
            launches[b].get("knn_exact", 0) != 1
            for b in ("graph_cold", "graph_warm_first", "graph_warm")) \
            or not all(np.isfinite(p) and 0 < p <= 1 for p in ex["p"]):
        raise AssertionError(f"default bench: {ex}")
    return ns, default, checks


def gather_case(label, graph, codes, seed=11):
    """The gather SpMM kernel on ``graph`` (a card graph of the default
    format) with a random (N, S) state, S the samples of ``codes`` (each
    row's sample, in the graph's row order): one launch a step, the step
    held to the plain step on the card and to the float64 step on the
    CPU, two launches bit-identical; the association's own first states
    (the one-hot of ``codes`` and the kernel's next two steps from it,
    mostly exact zeros) held to the plain step alike; the kernel alone,
    the whole step (the kernel and the COO spill), the plain step and
    ``torch.sparse.mm`` of the graph's CSR timed beside the bytes bound;
    the peak memory a step allocates; returns a record."""
    import torch

    from cna_tpu_torch.graph.device import DeviceConnectivities
    from cna_tpu_torch.ops import _build, spmm

    n = graph.n_rows
    s_cols = int(codes.max()) + 1
    gen = torch.Generator(device=graph.device)
    gen.manual_seed(seed)
    state = torch.rand((n, s_cols), generator=gen, device=graph.device,
                       dtype=graph.dtype)
    colsums = graph.colsums(1)
    args = spmm.kernel_slots(graph)

    def kernel():
        return spmm.gather_spmm(state, *args, colsums, 1)

    def step():
        return spmm.diffusion_step(state, graph, colsums, 1)

    def plain():
        return spmm.diffusion_step_plain(state, graph, colsums, 1)

    def peak_mb(fn):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = fn()
        torch.cuda.synchronize()
        del out
        return (torch.cuda.max_memory_allocated() - base) / 1e6

    before = _build.launch_counts().get(spmm.KERNEL, 0)
    y = step()
    torch.cuda.synchronize()
    launches = _build.launch_counts().get(spmm.KERNEL, 0) - before
    ref = plain()
    scale = float(ref.abs().max())
    rel = float((y - ref).abs().max()) / scale
    cpu_graph = graph_on(graph, "cpu", torch.float64)
    cpu_ref = spmm.diffusion_step_plain(
        state.cpu().double(), cpu_graph, cpu_graph.colsums(1), 1)
    cpu_rel = float((y.cpu().double() - cpu_ref).abs().max()) / scale
    del ref, cpu_ref, cpu_graph
    same_bits = torch.equal(kernel(), kernel())
    onehot = (codes.to(graph.device)[:, None] == torch.arange(
        s_cols, device=graph.device)).to(graph.dtype)
    starts, st = [], onehot
    for _ in range(3):
        y_st = spmm.diffusion_step(st, graph, colsums, 1)
        ref_st = spmm.diffusion_step_plain(st, graph, colsums, 1)
        starts.append(dict(
            zero_share=float((st == 0).double().mean()),
            max_rel_err=float((y_st - ref_st).abs().max())
            / float(ref_st.abs().max()),
            bit_identical=torch.equal(
                spmm.gather_spmm(st, *args, colsums, 1),
                spmm.gather_spmm(st, *args, colsums, 1))))
        st = y_st
    del onehot, st, y_st, ref_st
    rec = dict(label=label, graph=type(graph).__name__, n=n, s=s_cols,
               dtype=str(graph.dtype).replace("torch.", ""),
               launches_per_step=launches, max_rel_err=rel,
               cpu_f64_rel_err=cpu_rel, bit_identical=same_bits,
               start_states=starts,
               buckets=len(getattr(graph, "ext_indices", ())),
               coo_tail=int(graph.overflow_rows.shape[0]),
               launch_shape=spmm.launch_shape(
                   s_cols, state.element_size(), state.data_ptr(),
                   state.stride(0)))
    if launches != 1 or not same_bits or rel > GATHER_RTOL \
            or cpu_rel > GATHER_CPU_RTOL \
            or any(st["max_rel_err"] > GATHER_RTOL or not st["bit_identical"]
                   for st in starts):
        raise AssertionError(f"gather_spmm {label}: {rec}")

    r, c, v = DeviceConnectivities(graph, None, n).edges()
    lib = torch.sparse_coo_tensor(torch.stack([r, c]), v, (n, n))
    lib = lib.coalesce().to_sparse_csr()
    nnz = int(v.numel())

    def library():
        t = state / colsums[:, None]
        return torch.sparse.mm(lib, t) + t

    lib_rel = float((library() - y).abs().max()) / scale
    item = state.element_size()
    nbytes = 2.0 * n * s_cols * item + n * item + (4.0 + item) * nnz
    flops = 2.0 * nnz * s_cols + 3.0 * n * s_cols
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES_PER_S
    weights = [args[1], *args[3]]
    rec.update(
        nnz=nnz, slots=sum(int(w.numel()) for w in weights), flops=flops,
        bytes=nbytes, bound_ms=1e3 * max(t_ops, t_bytes),
        bound_by="operations" if t_ops >= t_bytes else "bytes",
        library_rel_err=lib_rel,
        ms=cuda_ms(kernel, GATHER_REPS), step_ms=cuda_ms(step, GATHER_REPS),
        plain_ms=cuda_ms(plain, 3), library_ms=cuda_ms(library, 5),
        step_peak_mb=peak_mb(step), plain_peak_mb=peak_mb(plain))
    rec["roofline_pct"] = 100.0 * rec["bound_ms"] / rec["step_ms"]
    return rec


def graph_on(graph, dev, dtype):
    """``graph`` with its tensors on ``dev`` and its weights in
    ``dtype``."""
    import dataclasses

    import torch

    def move(v):
        if isinstance(v, tuple):
            return tuple(move(t) for t in v)
        if not isinstance(v, torch.Tensor):
            return v
        return v.to(dev, dtype) if v.is_floating_point() else v.to(dev)

    return dataclasses.replace(graph, **{
        f.name: move(getattr(graph, f.name))
        for f in dataclasses.fields(graph)})


def gather_phase(ct):
    """Phase 13: ``gather_case`` on phase 4's 100,000-cell graph at 50
    columns and on the tuberculosis-atlas deployment's IVF graph
    (500,089 cells, ``cnabench/data/tb.py`` from seed 1) at 259 columns,
    then that deployment's ``tl.nam`` with its 46 batches, its
    ``gather_spmm`` launches held to its diffusion steps
    (``diffusion_launches``); returns the two records."""
    import torch

    from cna_tpu_torch.ops import launch_counts, reset_launch_counts
    from cna_tpu_torch.tools._nam import get_device_graph
    from cna_tpu_torch.utils import profiling
    from cnabench.data import tb

    def graph_codes(d):
        # the card graph and each row's sample, in the graph's row order
        graph, ordering = get_device_graph(d)
        codes = np.unique(d.obs["id"].to_numpy(), return_inverse=True)[1]
        if ordering is not None:  # perm[compact] = original
            codes = codes[ordering.perm]
        return graph, torch.as_tensor(codes)

    recs = []
    d, _ = dataset(ct, cells_per_sample=2000)
    ct.pp.pca(d, n_comps=20)
    ct.pp.neighbors(d, n_neighbors=15)
    recs.append(gather_case("100k x 50", *graph_codes(d)))
    del d
    torch.cuda.empty_cache()
    with open(os.path.join(HERE, "cnabench", "configs", "tb_500k.json")) as f:
        cfg = json.load(f)
    t0 = time.perf_counter()
    x, obs, samplem = tb.tb_atlas(cfg, 1)
    d = ct.CellData(X=x, obs=obs)
    ct.pp.pca(d, n_comps=cfg["n_comps"])
    ct.pp.neighbors(d, n_neighbors=cfg["n_neighbors"],
                    method=cfg["knn_method"])
    build_s = time.perf_counter() - t0
    rec = gather_case(f"tb_500k {cfg['n_cells']} x {cfg['n_samples']}",
                      *graph_codes(d))
    rec["graph_build_s"] = build_s
    prof = profiling.enable_profiling()
    try:
        reset_launch_counts()
        ct.tl.nam(d, "id", batches=samplem["batch"])
        torch.cuda.synchronize()
        rec["nam_steps"] = diffusion_launches(prof.phases, launch_counts(),
                                              "tb_500k tl.nam")
    finally:
        profiling.disable_profiling()
    recs.append(rec)
    del d
    torch.cuda.empty_cache()
    return recs


def compare_with_tree(tree, inputs, exact_res):
    """``--against DIR``: the package of the checkout at ``tree`` runs
    ``knn_exact`` on ``inputs`` and the 100,000-cell path in a second
    process on this card; its output must equal this checkout's bit for
    bit (the kNN results here, ``exact_res`` of phase 4)."""
    import torch

    from cna_tpu_torch.ops import _build, knn

    work = _build.BUILD_DIR / "against"
    work.mkdir(parents=True, exist_ok=True)
    in_path, out_path = work / "inputs.pt", work / "outputs.pt"
    torch.save({label: (x.cpu(), k) for label, x, k in inputs}, in_path)
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, os.path.abspath(__file__),
                          "--against-worker", tree, str(in_path),
                          str(out_path)], timeout=900)
    if res.returncode != 0:
        raise AssertionError(f"the package at {tree} failed "
                             f"(exit {res.returncode})")
    other = torch.load(out_path, weights_only=False)
    knn_equal = {}
    for label, x, k in inputs:
        negd, idx = knn.knn_exact(x, k)
        o_negd, o_idx = other["knn"][label]
        knn_equal[label] = (torch.equal(negd.cpu(), o_negd)
                            and torch.equal(idx.cpu(), o_idx))
    ncorrs = np.asarray(exact_res.ncorrs)
    nam = exact_res.nam.to_numpy()
    rec = dict(tree=tree, other_package=other["package"],
               seconds=time.perf_counter() - t0, knn_equal=knn_equal,
               other_launches=other["launches"], p=(exact_res.p, other["p"]),
               k=(exact_res.k, other["k"]),
               ncorrs_equal=bool(np.array_equal(ncorrs, other["ncorrs"])),
               nam_equal=bool(np.array_equal(nam, other["nam"])))
    if not (all(knn_equal.values()) and rec["ncorrs_equal"]
            and rec["nam_equal"] and exact_res.p == other["p"]
            and exact_res.k == other["k"]):
        raise AssertionError(f"this checkout and {tree} disagree: {rec}")
    return rec


def against_worker(tree, in_path, out_path) -> int:
    """The second process of ``--against``: the package of the checkout at
    ``tree`` on the saved inputs and the 100,000-cell path."""
    import torch

    root = os.path.abspath(tree)
    sys.path.insert(0, root)
    import cna_tpu_torch as ct
    from cna_tpu_torch.ops import knn, launch_counts, reset_launch_counts

    if not os.path.abspath(ct.__file__).startswith(root + os.sep):
        raise RuntimeError(f"imported {ct.__file__}, not the package at "
                           f"{root}")
    outs = {}
    for label, (x, k) in torch.load(in_path).items():
        negd, idx = knn.knn_exact(x.cuda(), k)
        outs[label] = (negd.cpu(), idx.cpu())
    d, y = dataset(ct, cells_per_sample=2000)
    reset_launch_counts()
    ct.pp.pca(d, n_comps=20)
    ct.pp.neighbors(d, n_neighbors=15, method="auto")
    res = ct.tl.association(d, y, "id", Nnull=1000, seed=0,
                            return_full=True)
    torch.save(dict(package=ct.__file__, knn=outs, p=res.p, k=res.k,
                    ncorrs=np.asarray(res.ncorrs), nam=res.nam.to_numpy(),
                    launches=launch_counts()), out_path)
    return 0


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    if argv[:1] == ["--against-worker"] and len(argv) == 4:
        return against_worker(*argv[1:])
    against = None
    if argv:
        if argv[0] != "--against" or len(argv) != 2:
            print("usage: chip_smoke.py [--against DIR]", file=sys.stderr)
            return 2
        against = argv[1]
    sys.path.insert(0, HERE)
    try:
        import cna_tpu_torch as ct
        from cna_tpu_torch.ops import _build, ivf, kmeans, knn, spmm_banded
    except ImportError as exc:
        print(f"chip_smoke: cna_tpu_torch not found beside this script "
              f"({exc})", file=sys.stderr)
        return 1

    t_start = time.perf_counter()
    kind = torch.cuda.get_device_name(0)
    smi = card_line()
    log(f"card: {kind}; nvidia-smi: {smi}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")

    t0 = time.perf_counter()
    build_s = _build.build_all()
    log(f"build: nvcc seconds {json.dumps(build_s)}, started together, "
        f"{time.perf_counter() - t0:.2f} s in all")
    for name in _build.KERNELS:
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "stack frame" in line:
                log(f"  ptxas {name}:", line.strip())
    hmma = {}
    for name in (knn.KERNEL, ivf.KERNEL, kmeans.KERNEL):
        hmma[name] = _build.sass_count(name, "HMMA")
        log(f"build: {hmma[name]} HMMA (tensor-core) opcodes in {name}'s "
            "SASS")
        if hmma[name] < 1:
            raise AssertionError(f"{name} was built without tensor-core "
                                 "opcodes")

    knn_cases = knn_inputs()
    cases = [check_knn_case(label, x, k, timed=(i == 0))
             for i, (label, x, k) in enumerate(knn_cases)]
    for rec in cases:
        log("knn_exact vs plain:", json.dumps(rec))
    ivf_cases = ivf_odd_cases() + ivf_attack_cases()
    for rec in ivf_cases:
        log("ivf_score vs plain:", json.dumps(rec))
    banded_cases = banded_odd_cases()
    for rec in banded_cases:
        log("banded_spmm vs plain:", json.dumps(rec))

    counts, slice_rec, exact_res, d100k, y100k = main_path(ct)
    log("100k path:", json.dumps(slice_rec))
    log("100k-path launches:", json.dumps(counts))
    if against is not None:
        log("against:", json.dumps(compare_with_tree(against, knn_cases,
                                                     exact_res)))
    del knn_cases

    atlas_counts, atlas_rec, scores_dev, u = atlas_path(ct)
    log("1M path:", json.dumps(atlas_rec))
    log("1M-path launches:", json.dumps(atlas_counts))
    ivf_main = check_ivf_main_shape(scores_dev, u, 15)
    torch.cuda.empty_cache()
    log("ivf_score vs plain:", json.dumps(ivf_main))
    ivf_cases.append(ivf_main)
    kmeans_main = kmeans_phase(scores_dev)
    torch.cuda.empty_cache()
    log("kmeans_assign vs plain:", json.dumps(kmeans_main))

    log("ivf vs exact at 100k:", json.dumps(ivf_vs_exact(ct, exact_res)))

    cmp_rec = card_vs_cpu(ct)
    log("card vs cpu:", json.dumps(cmp_rec))

    banded_counts, banded_rec, banded_main, manifold = banded_path(ct)
    log("banded 1M path:", json.dumps(banded_rec))
    log("banded-1M-path launches:", json.dumps(banded_counts))
    log("banded_spmm vs plain:", json.dumps(banded_main))
    banded_cases.append(banded_main)
    torch.cuda.empty_cache()

    log("block and hybrid at 100k:", json.dumps(block_formats(ct)))
    torch.cuda.empty_cache()

    # h5py and matplotlib are optional: without them phase 10 starts from
    # and stops at the in-memory CellData and draws no picture (stated on
    # the line below); where they are present, those steps run and must
    # pass
    with_files = importlib.util.find_spec("h5py") is not None
    with_plots = importlib.util.find_spec("matplotlib") is not None
    log(f"atlas entry path: h5py {'present' if with_files else 'absent'}, "
        f"matplotlib {'present' if with_plots else 'absent'}: the h5ad "
        f"steps {'run' if with_files else 'are left out'}, the plots "
        f"{'run' if with_plots else 'are left out'}")
    with tempfile.TemporaryDirectory() as workdir:
        entry_counts, entry_rec = atlas_entry_path(
            ct, with_files=with_files, with_plots=with_plots,
            workdir=workdir)
    log("100k atlas entry path:", json.dumps(entry_rec))
    log("100k-atlas-entry-path launches:", json.dumps(entry_counts))

    # the mesh phase: (a) phase 8's 1M manifold graph under 4 x 1 and
    # 2 x 2 meshes of this card's slots, (b) phase 5's points through
    # ivf_knn(devices=), (c) a process group of one over NCCL
    t0 = time.perf_counter()
    mesh_rec = mesh_association(ct, *manifold,
                                banded_rec["step_ms_default"])
    log("mesh (a) 1M manifold association on one-card meshes:",
        json.dumps(mesh_rec))
    del manifold
    torch.cuda.empty_cache()
    ivf_dev_counts, ivf_dev_rec = ivf_devices(ct, scores_dev)
    log("mesh (b) ivf_knn(devices=['cuda:0', 'cuda:0']) at 1M:",
        json.dumps(ivf_dev_rec))
    log("mesh-(b) launches:", json.dumps(ivf_dev_counts))
    del scores_dev
    with tempfile.TemporaryDirectory() as workdir:
        nccl_rec = nccl_association(ct, d100k, y100k, exact_res, workdir)
    log("mesh (c) NCCL process group of one, 100k association:",
        json.dumps(nccl_rec))
    log(f"mesh phase: {time.perf_counter() - t0:.1f} s")
    del d100k, y100k
    torch.cuda.empty_cache()

    # the north-star configuration and bench.py's default one, through
    # bench_torch (phase 12)
    t0 = time.perf_counter()
    ns_rec, default_rec, ns_checks = northstar_phase(ct)
    log("north-star checks:", json.dumps(ns_checks))
    log(f"north-star phase: {time.perf_counter() - t0:.1f} s")

    # the diffusion step's gather SpMM at the main paths' shapes (phase 13)
    gather_recs = gather_phase(ct)
    for rec in gather_recs:
        log("gather_spmm vs plain:", json.dumps(rec))
    gather_main = gather_recs[-1]

    main_case = cases[0]
    kernels = [{
        "name": knn.KERNEL,
        "route": "cuda",
        "source": "cna_tpu_torch/csrc/knn_exact.cu",
        "replaces": "cna_tpu/ops/knn_pallas.py:44",
        "launches": counts.get(knn.KERNEL, 0),
        "max_abs_err": max(c["max_abs_err"] for c in cases),
        "ms": main_case["ms"],
        "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"],
        "bound_by": main_case["bound_by"],
        "library_ms": main_case["library_ms"],
        "recall": min(c["recall"] for c in cases),
        "max_rank_err": max(c["max_rank_err"] for c in cases),
        "shape": [main_case["n"], main_case["d"], main_case["k"]],
        # the bound is the tensor cores' (dense TF32); the same operations
        # at the float32 peak outside them, which was this row's bound
        # while the kernel ran there, is kept beside it; what the filter
        # let through to the exact float32 path, where the MMA warps' cycles
        # went, and a digest of the main case's output
        "fp32_bound_ms": main_case["fp32_bound_ms"],
        "mma_passes": main_case["mma_passes"],
        "exact_share": main_case["exact_share"],
        "mma_warp_cycles": main_case["mma_warp_cycles"],
        "digest": main_case["digest"],
        "hmma_opcodes": hmma[knn.KERNEL],
        # launches per graph build of bench_torch at its defaults (phase 12)
        "bench_launches": {b: default_rec["extras"]["kernel_launches"][b]
                           .get(knn.KERNEL, 0) for b in (
                               "graph_cold", "graph_warm_first",
                               "graph_warm")},
    }, {
        # times, bound and yardstick on every IVF_SHARE-th slot of the 1M
        # index (what the plain version is run on); "all_slots" holds the
        # kernel's time and bound over the whole search, one launch
        "name": ivf.KERNEL,
        "route": "cuda",
        "source": "cna_tpu_torch/csrc/ivf_score.cu",
        "replaces": "cna_tpu/ops/ivf_pallas.py:71",
        "launches": atlas_counts.get(ivf.KERNEL, 0),
        "max_abs_err": max(c["max_abs_err"] for c in ivf_cases),
        "ms": ivf_main["ms"],
        "plain_ms": ivf_main["plain_ms"],
        "bound_ms": ivf_main["bound_ms"],
        "bound_by": ivf_main["bound_by"],
        "library_ms": ivf_main["library_ms"],
        "recall": min(c["recall"] for c in ivf_cases),
        "shape": {key: ivf_main[key] for key in
                  ("slots", "f_pad", "g", "d_pad", "q_blocks", "probes",
                   "k")},
        "slot_share": f"1/{IVF_SHARE}",
        "all_slots": ivf_main["all_slots"],
        # the same search dealt over two slots of the card (phase 11 b)
        "devices_launches": ivf_dev_counts.get(ivf.KERNEL, 0),
        # the bound is the tensor cores' (dense TF32); the same operations
        # at the float32 peak outside them, which was this row's bound
        # while the kernel ran there, is kept beside it; and what the
        # filter let through to the exact float32 path
        "fp32_bound_ms": ivf_main["fp32_bound_ms"],
        "mma_passes": ivf_main["mma_passes"],
        "exact_share": ivf_main["exact_share"],
        "same_id_share": ivf_main["same_id_share"],
        "hmma_opcodes": hmma[ivf.KERNEL],
        # launches per graph build of the north-star bench (phase 12)
        "northstar_launches": {b: ns_rec["extras"]["kernel_launches"][b]
                               .get(ivf.KERNEL, 0) for b in (
                                   "graph_cold", "graph_warm_first",
                                   "graph_warm")},
    }, {
        # one assignment of the 1M IVF build's k-means sample; the bound is
        # the roofline's (the dense peak of cnabench/peaks.json), the TF32
        # and float32 ones beside it; the yardstick is the plain step the
        # kernel replaced (tile, argmin, one-hot, oh.T @ x)
        "name": kmeans.KERNEL,
        "route": "cuda",
        "source": "cna_tpu_torch/csrc/kmeans_assign.cu",
        "replaces": "cna_tpu_torch/pp/ivf_fine.py:_kmeans_fit_matmul "
                    "(plain PyTorch; no TPU kernel)",
        "launches": atlas_counts.get(kmeans.KERNEL, 0),
        "ms": kmeans_main["ms"],
        "plain_ms": kmeans_main["plain_ms"],
        "bound_ms": kmeans_main["bound_ms"],
        "bound_by": kmeans_main["bound_by"],
        "library_ms": kmeans_main["library_ms"],
        "tf32_bound_ms": kmeans_main["tf32_bound_ms"],
        "fp32_bound_ms": kmeans_main["fp32_bound_ms"],
        "shape": [kmeans_main["rows"], kmeans_main["c"], kmeans_main["d"]],
        "differ_share": kmeans_main["differ_share"],
        "exact_share": kmeans_main["exact_share"],
        "hmma_opcodes": hmma[kmeans.KERNEL],
        "northstar_launches": {b: ns_rec["extras"]["kernel_launches"][b]
                               .get(kmeans.KERNEL, 0) for b in (
                                   "graph_cold", "graph_warm_first",
                                   "graph_warm")},
    }, {
        # the in-band product at the 1M-cell manifold graph's own shape;
        # the library yardstick is torch.sparse.mm of the in-band edges
        "name": spmm_banded.KERNEL,
        "route": "cuda",
        "source": "cna_tpu_torch/csrc/banded_spmm.cu",
        "replaces": "cna_tpu/ops/spmm_pallas.py:216",
        "launches": banded_counts.get(spmm_banded.KERNEL, 0),
        "max_abs_err": max(c["max_abs_err"] for c in banded_cases),
        "max_rel_err": max(c["max_rel_err"] for c in banded_cases),
        "ms": banded_main["ms"],
        "plain_ms": banded_main["plain_ms"],
        "bound_ms": banded_main["bound_ms"],
        "bound_by": banded_main["bound_by"],
        "library_ms": banded_main["library_ms"],
        # the bound counts the bytes of the in-band edges; the figure that
        # counts every padded slot is kept beside it
        "all_slots_bound_ms": banded_main["all_slots_bound_ms"],
        "whole_slab_bytes_ms": banded_main["whole_slab_bytes_ms"],
        "shape": {key: banded_main[key] for key in
                  ("n", "n_pad", "k", "s", "row_tile", "slab_rows",
                   "in_band_edges", "compact_slots")},
    }, {
        # one diffusion step of the tuberculosis-atlas deployment's graph
        # (phase 13); "ms" is the launch alone, "step_ms" with the COO
        # spill; the library yardstick is torch.sparse.mm of the graph's
        # CSR with the division and the self term around it
        "name": "gather_spmm",
        "route": "cuda",
        "source": "cna_tpu_torch/csrc/gather_spmm.cu",
        "replaces": "cna_tpu_torch/ops/spmm.py:diffusion_step_plain "
                    "(plain PyTorch; the TPU package's step was an XLA "
                    "gather, no TPU kernel)",
        # launches of phase 4's association (the 100k path), each of its
        # diffusion steps one (drive_path checks them against the spans)
        "launches": counts.get("gather_spmm", 0),
        "diffusion_steps": slice_rec["diffusion_steps"],
        "tb_500k_nam_steps": gather_main["nam_steps"],
        "launches_per_step": gather_main["launches_per_step"],
        "max_rel_err": max(r["max_rel_err"] for r in gather_recs),
        "ms": gather_main["ms"],
        "step_ms": gather_main["step_ms"],
        "plain_ms": gather_main["plain_ms"],
        "bound_ms": gather_main["bound_ms"],
        "bound_by": gather_main["bound_by"],
        "library_ms": gather_main["library_ms"],
        "shape": {key: gather_main[key] for key in
                  ("n", "s", "nnz", "buckets", "coo_tail")},
        "at_100k": {key: gather_recs[0][key] for key in
                    ("ms", "step_ms", "plain_ms", "bound_ms",
                     "library_ms")},
        # the association's first states (mostly exact zeros): the worst
        # error against the plain step over both shapes
        "start_states_max_rel_err": max(
            st["max_rel_err"] for r in gather_recs
            for st in r["start_states"]),
    }]
    log(f"whole script: {time.perf_counter() - t_start:.1f} s, the kernels' "
        "build included")
    if smi:
        log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
