#!/usr/bin/env python3
"""Smoke run of cna_tpu_torch on one NVIDIA card (H100).

    python3 chip_smoke.py

Phases, each of which must pass (any failure exits non-zero):

1. card: name and power limit (``nvidia-smi``);
2. build: every CUDA kernel of the package, compiled by ``nvcc`` from
   ``cna_tpu_torch/csrc`` into ``cna_tpu_torch/_build`` (one ``nvcc`` per
   source, started together);
3. kernels: each kernel against its plain PyTorch version on the card, at
   its main path's shape and at extra shapes; timed with CUDA events
   beside its bound and a PyTorch library yardstick;
4. the 100,000-cell path: synthetic data (50 samples x 2,000 cells x 50
   genes) -> ``pp.pca`` -> ``pp.neighbors`` (the exact kNN kernel, the
   device-resident graph) -> ``tl.association`` with 1,000 permutations;
5. the 1,000,000-cell path: 50 samples x 20,000 cells x 50 genes ->
   ``pp.pca`` (chunked) -> ``pp.neighbors`` (auto -> the IVF index and its
   scoring kernel -> the device-resident graph) -> ``tl.association`` with
   1,000 permutations; then the scoring kernel against its plain version
   on that index's own layout and calibrated probe count;
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
9. 'block' and 'hybrid' at 100,000 cells (manifold), each held to 'ell'.

Each path of phases 4, 5 and 8 runs with the kernel launch counts set to
0 just before it and read just after.

The last two lines of standard output are a JSON object describing each
kernel and the ``{"ok": true, "device": ...}`` line.  Without a CUDA
device, or without the package beside this file, it exits non-zero and
prints no result.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# published H100 SXM peaks (data sheet, 700 W): float32 outside the
# tensor cores, and HBM3 bandwidth
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12

KNN_CASES = [(100_000, 20, 15), (1_037, 7, 5), (20_011, 50, 64)]
DIST_ATOL = 1e-3  # float32 squared distances summed in different orders
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


def check_knn_case(n, d, k, seed, timed):
    """Kernel vs plain version at one shape; returns a record."""
    import torch

    from cna_tpu_torch.ops import knn

    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    x = torch.randn(n, d, generator=gen, device="cuda")
    negd, idx = knn.knn_exact(x, k)
    torch.cuda.synchronize()
    p_negd, p_idx = knn.knn_exact_plain(x, k)
    torch.cuda.synchronize()
    dk, dp = -negd, -p_negd

    rows = torch.arange(n, device="cuda", dtype=torch.int32)
    if not bool((idx[:, 0] == rows).all()):
        raise AssertionError(f"knn_exact {n}x{d} k={k}: a row does not "
                             "start with itself")
    if not bool((torch.diff(dk, dim=1) >= 0).all()):
        raise AssertionError(f"knn_exact {n}x{d} k={k}: distances not "
                             "ascending")
    err = float((dk - dp).abs().max())
    if err > DIST_ATOL:
        raise AssertionError(f"knn_exact {n}x{d} k={k}: sorted distances "
                             f"differ from the plain version by {err}")
    # the ids must carry the distances reported for them
    recomputed = ((x[idx.long()] - x[:, None, :]) ** 2).sum(-1)
    id_err = float((recomputed - dk).abs().max())
    if id_err > DIST_ATOL:
        raise AssertionError(f"knn_exact {n}x{d} k={k}: ids disagree with "
                             f"their distances by {id_err}")
    # recall with ties allowed: an id the plain version lacks counts as a
    # miss only if it is strictly closer than the plain k-th distance
    same = (idx.long()[:, :, None] == p_idx.long()[:, None, :]).any(-1)
    tie = dk >= dp[:, -1:] - DIST_ATOL
    recall = float((same | tie).float().mean())
    exact_id_share = float(same.float().mean())
    if recall != 1.0:
        raise AssertionError(f"knn_exact {n}x{d} k={k}: recall {recall}")

    rec = dict(n=n, d=d, k=k, max_abs_err=err, recall=recall,
               same_id_share=exact_id_share)
    if timed:
        rec["ms"] = cuda_ms(lambda: knn.knn_exact(x, k), 5)
        rec["plain_ms"] = cuda_ms(lambda: knn.knn_exact_plain(x, k), 2)
        rec["library_ms"] = cuda_ms(lambda: library_knn(x, k), 2)
        flops = 2.0 * n * n * d
        nbytes = 4.0 * n * d + 8.0 * n * k
        t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES_PER_S
        rec["bound_ms"] = 1e3 * max(t_ops, t_bytes)
        rec["bound_by"] = "operations" if t_ops >= t_bytes else "bytes"
    return rec


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
    negd, idx = ivf.score_blocks(*args, g=g, q_blocks=q_blocks)
    torch.cuda.synchronize()
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
               max_rel_err=err, recall=recall,
               same_id_share=float((same | ~found).float().mean()))
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
    its live rows and live candidates need (2 * rows * candidates * d flop
    in float32) against its bytes (every input read once, every output
    written once)."""
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
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES_PER_S
    return dict(flops=flops, bytes=nbytes, bound_ms=1e3 * max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes",
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
    rec["all_slots"] = dict(
        slots=int(sel_all.shape[0]), f_real=index.f_real,
        ms=cuda_ms(lambda: ivf.score_blocks(*args, g=index.g,
                                            q_blocks=index.q_blocks), 3),
        **ivf_bound(index.x4, sel_all, table, index.blk_counts_dev, k,
                    index.g, index.q_blocks))
    return rec


def main_path(ct):
    """The 100,000-cell path at full size; returns (launch counts,
    record, the association result)."""
    d, y = dataset(ct, cells_per_sample=2000)
    counts, rec, res = drive_path(ct, d, y, method="auto")
    if rec["knn_method_resolved"] != "pallas":
        raise AssertionError("pp.neighbors resolved kNN to "
                             f"{rec['knn_method_resolved']!r}, not the "
                             "exact kernel")
    if counts.get("knn_exact", 0) < 1:
        raise AssertionError(f"the main path launched no knn_exact: {counts}")
    conn = d.obsp["connectivities"].tocsr()
    if conn.shape != (d.n_obs, d.n_obs) or abs(conn - conn.T).max() != 0:
        raise AssertionError("connectivities are not a symmetric N x N CSR")
    return counts, rec, res


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
               graph_s=t1 - t0, association_first_s=t2 - t1,
               association_second_s=t3 - t2, phases_first=phases[:n_first],
               phases_second_association=phases[n_first:],
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    return counts, rec, res


def atlas_path(ct):
    """The 1,000,000-cell path at full size, nothing cut; returns (launch
    counts, record, the PCA scores on the card, the calibrated u)."""
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


def card_vs_cpu(ct, card="cuda"):
    """The chain at 5,000 cells on the card in float32 against the CPU in
    float64, stage by stage (each CPU stage takes the card's input to
    that stage, so that float32 rounding upstream cannot move it), and
    end to end.  ``card`` is the device of the float32 run."""
    import importlib

    import scipy.sparse as sp

    nb = importlib.import_module("cna_tpu_torch.pp.neighbors")
    from cna_tpu_torch.tools._nam import nam_arrays

    def run(dev, x64, scores=None, conn=None):
        ct.config.set_device(dev)
        ct.config.enable_x64(x64)
        d, samplem = ct.data.synthetic_dataset(
            n_samples=50, cells_per_sample=100, n_genes=50, seed=1,
            dtype=np.float64 if x64 else np.float32)
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
        n_samples=50, cells_per_sample=100, n_genes=50, seed=1)
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

    y = sb.banded_inband(graph, x)
    torch.cuda.synchronize()
    ref = sb.banded_spmm_plain(graph.lidx, graph.weights, graph.slab_starts,
                               x, graph.row_tile, graph.slab_rows)
    torch.cuda.synchronize()
    if y.shape != (graph.lidx.shape[0], x.shape[1]) or y.dtype != x.dtype:
        raise AssertionError(f"banded_spmm {label}: output {tuple(y.shape)} "
                             f"{y.dtype}")
    if not bool(torch.isfinite(y).all()):
        raise AssertionError(f"banded_spmm {label}: non-finite output")
    dtype = str(x.dtype).replace("torch.", "")
    err = float((y - ref).abs().max())
    scale = float(ref.abs().max())
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
    """The least time the card could take for the in-band product: its
    bytes, each of lidx, w, slab_starts and x read once and y written
    once, at the card's memory rate (2 flop per slot and column are far
    below the float32 rate).  Also the figure with every tile reading its
    whole slab of x."""
    n_pad, k = graph.lidx.shape
    item = graph.weights.element_size()
    slots = float(n_pad) * k
    nbytes = (slots * (4 + item) + 4.0 * graph.slab_starts.numel()
              + item * float(s) * (n + n_pad))
    flops = 2.0 * slots * s
    x_bytes = item * float(s) * n
    slab_bytes = nbytes + x_bytes * (graph.slab_rows / graph.row_tile - 1)
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES_PER_S
    return dict(flops=flops, bytes=nbytes,
                bound_ms=1e3 * max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes",
                whole_slab_bytes_ms=1e3 * slab_bytes / PEAK_BYTES_PER_S)


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
    Returns (launch counts of the path, record, kernel record)."""
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
    krec["ms"] = cuda_ms(lambda: sb.banded_inband(graph, x), 10)
    krec["plain_ms"] = cuda_ms(lambda: sb.banded_spmm_plain(
        graph.lidx, graph.weights, graph.slab_starts, x, graph.row_tile,
        graph.slab_rows), 3)
    krec["library_ms"] = cuda_ms(lambda: torch.sparse.mm(csr, x), 5)
    krec["in_band_edges"] = int(csr.values().shape[0])
    krec.update(banded_bound(graph, n, s))
    return counts, rec, krec


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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    try:
        import cna_tpu_torch as ct
        from cna_tpu_torch.ops import _build, ivf, knn, spmm_banded
    except ImportError as exc:
        print(f"chip_smoke: cna_tpu_torch not found beside this script "
              f"({exc})", file=sys.stderr)
        return 1

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

    cases = [check_knn_case(n, d, k, seed=i, timed=(i == 0))
             for i, (n, d, k) in enumerate(KNN_CASES)]
    for rec in cases:
        log("knn_exact vs plain:", json.dumps(rec))
    ivf_cases = ivf_odd_cases()
    for rec in ivf_cases:
        log("ivf_score vs plain:", json.dumps(rec))
    banded_cases = banded_odd_cases()
    for rec in banded_cases:
        log("banded_spmm vs plain:", json.dumps(rec))

    counts, slice_rec, exact_res = main_path(ct)
    log("100k path:", json.dumps(slice_rec))
    log("100k-path launches:", json.dumps(counts))

    atlas_counts, atlas_rec, scores_dev, u = atlas_path(ct)
    log("1M path:", json.dumps(atlas_rec))
    log("1M-path launches:", json.dumps(atlas_counts))
    ivf_main = check_ivf_main_shape(scores_dev, u, 15)
    del scores_dev
    torch.cuda.empty_cache()
    log("ivf_score vs plain:", json.dumps(ivf_main))
    ivf_cases.append(ivf_main)

    log("ivf vs exact at 100k:", json.dumps(ivf_vs_exact(ct, exact_res)))

    cmp_rec = card_vs_cpu(ct)
    log("card vs cpu:", json.dumps(cmp_rec))

    banded_counts, banded_rec, banded_main = banded_path(ct)
    log("banded 1M path:", json.dumps(banded_rec))
    log("banded-1M-path launches:", json.dumps(banded_counts))
    log("banded_spmm vs plain:", json.dumps(banded_main))
    banded_cases.append(banded_main)
    torch.cuda.empty_cache()

    log("block and hybrid at 100k:", json.dumps(block_formats(ct)))

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
        "shape": [main_case["n"], main_case["d"], main_case["k"]],
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
        "whole_slab_bytes_ms": banded_main["whole_slab_bytes_ms"],
        "shape": {key: banded_main[key] for key in
                  ("n", "n_pad", "k", "s", "row_tile", "slab_rows",
                   "in_band_edges")},
    }]
    if smi:
        log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
