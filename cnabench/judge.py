"""The numbers that decide ``correct``: what a subject (the program, or
the control standing in its place) produced, held against the float64
reference worked out again from the benchmark's own inputs.

A subject's graph outputs are host arrays: ``scores`` (N, D) PCA scores,
``knn`` the directed kNN edges without the self edge (rows, cols,
distances), ``conn`` the symmetric connectivities (rows, cols, values).
Its association outputs per job: ``nam`` (samples, cells), ``svs``, ``k``,
``p``, ``nullminps``, ``ncorrs``, ``thresholds`` and ``fdr`` (the FDR
curve), and for the last job the written-back ``coef`` / ``coef_fdr``.

The reference follows the subject's kNN lists (an IVF search is
approximate by design, so no exact search could reproduce its graph): the
distances, the fuzzy graph, the NAM and the tests are its own.  The lists
themselves are judged against an exact search: every row where the
configuration's search is exact, a sample of rows drawn from the seed
where it is approximate (``kinds.judged_rows``).
"""

from __future__ import annotations

import numpy as np
import torch

from .reference import Precision
from .reference import assoc as ref_assoc
from .reference import graph as ref_graph

F64 = Precision("float64")
TINY_P = 1e-37  # below the smallest normal float32: p-values floor here
K_TIE = 1e-2


def _t(a, device, dtype=None):
    t = torch.as_tensor(np.asarray(a), device=device)
    return t if dtype is None else t.to(dtype)


def pca_err(ref_scores, scores):
    """Largest gap of a score, each component's sign aligned to the
    reference's, over the largest reference score."""
    s = scores.to(ref_scores.dtype)
    sign = torch.sign((s * ref_scores).sum(dim=0))
    sign = torch.where(sign == 0, torch.ones_like(sign), sign)
    return float((s * sign - ref_scores).abs().max()
                 / ref_scores.abs().max())


def knn_numbers(ref_scores, lists, dists, sample_rows, k):
    """On the sampled rows: ``knn_dist_err``, the largest gap of a listed
    distance to the reference's distance of the same pair over the row's
    true k-th distance; ``knn_gap``, the largest excess of the listed
    neighbours' summed true distances over the least possible sum, as a
    share of it; ``knn_recall``, the share of listed neighbours that are
    among the true k (ties counted as found)."""
    q = sample_rows
    true_ids, true_d = ref_graph.knn(ref_scores, k, F64, rows=q)
    sub = lists[q]
    rows = q[:, None].expand_as(sub)
    d_ref = ref_graph.pair_distances(ref_scores, rows.reshape(-1),
                                     sub.reshape(-1)).reshape(sub.shape)
    kth = torch.clamp(true_d[:, -1:], min=1e-30)
    dist_err = float(((dists[q].to(d_ref.dtype) - d_ref).abs()
                      / kth)[:, 1:].max())
    gap = float(((d_ref.sum(dim=1) - true_d.sum(dim=1))
                 / torch.clamp(true_d.sum(dim=1), min=1e-30)).max())
    found = (sub[:, :, None] == true_ids[:, None, :]).any(dim=2)
    found = found | (d_ref <= kth * (1 + 1e-9))
    recall = float(found[:, 1:].double().mean())
    return dict(knn_dist_err=dist_err, knn_gap=max(gap, 0.0),
                knn_recall=recall)


def keyed_err(keys_a, vals_a, keys_b, vals_b):
    """Largest gap between two keyed value sets (a key that one lacks
    counts as 0 there)."""
    keys = torch.cat([keys_a, keys_b])
    vals = torch.cat([vals_a.double(), -vals_b.double()])
    keys, order = torch.sort(keys)
    _, inv = torch.unique_consecutive(keys, return_inverse=True)
    diff = torch.zeros(int(inv.max()) + 1 if inv.numel() else 0,
                       dtype=torch.float64, device=keys.device)
    diff.index_add_(0, inv, vals[order])
    return float(diff.abs().max()) if diff.numel() else 0.0


def judge_graph(x, n_comps, k, out, sample_rows, device):
    """Numbers of one graph build, and the reference graph that follows
    the subject's kNN lists: (numbers, ref_scores, (keys, values))."""
    n = x.shape[0]
    ref_scores = ref_graph.pca(x, n_comps, F64, device)
    nums = dict(pca_err=pca_err(ref_scores, _t(out["scores"], device)))
    rows, cols, d = (_t(a, device) for a in out["knn"])
    rows, cols = rows.long(), cols.long()
    order = torch.argsort(rows * n + cols)
    lists = ref_graph.lists_from_edges(rows, cols, n, k)
    dists = torch.zeros((n, k), dtype=d.dtype, device=device)
    dists[:, 1:] = d[order].reshape(n, k - 1)
    nums.update(knn_numbers(ref_scores, lists, dists,
                            _t(sample_rows, device).long(), k))
    all_rows = torch.arange(n, device=device)[:, None].expand_as(lists)
    ref_d = ref_graph.pair_distances(
        ref_scores, all_rows.reshape(-1), lists.reshape(-1)).reshape(n, k)
    ref_keys, ref_vals = ref_graph.fuzzy_graph(lists, ref_d, n)
    crow, ccol, cval = (_t(a, device) for a in out["conn"])
    keys, vals = ref_graph.edge_keys(crow, ccol, cval, n)
    nums["conn_err"] = keyed_err(keys, vals, ref_keys, ref_vals)
    return nums, ref_scores, (ref_keys, ref_vals)


def reference_nam(graph_keys, n, codes, n_samples, port_nams, device):
    """The reference NAM of the graph, the steps it took, and for each
    subject NAM the gap (over the largest reference entry) after every
    step: (nam (S, C), steps, [[gap per step] per subject NAM])."""
    keys, vals = graph_keys
    subjects = [_t(m, device, torch.float64).T for m in port_nams]
    gaps = [[] for _ in subjects]

    def watch(step, norm):
        scale = float(norm.abs().max())
        for i, m in enumerate(subjects):
            gaps[i].append(float((norm - m).abs().max()) / scale)

    nam, steps = ref_assoc.diffuse(keys, vals, n, codes, n_samples, F64,
                                   watch=watch)
    return nam, steps, gaps


def judge_job(ref, job, nam_gaps, ref_steps):
    """Numbers of one association job against the reference state ``ref``
    (namresid, u, svs)."""
    namresid, u, svs = ref["namresid"], ref["u"], ref["svs"]
    res = ref_assoc.association(namresid, u, job["y"], job["nulls"], F64,
                                thresholds=job["thresholds"])
    nums = {}
    steps_subject = int(np.argmin(nam_gaps)) + 1
    nums["nsteps_diff"] = abs(steps_subject - ref_steps)
    nums["nam_err"] = nam_gaps[ref_steps - 1]
    npcs = len(job["svs"])
    nums["svs_err"] = float(np.max(np.abs(np.asarray(job["svs"])
                                          - svs[:npcs])) / svs[0])
    # the chosen k; a k whose reference p ties the least is as good a
    # choice (a tie: within K_TIE of it, relative in log p, the scale at
    # which the float32 program's p-values are read)
    ks = list(res["ks"])
    lmin = np.log(max(res["p_obs"], TINY_P))
    k_ok = job["k"] == res["k"] or (
        job["k"] in ks and abs(np.log(max(res["ps_obs"][ks.index(job["k"])],
                                          TINY_P)) - lmin)
        <= K_TIE * max(1.0, abs(lmin)))
    nums["k_diff"] = 0 if k_ok else 1
    lp = np.log(np.maximum(np.asarray(job["nullminps"], np.float64), TINY_P))
    lr = np.log(np.maximum(res["nullminps"], TINY_P))
    nums["logp_err"] = float(np.max(np.abs(lp - lr)
                                    / np.maximum(1.0, np.abs(lr))))
    # the global p is a count of nulls at or below the observed p: a
    # count, not a rounding-continuous number, reported and not compared
    nums["pglobal_gap"] = abs(job["p"] - res["p"]) * (
        len(res["nullminps"]) + 1)
    ref_nc = res["ncorrs"]
    nums["ncorr_err"] = float(np.max(np.abs(np.asarray(job["ncorrs"])
                                            - ref_nc))
                              / np.max(np.abs(ref_nc)))
    w = res["ranks"].astype(np.float64)
    denom = max(float((w * res["fdr"]).sum()), 1.0 / 1000)
    nums["fdr_err"] = float((w * np.abs(np.asarray(job["fdr"])
                                        - res["fdr"])).sum() / denom)
    if "coef" in job:
        coef = np.asarray(job["coef"], np.float64)
        want = ref_assoc.cell_fdrs(coef, job["thresholds"], job["fdr"])
        nums["writeback_err"] = float(max(
            np.max(np.abs(coef - np.asarray(job["ncorrs"]))),
            np.max(np.abs(np.asarray(job["coef_fdr"]) - want))))
    return nums
