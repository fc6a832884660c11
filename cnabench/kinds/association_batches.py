"""The kind ``association_batches``: the association of ``association``
with the batches and covariates of the cohort (``data/tb.py``).  The graph
is built in set-up; each job is ``tl.association(d, y, "id",
batches=, covs=, Nnull=, null_y=, return_full=True)`` with the next
phenotype of the pool (the planted case/control label first, then random
labels and random scores) and its nulls: the standardized phenotype
permuted within batches (the conditional permutation), made here so that
both sides judge the same nulls.  The program runs the batch-kurtosis QC,
the ridge sweep over the batch dummies and covariates, and the F-test with
the last ridge's projector.

The kind reports as ``association`` (``name``), so that the readers of
the association metrics read its runs.  Judged: job 0 (the planted
label), one job drawn from the seed among jobs 1 to ``pick_from - 1``,
and the window's last.  Beside the numbers of ``association`` the judge
gives ``qc_flip`` (the share of neighbourhoods whose keep differs from the
reference's QC) and ``ridge_steps_diff`` (the program's ridge steps, read
as the ridge whose float64 projector is nearest its ``M``, against the
reference's); where either is not 0 the reference goes on with the
program's kept set and ridge steps, so that the later numbers stay
comparable.

Traffic keys: as ``association``'s.
"""

from __future__ import annotations

import numpy as np
import pandas as pd
import torch

from .. import judge
from ..data import tb
from ..reference import Precision
from ..reference import assoc as ref_assoc
from ..reference import assoc_batches as ref_b
from ..reference import graph as ref_graph
from . import control_graph, judged_rows
from .association import Kind as AssociationKind

COVARIATES = ["age", "male", "winter", "ancestry"]


class Kind(AssociationKind):
    name = "association"

    def __init__(self, config, traffic, seed, device):
        super().__init__(config, traffic, seed, device)
        rng = np.random.default_rng(self.words[0])
        self.picks = {0, 1 + int(rng.integers(traffic["pick_from"] - 1))}

    def prepare(self):
        self.x, self.obs, self.samplem = tb.tb_atlas(self.config,
                                                     self.words[1])
        self.batches = self.samplem["batch"]
        self.covs = self.samplem[COVARIATES].astype(np.float64)
        self.pool = self._phenotypes()

    def _phenotypes(self):
        """(y Series, nulls (S, Nnull) float32) pairs; each null is the
        standardized phenotype permuted within batches."""
        s = self.config["n_samples"]
        nnull = self.config["nnull"]
        rng = np.random.default_rng(self.words[2])
        batch = self.batches.to_numpy()
        grouped = np.argsort(batch, kind="stable")
        pool = []
        for j in range(self.traffic["phenotypes"]):
            if j == 0:
                y = self.samplem["case"].to_numpy(np.float64)
            elif j % 2:
                y = rng.permutation(np.arange(s) % 2).astype(np.float64)
            else:
                y = rng.standard_normal(s)
            y = y.astype(np.float32).astype(np.float64)
            ystd = (y - y.mean()) / y.std()
            # each row: the samples grouped by batch, in a random order
            # within each batch; sample grouped[i] takes that row's i-th
            order = np.lexsort((rng.random((nnull, s)),
                                np.broadcast_to(batch, (nnull, s))), axis=1)
            perm = np.empty_like(order)
            perm[:, grouped] = order
            nulls = np.ascontiguousarray(ystd[perm].T).astype(np.float32)
            pool.append((pd.Series(y, index=self.samplem.index), nulls))
        return pool

    def _job(self, ct, j):
        y, nulls = self.pool[j]
        return ct.tl.association(self.d, y, "id", batches=self.batches,
                                 covs=self.covs, Nnull=self.config["nnull"],
                                 null_y=nulls, return_full=True)

    def collect(self):
        """``association``'s outputs, and of each job the kept
        neighbourhoods and the projector ``M`` it tested with."""
        extra = {i: dict(kept=np.asarray(res.kept, bool),
                         M=res.M.to_numpy(np.float64))
                 for i, (_, res) in self.answers().items()}
        out = super().collect()
        for i, job in out["jobs"].items():
            job.update(extra[i])
        return out

    def _sample_inputs(self, device):
        codes = torch.as_tensor(self.batches.to_numpy(), device=device).long()
        return codes, int(self.config["n_batches"])

    def control(self, prec: Precision, device):
        """The reference in ``prec`` in the program's place: the outputs
        ``collect`` gives, for jobs 0 and 1."""
        cfg = self.config
        out = dict(graph=control_graph(self.x, cfg, prec, device), jobs={})
        n = self.x.shape[0]
        keys, vals = ref_graph.edge_keys(
            *(torch.as_tensor(a, device=device) for a in out["graph"]["conn"]),
            n)
        nam, _ = ref_assoc.diffuse(keys, vals, n, self.obs["id"].to_numpy(),
                                   cfg["n_samples"], prec)
        bcodes, nb = self._sample_inputs(device)
        kept = ref_b.qc_keep(nam, bcodes, nb, prec)
        res = ref_b.residualize(nam[:, kept], bcodes, nb, self.covs, prec)
        npcs = min(cfg["n_samples"], max(10, int(0.15 * cfg["n_samples"])))
        kept_h = kept.cpu().numpy()
        for i in range(2):
            y, nulls = self.pool[i]
            r = ref_b.association(res, y.to_numpy(), nulls, prec)
            job = dict(y=y.to_numpy(), nulls=nulls,
                       nam=nam[:, kept].float().cpu().numpy(), kept=kept_h,
                       M=res["M"].double().cpu().numpy(),
                       svs=res["svs"][:npcs], k=r["k"], p=r["p"],
                       nullminps=r["nullminps"], ncorrs=r["ncorrs"],
                       thresholds=r["thresholds"], fdr=r["fdr"])
            if i == 1:
                coef = np.full(n, np.nan)
                coef[kept_h] = r["ncorrs"]
                job["coef"] = coef
                job["coef_fdr"] = ref_assoc.cell_fdrs(coef, r["thresholds"],
                                                      r["fdr"])
            out["jobs"][i] = job
        return out

    def judge(self, out, device):
        """(numbers, info) of the subject outputs ``out``: the graph, the
        QC and the ridge steps, then each kept job; a number's value is
        its worst over the jobs."""
        cfg = self.config
        n = self.x.shape[0]
        rows = judged_rows(cfg, n, self.words[3])
        gnums, _, gkeys = judge.judge_graph(self.x, cfg["n_comps"],
                                            cfg["n_neighbors"],
                                            out["graph"], rows, device)
        jobs = out["jobs"]
        first = next(iter(jobs.values()))
        kept = torch.as_tensor(first["kept"], device=device)
        subjects = [judge._t(job["nam"], device, torch.float64)
                    for job in jobs.values()]
        gaps = [[] for _ in subjects]

        def watch(step, norm):
            part = norm.T[:, kept]
            scale = float(part.abs().max())
            for i, m in enumerate(subjects):
                gaps[i].append(float((part - m).abs().max()) / scale)

        keys, vals = gkeys
        nam, steps = ref_assoc.diffuse(keys, vals, n,
                                       self.obs["id"].to_numpy(),
                                       cfg["n_samples"], judge.F64,
                                       watch=watch)
        del subjects
        bcodes, nb = self._sample_inputs(device)
        ref_keep = ref_b.qc_keep(nam, bcodes, nb, judge.F64)
        nonconst = nam.std(dim=0) > 0
        nums = dict(gnums)
        nums["qc_flip"] = float(((ref_keep & nonconst) != kept)
                                .double().mean())
        nam = nam[:, kept]
        ridge_gaps = ref_b.ridge_gaps(first["M"], bcodes, nb, self.covs)
        steps_subject = int(np.argmin(ridge_gaps)) + 1
        res = ref_b.residualize(nam, bcodes, nb, self.covs, judge.F64)
        nums["ridge_steps_diff"] = abs(steps_subject - res["steps"])
        if res["steps"] != steps_subject:
            res = ref_b.residualize(nam, bcodes, nb, self.covs, judge.F64,
                                    steps=steps_subject)
        del nam
        for gap, job in zip(gaps, jobs.values()):
            for key, val in judge_job(res, job, gap, steps,
                                      first["kept"]).items():
                nums[key] = max(nums.get(key, val), val)
        return nums, dict(nsteps=steps, jobs=sorted(jobs),
                          ridge_steps=res["steps"],
                          ridge_trail=res["trail"],
                          m_err=min(ridge_gaps),
                          dropped=int((~first["kept"]).sum()),
                          knn_method=out["graph"].get("method"))


def judge_job(res, job, nam_gaps, ref_steps, kept):
    """Numbers of one job against the reference state ``res``
    (``reference.assoc_batches.residualize``), defined as
    ``judge.judge_job``'s."""
    r = ref_b.association(res, job["y"], job["nulls"], judge.F64,
                          thresholds=job["thresholds"])
    nums = {}
    nums["nsteps_diff"] = abs(int(np.argmin(nam_gaps)) + 1 - ref_steps)
    nums["nam_err"] = nam_gaps[ref_steps - 1]
    npcs = len(job["svs"])
    nums["svs_err"] = float(np.max(np.abs(np.asarray(job["svs"])
                                          - res["svs"][:npcs]))
                            / res["svs"][0])
    ks = list(r["ks"])
    lmin = np.log(max(r["p_obs"], judge.TINY_P))
    k_ok = job["k"] == r["k"] or (
        job["k"] in ks and abs(np.log(max(r["ps_obs"][ks.index(job["k"])],
                                          judge.TINY_P)) - lmin)
        <= judge.K_TIE * max(1.0, abs(lmin)))
    nums["k_diff"] = 0 if k_ok else 1
    lp = np.log(np.maximum(np.asarray(job["nullminps"], np.float64),
                           judge.TINY_P))
    lr = np.log(np.maximum(r["nullminps"], judge.TINY_P))
    nums["logp_err"] = float(np.max(np.abs(lp - lr)
                                    / np.maximum(1.0, np.abs(lr))))
    nums["pglobal_gap"] = abs(job["p"] - r["p"]) * (len(r["nullminps"]) + 1)
    nums["ncorr_err"] = float(np.max(np.abs(np.asarray(job["ncorrs"])
                                            - r["ncorrs"]))
                              / np.max(np.abs(r["ncorrs"])))
    w = r["ranks"].astype(np.float64)
    denom = max(float((w * r["fdr"]).sum()), 1.0 / 1000)
    nums["fdr_err"] = float((w * np.abs(np.asarray(job["fdr"]) - r["fdr"]))
                            .sum() / denom)
    if "coef" in job:
        coef = np.asarray(job["coef"], np.float64)
        want = np.full(coef.shape[0], np.nan)
        want[kept] = job["ncorrs"]
        want_fdr = ref_assoc.cell_fdrs(want, job["thresholds"], job["fdr"])
        same_nan = np.isnan(coef) == np.isnan(want)
        gap = np.where(np.isnan(want), 0.0, np.abs(coef - want))
        nums["writeback_err"] = float(max(
            np.nanmax(gap) if same_nan.all() else np.inf,
            np.max(np.abs(np.asarray(job["coef_fdr"]) - want_fdr))))
    return nums
