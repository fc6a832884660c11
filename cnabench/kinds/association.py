"""The kind ``association``: the graph of one dataset is built in set-up;
each job is ``tl.association(d, y, "id", Nnull=, null_y=,
return_full=True)`` with the next phenotype of a pool drawn from the seed
(the planted case/control label first, then random labels and random
scores) and its null phenotypes (permutations of the standardized
phenotype, the port's own null for one batch), made here so that both
sides judge the same nulls.  One batch and no covariates, as ``bench.py``
runs it.

Traffic keys: ``phenotypes`` (the pool), ``picks`` / ``pick_from`` (the
judged jobs), ``trace_from`` / ``trace_jobs`` (the traced jobs).
"""

from __future__ import annotations

import time

import numpy as np
import pandas as pd
import torch

from .. import judge
from ..reference import Precision
from ..reference import assoc as ref_assoc
from ..reference import graph as ref_graph
from . import (BaseKind, build_graph, control_graph, dataset, graph_outputs,
               judged_rows, new_celldata)


class Kind(BaseKind):
    name = "association"

    def prepare(self):
        """The inputs, made from the seed: the dataset and the phenotype
        pool with its nulls."""
        self.x, self.obs, self.samplem = dataset(self.config, self.words[1])
        self.pool = self._phenotypes()

    def setup(self, ct):
        t = time.perf_counter()
        self.prepare()
        t = self.stage("inputs", t)
        self.d = new_celldata(ct, self.x, self.obs)
        build_graph(ct, self.d, self.config)
        t = self.stage("graph", t)
        # warm-up: one association on the pool's last phenotype
        self._job(ct, len(self.pool) - 1)
        self.stage("warm_job", t)
        self.ct = ct

    def _phenotypes(self):
        """(y Series, nulls (S, Nnull) float32) pairs: the planted label,
        then random 0/1 labels and random scores alternately."""
        cfg, tr = self.config, self.traffic
        s = cfg["n_samples"]
        rng = np.random.default_rng(self.words[2])
        pool = []
        for j in range(tr["phenotypes"]):
            if j == 0:
                y = self.samplem["case"].to_numpy(np.float64)
            elif j % 2:
                y = rng.permutation(np.arange(s) % 2).astype(np.float64)
            else:
                y = rng.standard_normal(s)
            y = y.astype(np.float32).astype(np.float64)
            ystd = (y - y.mean()) / y.std()
            perm = np.argsort(rng.random((cfg["nnull"], s)), axis=1)
            nulls = np.ascontiguousarray(ystd[perm].T).astype(np.float32)
            pool.append((pd.Series(y, index=self.samplem.index), nulls))
        return pool

    def _job(self, ct, j):
        y, nulls = self.pool[j]
        return ct.tl.association(self.d, y, "id", Nnull=self.config["nnull"],
                                 null_y=nulls, return_full=True)

    def run(self, i):
        j = i % len(self.pool)
        return (j, self._job(self.ct, j))

    def collect(self):
        """Pull every kept answer to the host, then free the program's
        state.  Returns the subject outputs the judge takes."""
        jobs = {}
        answers = self.answers()
        last = max(answers)
        for i, (j, res) in sorted(answers.items()):
            y, nulls = self.pool[j]
            job = dict(y=y.to_numpy(), nulls=nulls,
                       nam=res.nam.to_numpy(np.float32),
                       svs=np.asarray(res.namresid_svs, np.float64),
                       k=int(res.k), p=float(res.p),
                       nullminps=np.asarray(res.nullminps),
                       ncorrs=np.asarray(res.ncorrs),
                       thresholds=res.fdrs.threshold.to_numpy(),
                       fdr=res.fdrs.fdr.to_numpy(np.float64))
            if i == last:
                job["coef"] = self.d.obs["coef"].to_numpy(np.float64)
                job["coef_fdr"] = self.d.obs["coef_fdr"].to_numpy(np.float64)
            jobs[i] = job
        out = dict(graph=graph_outputs(self.d), jobs=jobs)
        self.kept, self.last, self.d, self.ct = {}, None, None, None
        return out

    def control(self, prec: Precision, device):
        """The reference in ``prec`` standing in for the program: the same
        outputs ``collect`` gives, for the same jobs."""
        cfg = self.config
        out = dict(graph=control_graph(self.x, cfg, prec, device), jobs={})
        n = self.x.shape[0]
        keys, vals = ref_graph.edge_keys(
            *(torch.as_tensor(a, device=device) for a in out["graph"]["conn"]),
            n)
        nam, _ = ref_assoc.diffuse(keys, vals, n, self.obs["id"].to_numpy(),
                                   cfg["n_samples"], prec)
        namresid, u, svs = ref_assoc.resid_svd(nam, prec)
        npcs = min(cfg["n_samples"], max(10, int(0.15 * cfg["n_samples"])))
        for i in range(self.traffic["picks"] + 1):
            y, nulls = self.pool[i % len(self.pool)]
            res = ref_assoc.association(namresid, u, y.to_numpy(), nulls,
                                        prec)
            out["jobs"][i] = dict(
                y=y.to_numpy(), nulls=nulls,
                nam=nam.float().cpu().numpy(), svs=svs[:npcs], k=res["k"],
                p=res["p"], nullminps=res["nullminps"],
                ncorrs=res["ncorrs"], thresholds=res["thresholds"],
                fdr=res["fdr"])
        return out

    def judge(self, out, device):
        """(numbers, info) of the subject outputs ``out``: the graph the
        jobs ran on, then each kept job; a number's value is its worst
        over the jobs."""
        cfg = self.config
        n = self.x.shape[0]
        rows = judged_rows(cfg, n, self.words[3])
        gnums, _, gkeys = judge.judge_graph(self.x, cfg["n_comps"],
                                            cfg["n_neighbors"],
                                            out["graph"], rows, device)
        jobs = out["jobs"]
        nam, steps, gaps = judge.reference_nam(
            gkeys, n, self.obs["id"].to_numpy(), cfg["n_samples"],
            [job["nam"] for job in jobs.values()], device)
        namresid, u, svs = ref_assoc.resid_svd(nam, judge.F64)
        del nam
        ref = dict(namresid=namresid, u=u, svs=svs)
        nums = dict(gnums)
        for gap, job in zip(gaps, jobs.values()):
            for key, val in judge.judge_job(ref, job, gap, steps).items():
                worse = min if key.endswith("recall") else max
                nums[key] = worse(nums.get(key, val), val)
        return nums, dict(nsteps=steps, jobs=sorted(jobs),
                          knn_method=out["graph"].get("method"))
