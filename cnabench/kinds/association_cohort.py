"""The kind ``association_cohort``: ``association_batches``'s job on a
population cohort (``data/onek1k.py``): donors sequenced in pools, eight
donor covariates, SNP dosages as phenotypes.  The graph is built in
set-up; each job is ``tl.association(d, y, "id", batches=<pools>,
covs=<covariates>, Nnull=, null_y=, return_full=True)`` with the next
phenotype of the pool - the planted SNP's dosage first, then dosages of
SNPs whose allele frequency is drawn from the seed, uniform on 0.05 to 0.5
- and its nulls, the standardized dosage permuted within pools.

The kind reports as ``association``.  Its NAM is 10^9 entries (5 GB in
float32), and an answer holds three such matrices on the card, so the
answers are not held there as ``association`` holds them: a judged answer
goes to the host when it is kept (the job's NAM, coefficients, FDR curve,
``M``), and the previous job's answer is let go when the next job starts
(the last job's is pulled by ``collect``).  The card then holds what a
user's process holds while it runs a job.  The judged NAM is copied into
a pinned host buffer made in set-up, on a stream of its own, so the copy
runs beside the next job and the window times the program's jobs, not
the benchmark's copies of its answers.  The judge is
``association_batches``'s with the reference diffusion of
``reference/assoc_cohort.py`` and the judged NAMs kept in float32, which
a card of 80 GB holds at this size.

Traffic keys: as ``association``'s.
"""

from __future__ import annotations

import time

import numpy as np
import pandas as pd
import torch

from .. import judge
from ..data import onek1k
from ..reference import assoc_batches as ref_b
from ..reference import assoc_cohort as ref_c
from . import graph_outputs, judged_rows
from .association_batches import Kind as BatchesKind
from .association_batches import judge_job


def _ridge_gaps(m_subject, bcodes, nb, covs):
    """``reference.assoc_batches.ridge_gaps``, with an infinite gap at a
    ridge whose system is exactly singular (of two pools the standardized
    dummies are opposite, so ridge 0 has no solution there)."""
    c, nbcols = ref_b.design(bcodes, nb, covs, judge.F64)
    m = torch.as_tensor(np.asarray(m_subject), device=c.device,
                        dtype=torch.float64)
    gaps = []
    for ridge in ref_b.RIDGES:
        try:
            proj = ref_b.projector(c, ridge, nbcols, judge.F64)
        except torch.linalg.LinAlgError:
            gaps.append(float("inf"))
            continue
        gaps.append(float((proj - m).abs().max()))
    return gaps


def _device_nam(res):
    """The tensor behind the answer's lazy ``nam`` field where that field
    is the program's ``NamArrays.to_df``, else None."""
    thunk = res.__dict__.get("_lazy", {}).get("nam")
    nam = getattr(getattr(thunk, "__self__", None), "nam", None)
    return nam if isinstance(nam, torch.Tensor) else None


def _small_on_host(res):
    """What the judge reads of one answer besides its NAM, on the host."""
    return dict(svs=np.asarray(res.namresid_svs, np.float64),
                k=int(res.k), p=float(res.p),
                nullminps=np.asarray(res.nullminps),
                ncorrs=np.asarray(res.ncorrs),
                thresholds=res.fdrs.threshold.to_numpy(),
                fdr=res.fdrs.fdr.to_numpy(np.float64),
                kept=np.asarray(res.kept, bool),
                M=res.M.to_numpy(np.float64))


def _on_host(res):
    """What the judge reads of one answer, pulled to the host at once.
    The NAM comes from the program's tensor as it is; where the answer
    does not expose one, from the DataFrame of ``res.nam``, which pandas
    copies once more (about a second a GB)."""
    out = _small_on_host(res)
    nam = _device_nam(res)
    out["nam"] = (res.nam.to_numpy(np.float32) if nam is None else
                  nam.detach().to("cpu", torch.float32).numpy())
    return out


class Kind(BatchesKind):
    name = "association"

    def prepare(self):
        self.x, self.obs, self.samplem = onek1k.cohort(self.config,
                                                       self.words[1])
        self.batches = self.samplem["batch"]
        self.covs = self.samplem[onek1k.COVARIATES].astype(np.float64)
        self.pool = self._phenotypes()
        self.copier, self.pinned, self.nam_pulls = None, [], []

    def _phenotypes(self):
        """(y Series, nulls (S, Nnull) float32) pairs; each null is the
        standardized dosage permuted within pools."""
        s = self.config["n_samples"]
        nnull = self.config["nnull"]
        rng = np.random.default_rng(self.words[2])
        batch = self.batches.to_numpy()
        grouped = np.argsort(batch, kind="stable")
        pool = []
        for j in range(self.traffic["phenotypes"]):
            if j == 0:
                y = self.samplem["dosage"].to_numpy(np.float64)
            else:
                y = onek1k.dosages(rng, s, rng.uniform(0.05, 0.5))
            y = y.astype(np.float64)
            ystd = (y - y.mean()) / y.std()
            # each row: the donors grouped by pool, in a random order
            # within each pool; donor grouped[i] takes that row's i-th
            order = np.lexsort((rng.random((nnull, s)),
                                np.broadcast_to(batch, (nnull, s))), axis=1)
            perm = np.empty_like(order)
            perm[:, grouped] = order
            nulls = np.ascontiguousarray(ystd[perm].T).astype(np.float32)
            pool.append((pd.Series(y, index=self.samplem.index), nulls))
        return pool

    def _sample_inputs(self, device):
        codes = torch.as_tensor(self.batches.to_numpy(), device=device).long()
        return codes, onek1k.n_pools(self.config)

    def run(self, i):
        # one client holds its newest answer: the one before is on the
        # host where it is judged, and superseded where it is not
        self.last = None
        return super().run(i)

    def setup(self, ct):
        super().setup(ct)
        t = time.perf_counter()
        # a pinned buffer for each judged NAM, and a stream for its copy
        if torch.device(self.device).type == "cuda":
            size = self.config["n_samples"] * self.x.shape[0]
            self.copier = torch.cuda.Stream(self.device)
            self.pinned = [torch.empty(size, dtype=torch.float32,
                                       pin_memory=True)
                           for _ in self.picks]
        self.stage("pinned", t)

    def keep(self, i, answer):
        if i in self.picks:
            j, res = answer
            answer = (j, self._pull(res))
        super().keep(i, answer)

    def _pull(self, res):
        """A judged answer on the host.  On a card its NAM is copied into
        a pinned buffer on the copy stream, behind the job that made it;
        the allocator keeps the tensor's memory until the copy is done,
        and the harness's synchronize after the next job waits for it.
        On the CPU, or where the answer exposes no NAM tensor, the NAM is
        pulled at once; ``nam_pulls`` in the judge's report says which."""
        nam = _device_nam(res)
        if self.copier is None or nam is None:
            self.nam_pulls.append("tensor" if nam is not None
                                  else "dataframe")
            return _on_host(res)
        out = _small_on_host(res)
        host = self.pinned.pop()[: nam.numel()].view(nam.shape)
        self.copier.wait_stream(torch.cuda.current_stream(nam.device))
        with torch.cuda.stream(self.copier):
            host.copy_(nam, non_blocking=True)
        nam.record_stream(self.copier)
        self.nam_pulls.append("stream")
        out["nam"] = host
        return out

    def collect(self):
        """The graph, and of every kept answer (the last job's included)
        what the judge reads, on the host; then the program's state is
        let go."""
        if self.copier is not None:
            self.copier.synchronize()
        answers = self.answers()
        last = max(answers)
        jobs = {}
        for i, (j, res) in sorted(answers.items()):
            y, nulls = self.pool[j]
            job = dict(res) if isinstance(res, dict) else _on_host(res)
            job.update(y=y.to_numpy(), nulls=nulls)
            if i == last:
                job["coef"] = self.d.obs["coef"].to_numpy(np.float64)
                job["coef_fdr"] = self.d.obs["coef_fdr"].to_numpy(np.float64)
            jobs[i] = job
        out = dict(graph=graph_outputs(self.d), jobs=jobs)
        self.kept, self.last, self.d, self.ct = {}, None, None, None
        self.copier = None
        return out

    def judge(self, out, device):
        """``association_batches``'s judge, with the reference NAM of
        ``reference.assoc_cohort.diffuse`` and each subject NAM compared by
        blocks of cells in float32 on the device."""
        cfg = self.config
        n = self.x.shape[0]
        rows = judged_rows(cfg, n, self.words[3])
        gnums, _, gkeys = judge.judge_graph(self.x, cfg["n_comps"],
                                            cfg["n_neighbors"],
                                            out["graph"], rows, device)
        jobs = out["jobs"]
        first = next(iter(jobs.values()))
        kept = torch.as_tensor(first["kept"], device=device)
        # column j of a subject NAM is kept cell j: cells [lo, hi) hold
        # its columns [at[lo], at[hi])
        at = torch.zeros(n + 1, dtype=torch.int64)
        at[1:] = torch.cumsum(torch.as_tensor(first["kept"]), 0)
        subjects = [torch.as_tensor(job["nam"], device=device)
                    for job in jobs.values()]
        gaps = [[] for _ in subjects]

        def watch(step, s, counts):
            scale = torch.zeros((), dtype=s.dtype, device=s.device)
            worst = torch.zeros(len(subjects), dtype=s.dtype,
                                device=s.device)
            for lo, hi in ref_c.row_blocks(n, s.shape[1]):
                c0, c1 = int(at[lo]), int(at[hi])
                if c1 == c0:
                    continue
                part = s[lo:hi][kept[lo:hi]] / counts[None, :]
                scale = torch.maximum(scale, part.abs().max())
                for i, m in enumerate(subjects):
                    gap = (part - m[:, c0:c1].T.to(s.dtype)).abs().max()
                    worst[i] = torch.maximum(worst[i], gap)
            for i, g in enumerate((worst / scale).tolist()):
                gaps[i].append(g)

        keys, vals = gkeys
        nam, steps = ref_c.diffuse(keys, vals, n, self.obs["id"].to_numpy(),
                                   cfg["n_samples"], judge.F64, watch=watch)
        del subjects
        bcodes, nb = self._sample_inputs(device)
        ref_keep = ref_b.qc_keep(nam, bcodes, nb, judge.F64)
        nonconst = nam.std(dim=0) > 0
        nums = dict(gnums)
        nums["qc_flip"] = float(((ref_keep & nonconst) != kept)
                                .double().mean())
        nam = nam[:, kept].contiguous()
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
        ridge_gaps = _ridge_gaps(first["M"], bcodes, nb, self.covs)
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
                          nam_pulls=self.nam_pulls,
                          knn_method=out["graph"].get("method"))
