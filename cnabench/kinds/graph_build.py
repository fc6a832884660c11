"""The kind ``graph_build``: each job is ``pp.pca`` then ``pp.neighbors`` on
a new ``CellData`` around the host arrays of the next dataset of a pool
made in set-up.

Traffic keys: ``datasets`` (the pool), ``picks`` / ``pick_from`` (the
judged builds), ``trace_from`` / ``trace_jobs`` (the traced builds).
"""

from __future__ import annotations

import gc
import time

from .. import judge
from ..reference import Precision
from . import (BaseKind, build_graph, control_graph, dataset, graph_outputs,
               judged_rows, new_celldata)


class Kind(BaseKind):
    name = "graph_build"

    def prepare(self):
        """The inputs, made from the seed: a pool of datasets."""
        self.pool = [dataset(self.config, w)
                     for w in self.words[1:1 + self.traffic["datasets"]]]

    def setup(self, ct):
        t = time.perf_counter()
        self.prepare()
        t = self.stage("inputs", t)
        # warm-up: one build of the pool's last dataset
        self.ct = ct
        self.run(len(self.pool) - 1)
        self.stage("warm_job", t)

    def run(self, i):
        x, obs, _ = self.pool[i % len(self.pool)]
        d = new_celldata(self.ct, x, obs)
        build_graph(self.ct, d, self.config)
        return (i % len(self.pool), d)

    def collect(self):
        out = {i: dict(graph_outputs(d), dataset=j)
               for i, (j, d) in sorted(self.answers().items())}
        self.kept, self.last, self.ct = {}, None, None
        return dict(builds=out)

    def control(self, prec: Precision, device):
        out = {}
        for i in range(self.traffic["picks"] + 1):
            j = i % len(self.pool)
            out[i] = dict(control_graph(self.pool[j][0], self.config, prec,
                                        device), dataset=j)
        return dict(builds=out)

    def judge(self, out, device):
        cfg = self.config
        nums = {}
        for i, b in out["builds"].items():
            x = self.pool[b["dataset"]][0]
            rows = judged_rows(cfg, x.shape[0], self.words[3] + i)
            bn, _, _ = judge.judge_graph(x, cfg["n_comps"],
                                         cfg["n_neighbors"], b, rows, device)
            for key, val in bn.items():
                worse = min if key.endswith("recall") else max
                nums[key] = worse(nums.get(key, val), val)
            gc.collect()
        methods = sorted({b.get("method") for b in out["builds"].values()})
        return nums, dict(builds=sorted(out["builds"]), knn_method=methods)
