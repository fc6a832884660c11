"""The general generator: one module a kind of job (``kinds/<kind>.py``,
defining ``Kind``), found by the name a traffic mix gives as its ``job``.

A traffic mix (``traffic/<mix>.json``) is data: ``job`` names the kind,
the other keys are its parameters.  A kind makes its inputs from the run's
seed in set-up, warms up every shape the window will use, runs one job per
call of ``run``, keeps a seeded sample of its answers, and after the window
hands them, pulled to the host, to the judge.  A kind defines ``setup(ct)``,
``run(i)``, ``collect()``, ``prepare()`` (the inputs alone),
``control(prec, device)`` (the reference in ``prec`` standing in for the
program) and ``judge(out, device)``; ``BaseKind`` below keeps the answers
and ``control_graph`` / ``graph_outputs`` serve every kind that builds or
reads a graph.
"""

from __future__ import annotations

import importlib
import time
from pathlib import Path

import numpy as np
import torch

from ..data import synth
from ..reference import Precision
from ..reference import graph as ref_graph

HERE = Path(__file__).resolve().parent


def load(name: str):
    """The ``Kind`` class of ``kinds/<name>.py``."""
    if not (HERE / f"{name}.py").exists():
        raise FileNotFoundError(f"no job kind {name!r} ({HERE / name}.py)")
    return importlib.import_module(f"{__name__}.{name}").Kind


def seed_words(seed: int, n: int) -> list:
    """``n`` 32-bit seeds drawn from any non-negative integer seed."""
    return [int(v) for v in
            np.random.SeedSequence(int(seed)).generate_state(n)]


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def dataset(config, seed32):
    return synth.archetypes(config["n_samples"], config["cells_per_sample"],
                            n_genes=config["n_genes"],
                            n_batches=config["n_batches"], seed=seed32)


def new_celldata(ct, x, obs):
    return ct.CellData(X=x, obs=obs.copy(deep=False))


def build_graph(ct, d, config):
    ct.pp.pca(d, n_comps=config["n_comps"])
    ct.pp.neighbors(d, n_neighbors=config["n_neighbors"],
                    method=config["knn_method"])


def _edges(m):
    """Host (rows, cols, values) of a graph face (a lazy device face's
    ``edges()`` where it has one, else its CSR)."""
    if hasattr(m, "edges"):
        return tuple(t.cpu().numpy() for t in m.edges())
    csr = m.tocsr() if hasattr(m, "tocsr") else m
    coo = csr.tocoo()
    return coo.row, coo.col, coo.data


def graph_outputs(d):
    """What a graph build produced, on the host."""
    return dict(scores=np.asarray(d.obsm["X_pca"]),
                knn=_edges(d.obsp["distances"]),
                conn=_edges(d.obsp["connectivities"]),
                method=d.uns["neighbors"]["params"]["knn_method_resolved"])


def judged_rows(config, n, seed32):
    """The rows whose kNN lists are judged against an exact search: every
    row where the configuration's ``knn_judged_rows`` is ``"all"`` (an
    exact search, whose every list must be exact), else that many rows
    drawn from the seed (an approximate search, judged by its recall)."""
    count = config["knn_judged_rows"]
    if count == "all" or count >= n:
        return np.arange(n)
    rng = np.random.default_rng(seed32)
    return np.sort(rng.choice(n, size=count, replace=False))


class BaseKind:
    """Shared bookkeeping: which job answers are kept for the judge (a
    seeded pick among the first ``pick_from`` jobs, and the last)."""

    def __init__(self, config, traffic, seed, device):
        self.config, self.traffic, self.device = config, traffic, device
        self.words = seed_words(seed, 8)
        rng = np.random.default_rng(self.words[0])
        self.picks = set(rng.choice(traffic["pick_from"],
                                    size=traffic["picks"], replace=False)
                         .tolist())
        self.kept = {}
        self.last = None
        self.setup_seconds = {}

    def stage(self, name, t0):
        """Record a set-up stage's seconds (synchronized) since ``t0``."""
        sync(self.device)
        now = time.perf_counter()
        self.setup_seconds[name] = round(now - t0, 3)
        return now

    def keep(self, i, answer):
        if i in self.picks:
            self.kept[i] = answer
        self.last = (i, answer)

    def answers(self):
        """The kept answers, the last job's included, by job index."""
        out = dict(self.kept)
        if self.last is not None:
            out[self.last[0]] = self.last[1]
        return out


def control_graph(x, cfg, prec: Precision, device):
    """The reference graph build in ``prec``, in the program's place:
    its PCA, an exact kNN search of every row, the fuzzy union."""
    scores = ref_graph.pca(x, cfg["n_comps"], prec, device)
    k = cfg["n_neighbors"]
    ids, dists = ref_graph.knn(scores, k, prec)
    n = x.shape[0]
    # the self entry first (a tie at distance 0 may rank it later)
    rows = torch.arange(n, device=device)[:, None]
    not_self = ids != rows
    rank = torch.argsort(not_self.to(torch.int8), dim=1, stable=True)
    ids, dists = ids.gather(1, rank), dists.gather(1, rank)
    ids[:, 0] = rows[:, 0]
    dists[:, 0] = 0.0
    keys, vals = ref_graph.fuzzy_graph(ids, dists, n)
    r = rows.expand_as(ids)[:, 1:].reshape(-1)
    return dict(scores=scores.float().cpu().numpy(),
                knn=(r.cpu().numpy(), ids[:, 1:].reshape(-1).cpu().numpy(),
                     dists[:, 1:].reshape(-1).float().cpu().numpy()),
                conn=((keys // n).cpu().numpy(), (keys % n).cpu().numpy(),
                      vals.float().cpu().numpy()),
                method="control")
