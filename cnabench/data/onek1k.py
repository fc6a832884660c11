"""The OneK1K cohort's inputs (``configs/onek1k_1m.json``): the archetype
recipe of ``data/synth.py`` on a population cohort shaped like OneK1K
(Yazar et al., Science 376:eabf3041, 2022) - about a thousand donors of
unequal cell counts, sequenced in multiplexed pools that shift the
expression, with donor covariates and genotypes.

From the seed: each donor's cell count (``tb.cell_counts``: lognormal, at
least a floor, summing to the cohort's total), the dosage (0, 1 or 2) of
one SNP at allele frequency ``planted_maf``, sex, age, six genotype
principal components, and the pool (the donors dealt over
``n_pools(cfg)`` pools in a seeded order).  Each donor's cells mix the
recipe's three expression programs with proportions driven by the dosage
(additively, half the recipe's case effect an allele) and sex, plus
Gaussian noise, plus their pool's offset: a seeded vector in gene space of
norm ``batch_offset * sqrt(n_genes)``.

A configuration that gives ``cells_per_sample`` (the harness's CPU sizes
do) takes ``n_samples * cells_per_sample`` cells in place of ``n_cells``,
with a floor of at most half that a donor.
"""

from __future__ import annotations

import numpy as np
import pandas as pd

from .synth import _mixture_weights
from .tb import cell_counts

COVARIATES = ["age", "male"] + [f"gpc{i}" for i in range(1, 7)]


def n_pools(cfg):
    """Pools of ``donors_per_pool`` donors, rounded, and at least 2."""
    return max(2, round(cfg["n_samples"] / cfg["donors_per_pool"]))


def dosages(rng, n, maf):
    """Binomial(2, ``maf``) dosages of ``n`` donors, drawn again where they
    come out all equal (a SNP monomorphic in the cohort is not tested)."""
    while True:
        d = rng.binomial(2, maf, n)
        if d.min() < d.max():
            return d


def cohort(cfg, seed):
    """Return (x (N, G) float32, obs with the donor id column ``id``,
    samplem indexed by donor id with ``dosage``, ``batch`` (the pool) and
    ``COVARIATES``) for the configuration ``cfg``.  ``seed``: a numpy
    ``RandomState`` seed (0 to 2**32 - 1)."""
    s, g, nb = cfg["n_samples"], cfg["n_genes"], n_pools(cfg)
    n_cells, floor = cfg["n_cells"], cfg["min_cells"]
    if "cells_per_sample" in cfg:
        n_cells = s * cfg["cells_per_sample"]
        floor = min(floor, cfg["cells_per_sample"] // 2)
    rng = np.random.RandomState(seed)
    counts = cell_counts(rng, s, n_cells, cfg["cells_sigma"], floor)
    samplem = pd.DataFrame(index=pd.Index(np.arange(s), name="id"))
    samplem["dosage"] = dosages(rng, s, cfg["planted_maf"])
    samplem["male"] = rng.randint(0, 2, s)
    samplem["age"] = rng.uniform(cfg["age_min"], cfg["age_max"], s)
    for i in range(1, 7):
        samplem[f"gpc{i}"] = rng.randn(s)
    samplem["batch"] = rng.permutation(np.arange(s) % nb)
    dirs = rng.randn(nb, g)
    offsets = (cfg["batch_offset"] * np.sqrt(g)
               * dirs / np.linalg.norm(dirs, axis=1, keepdims=True))

    h = np.zeros((3, g))
    h[0, : g // 2] = 1
    h[1, g // 2:] = 1
    h[2, : g // 2] = 1
    h[2, : g // 4] = 2
    props = np.array([[0.2, -0.2], [-0.2, 0.0], [0.5, 0.5]])

    x = np.empty((int(counts.sum()), g), dtype=np.float32)
    lo = 0
    for i in range(s):
        c = int(counts[i])
        row = np.array([samplem["dosage"].iat[i] / 2.0,
                        samplem["male"].iat[i], 1])
        w = _mixture_weights(row @ props, c)
        x[lo:lo + c] = (w @ h + cfg["noise"] * rng.randn(c, g)
                        + offsets[samplem["batch"].iat[i]])
        lo += c
    obs = pd.DataFrame(
        {"id": np.repeat(samplem.index.to_numpy(), counts)},
        index=pd.Index([f"cell_{i}" for i in range(lo)], name="cell"))
    return x, obs.join(samplem, on="id"), samplem
