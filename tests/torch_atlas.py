"""A small seeded atlas with batches and covariates for the port's CPU
tests of the batch path, and the inputs the plain reference
(``plain_reference/cna_batches.py``) takes for it."""

from __future__ import annotations

import numpy as np
import pandas as pd


def batch_atlas(seed, n_samples=40, n_batches=20, offset=0.3,
                offset_sigma=1.0, n_genes=20, nnull=200):
    """(x, obs, y, batches, covs, nulls): ``n_samples`` samples of 60 to
    120 cells mixing three expression programs by case status, each batch
    shifted by a seeded offset (lognormal size of spread ``offset_sigma``
    around ``offset``), three covariates, and ``nnull`` nulls of the
    standardized ``y`` permuted within batches."""
    rng = np.random.default_rng(seed)
    cells = rng.integers(60, 121, n_samples)
    case = rng.permutation(np.arange(n_samples) % 2)
    batch = rng.permutation(np.arange(n_samples) % n_batches)
    index = pd.Index([f"s{i:02d}" for i in range(n_samples)])
    covs = pd.DataFrame({"age": rng.uniform(18, 70, n_samples),
                         "male": rng.integers(0, 2, n_samples).astype(float),
                         "ancestry": rng.beta(2, 5, n_samples)}, index=index)
    h = np.zeros((3, n_genes))
    h[0, : n_genes // 2] = 1
    h[1, n_genes // 2:] = 1
    h[2, : n_genes // 4] = 2
    off = (rng.standard_normal((n_batches, n_genes)) * offset
           * np.exp(rng.standard_normal((n_batches, 1)) * offset_sigma))
    xs, ids = [], []
    for s in range(n_samples):
        p = np.array([0.3 + 0.3 * case[s], 0.3, 0.4 - 0.3 * case[s]])
        prog = rng.choice(3, cells[s], p=p / p.sum())
        xs.append(h[prog] + rng.standard_normal((cells[s], n_genes))
                  + off[batch[s]])
        ids += [index[s]] * cells[s]
    x = np.concatenate(xs)
    obs = pd.DataFrame({"id": ids}, index=[f"c{i}" for i in range(len(x))])
    y = pd.Series(case.astype(float), index=index)
    ystd = (y.to_numpy() - y.mean()) / y.to_numpy().std()
    nulls = np.empty((n_samples, nnull))
    for j in range(nnull):
        perm = np.arange(n_samples)
        for b in range(n_batches):
            w = np.flatnonzero(batch == b)
            perm[w] = rng.permutation(w)
        nulls[:, j] = ystd[perm]
    return x, obs, y, pd.Series(batch, index=index), covs, nulls


def sample_codes(obs, y):
    """Each cell's row in ``y``'s sample order (the reference's NAM rows)."""
    return pd.Index(y.index).get_indexer(obs["id"])
