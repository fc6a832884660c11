"""Scalable synthetic multi-sample single-cell data generator.

Generalizes the reference's demo fixture recipe (demo/makedata.ipynb
cells 2-5): samples carry case/male covariates; cells mix three
expression archetypes with covariate-driven proportions plus Gaussian
noise; batches tile over samples.  Used by the benchmark configs
(BASELINE.json 1-5: demo-scale through 1M-cell atlas-scale) and tests.

A numpy copy of the TPU package's ``data/synth.py``: the same seed gives
the same arrays, array for array.
"""

from __future__ import annotations

import numpy as np
import pandas as pd

from .celldata import CellData


def _mixture_weights(props, c):
    cell_ids = np.concatenate(
        [np.full(max(int(p * c), 0), i) for i, p in enumerate(props)])
    cell_ids = np.concatenate(
        [cell_ids[:c], np.full(max(c - len(cell_ids), 0), len(props))])
    w = np.zeros((c, len(props) + 1))
    w[np.arange(c), cell_ids] = 1
    return w


def synthetic_dataset(n_samples=50, cells_per_sample=200, n_genes=50,
                      noise=1.0, n_batches=5, seed=0, dtype=np.float32,
                      structure="archetypes"):
    """Generate (CellData, sample-metadata DataFrame with case/male/batch).

    Deterministic in ``seed``.  No graph is built — callers run
    ``pp.pca`` + ``pp.neighbors`` (or import one).
    ``dtype=np.float64`` keeps the downstream graph weights in f64 for
    bit-close golden comparisons; f32 is the throughput default.

    ``structure``:
      * 'archetypes' — the reference demo recipe: three discrete
        expression programs mixed by covariates.  Its kNN graph is
        expander-like within populations (worst case for locality).
      * 'manifold' — continuous trajectories: each cell gets a latent
        pseudotime on one of several branches, mapped through smooth
        random tuning curves; covariates shift branch usage.  Its kNN
        graph has the metric locality of real single-cell manifolds.
    """
    if structure == "manifold":
        return _manifold_dataset(n_samples, cells_per_sample, n_genes,
                                 noise, n_batches, seed, dtype)
    rng = np.random.RandomState(seed)

    covs = pd.DataFrame(index=pd.Series(np.arange(n_samples), name="id"))
    covs["case"] = (np.arange(n_samples) >= n_samples // 2).astype(int)
    q = n_samples // 4
    covs["male"] = np.concatenate([
        np.zeros(q), np.ones(q), np.zeros(q), np.ones(n_samples - 3 * q)
    ]).astype(int)
    covs["baseline"] = 1

    h = np.zeros((3, n_genes))
    h[0, : n_genes // 2] = 1
    h[1, n_genes // 2 :] = 1
    h[2, : n_genes // 2] = 1
    h[2, : n_genes // 4] = 2

    props = np.array([
        [0.2, -0.2],
        [-0.2, 0.0],
        [0.5, 0.5],
    ])

    blocks = []
    for _, row in covs.iterrows():
        w = _mixture_weights(
            row[["case", "male", "baseline"]].to_numpy() @ props,
            cells_per_sample)
        blocks.append(
            (w @ h + noise * rng.randn(cells_per_sample, n_genes))
            .astype(dtype))
    x = np.concatenate(blocks)

    obs = pd.DataFrame(
        {"id": np.repeat(covs.index.to_numpy(), cells_per_sample)},
        index=pd.Index([f"cell_{i}" for i in range(len(x))], name="cell"))
    var = pd.DataFrame(
        index=pd.Index([f"gene_{i}" for i in range(n_genes)], name="gene"))

    samplem = covs.drop(columns=["baseline"]).copy()
    samplem["batch"] = np.tile(
        np.arange(n_batches), -(-n_samples // n_batches))[:n_samples]
    obs = obs.join(samplem, on="id")

    d = CellData(X=x, obs=obs, var=var, samplem=samplem, sid_name="id")
    return d, samplem


def _manifold_dataset(n_samples, cells_per_sample, n_genes, noise, n_batches,
                      seed, dtype, n_branches=4, latent_dim=3):
    """Continuous-trajectory variant: see ``synthetic_dataset``."""
    rng = np.random.RandomState(seed)

    covs = pd.DataFrame(index=pd.Series(np.arange(n_samples), name="id"))
    covs["case"] = (np.arange(n_samples) >= n_samples // 2).astype(int)
    q = n_samples // 4
    covs["male"] = np.concatenate([
        np.zeros(q), np.ones(q), np.zeros(q), np.ones(n_samples - 3 * q)
    ]).astype(int)

    # branch geometry: smooth random curves in latent space
    n_knots = 8
    knots = rng.randn(n_branches, n_knots, latent_dim) * 2.0

    # smooth random map latent -> genes (random Fourier features)
    n_feat = 32
    w_feat = rng.randn(latent_dim, n_feat)
    b_feat = rng.uniform(0, 2 * np.pi, n_feat)
    w_gene = rng.randn(n_feat, n_genes) / np.sqrt(n_feat)

    blocks = []
    pseudotimes = []
    branches_all = []
    for sidx in range(n_samples):
        case = covs["case"].iloc[sidx]
        male = covs["male"].iloc[sidx]
        # covariates tilt the branch-usage distribution (the association
        # signal: case shifts cells toward branch 0, away from branch 1)
        logits = np.zeros(n_branches)
        logits[0] += 0.8 * case - 0.3 * male
        logits[1] -= 0.8 * case
        p_branch = np.exp(logits) / np.exp(logits).sum()
        br = rng.choice(n_branches, size=cells_per_sample, p=p_branch)
        t = rng.beta(2, 2, size=cells_per_sample)  # pseudotime in [0, 1]

        # piecewise-linear interpolation along the branch's knot curve
        pos = t * (n_knots - 1)
        lo = np.floor(pos).astype(int)
        hi = np.minimum(lo + 1, n_knots - 1)
        frac = (pos - lo)[:, None]
        latent = (knots[br, lo] * (1 - frac) + knots[br, hi] * frac)
        latent += 0.15 * rng.randn(cells_per_sample, latent_dim)

        feats = np.cos(latent @ w_feat + b_feat)
        expr = feats @ w_gene + noise * 0.3 * rng.randn(
            cells_per_sample, n_genes)
        blocks.append(expr.astype(dtype))
        pseudotimes.append(t)
        branches_all.append(br)

    x = np.concatenate(blocks)
    obs = pd.DataFrame(
        {
            "id": np.repeat(covs.index.to_numpy(), cells_per_sample),
            "pseudotime": np.concatenate(pseudotimes),
            "branch": np.concatenate(branches_all),
        },
        index=pd.Index([f"cell_{i}" for i in range(len(x))], name="cell"))
    var = pd.DataFrame(
        index=pd.Index([f"gene_{i}" for i in range(n_genes)], name="gene"))

    samplem = covs.copy()
    samplem["batch"] = np.tile(
        np.arange(n_batches), -(-n_samples // n_batches))[:n_samples]
    obs = obs.join(samplem[["case", "male", "batch"]], on="id")

    d = CellData(X=x, obs=obs, var=var, samplem=samplem, sid_name="id")
    return d, samplem
