"""A frozen numpy copy of the archetype recipe of
``cna_tpu_torch.data.synthetic_dataset`` (``structure='archetypes'``).

Both the program and the reference get their inputs from here, so a later
change to the package's generator cannot move the benchmark's data.  The
same seed gives the same arrays as the package's generator did when this
copy was made (``tests/test_cnabench_harness.py`` holds the two equal at a
small size).

Samples carry case / male covariates; each sample's cells mix three
expression programs with covariate-driven proportions, plus Gaussian
noise; batches tile over the samples.
"""

from __future__ import annotations

import numpy as np
import pandas as pd


def _mixture_weights(props, c):
    cell_ids = np.concatenate(
        [np.full(max(int(p * c), 0), i) for i, p in enumerate(props)])
    cell_ids = np.concatenate(
        [cell_ids[:c], np.full(max(c - len(cell_ids), 0), len(props))])
    w = np.zeros((c, len(props) + 1))
    w[np.arange(c), cell_ids] = 1
    return w


def archetypes(n_samples, cells_per_sample, n_genes=50, noise=1.0,
               n_batches=5, seed=0):
    """Return (x (N, G) float32, obs DataFrame with the sample id column
    ``id`` and the covariates, samplem DataFrame indexed by sample id with
    ``case``, ``male`` and ``batch``).  ``seed`` is a numpy
    ``RandomState`` seed (0 to 2**32 - 1)."""
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
    h[1, n_genes // 2:] = 1
    h[2, : n_genes // 2] = 1
    h[2, : n_genes // 4] = 2

    props = np.array([[0.2, -0.2], [-0.2, 0.0], [0.5, 0.5]])

    blocks = []
    for _, row in covs.iterrows():
        w = _mixture_weights(
            row[["case", "male", "baseline"]].to_numpy() @ props,
            cells_per_sample)
        blocks.append((w @ h + noise * rng.randn(cells_per_sample, n_genes))
                      .astype(np.float32))
    x = np.concatenate(blocks)

    obs = pd.DataFrame(
        {"id": np.repeat(covs.index.to_numpy(), cells_per_sample)},
        index=pd.Index([f"cell_{i}" for i in range(len(x))], name="cell"))
    samplem = covs.drop(columns=["baseline"]).copy()
    samplem["batch"] = np.tile(
        np.arange(n_batches), -(-n_samples // n_batches))[:n_samples]
    obs = obs.join(samplem, on="id")
    return x, obs, samplem
