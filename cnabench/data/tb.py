"""The tuberculosis-atlas deployment's inputs (``configs/tb_500k.json``):
the archetype recipe of ``data/synth.py`` on a cohort shaped like the
memory-T-cell atlas of Nathan et al., Nature 596:289 (2021) - samples of
unequal size, processed in batches that shift the expression, with donor
covariates.

From the seed: each sample's cell count (lognormal, at least a floor,
summing to the atlas's total), its TB status (a share of cases), sex, age,
a winter blood draw and a genetic-ancestry fraction, and its batch (the
samples dealt over the batches in a seeded order).  Each sample's cells
mix the recipe's three expression programs with proportions driven by
case and sex, plus Gaussian noise, plus their batch's offset: a seeded
vector in gene space, each gene's shift normal with spread
``batch_offset``.
"""

from __future__ import annotations

import numpy as np
import pandas as pd

from .synth import _mixture_weights


def cell_counts(rng, n_samples, n_cells, sigma, floor):
    """Cells of each sample: ``floor`` each, the rest dealt in proportion
    to lognormal weights of spread ``sigma`` (largest remainders first),
    summing to ``n_cells``."""
    if n_cells < n_samples * floor:
        raise ValueError(f"{n_cells} cells cannot give {n_samples} samples "
                         f"{floor} each")
    w = np.exp(sigma * rng.randn(n_samples))
    share = (n_cells - n_samples * floor) * w / w.sum()
    counts = np.floor(share).astype(np.int64)
    rest = n_cells - n_samples * floor - counts.sum()
    counts[np.argsort(counts - share, kind="stable")[:rest]] += 1
    return counts + floor


def tb_atlas(cfg, seed):
    """Return (x (N, G) float32, obs with the sample id column ``id``,
    samplem indexed by sample id with ``case``, ``male``, ``age``,
    ``winter``, ``ancestry`` and ``batch``) for the configuration ``cfg``.
    ``seed``: a numpy ``RandomState`` seed (0 to 2**32 - 1)."""
    s, g, nb = cfg["n_samples"], cfg["n_genes"], cfg["n_batches"]
    if s < 2 * nb:
        raise ValueError(f"{nb} batches need at least {2 * nb} samples; "
                         f"got {s}")
    rng = np.random.RandomState(seed)
    counts = cell_counts(rng, s, cfg["n_cells"], cfg["cells_sigma"],
                         cfg["min_cells"])
    samplem = pd.DataFrame(index=pd.Index(np.arange(s), name="id"))
    samplem["case"] = (rng.permutation(s)
                       < round(cfg["case_share"] * s)).astype(int)
    samplem["male"] = rng.randint(0, 2, s)
    samplem["age"] = rng.uniform(18.0, 70.0, s)
    samplem["winter"] = rng.randint(0, 2, s)
    samplem["ancestry"] = rng.beta(2.0, 5.0, s)
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
        row = np.array([samplem["case"].iat[i], samplem["male"].iat[i], 1])
        w = _mixture_weights(row @ props, c)
        x[lo:lo + c] = (w @ h + cfg["noise"] * rng.randn(c, g)
                        + offsets[samplem["batch"].iat[i]])
        lo += c
    obs = pd.DataFrame(
        {"id": np.repeat(samplem.index.to_numpy(), counts)},
        index=pd.Index([f"cell_{i}" for i in range(lo)], name="cell"))
    return x, obs.join(samplem, on="id"), samplem
