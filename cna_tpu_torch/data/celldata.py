"""AnnData-compatible in-memory data model.

The reference delegates its data model entirely to the external
``anndata.AnnData`` class (``X``, ``obs``, ``var``, ``obsp``, ``obsm``,
``uns`` — accessed at reference ``_nam.py:12-19,51`` and
``_association.py:228-237``).  ``CellData`` provides the same surface as a
first-class framework component, so the full pipeline runs without any
scanpy/anndata dependency while remaining duck-type compatible with real
AnnData objects (every cna_tpu_torch API accepts either).

A copy of the TPU package's ``data/celldata.py`` (numpy and pandas
only).
"""

from __future__ import annotations

import numpy as np
import pandas as pd


class CellData:
    """In-memory single-cell dataset: cells x genes plus annotations.

    Attributes mirror anndata.AnnData:
      X: (n_obs, n_vars) array (numpy) or None.
      obs: per-cell DataFrame (index = cell names).
      var: per-gene DataFrame (index = gene names).
      obsm: dict of per-cell arrays (e.g. 'X_pca', 'X_umap').
      obsp: dict of cell-cell pairwise matrices (e.g. 'connectivities').
      uns: unstructured metadata dict.
    """

    def __init__(self, X=None, obs=None, var=None, obsm=None, obsp=None,
                 uns=None, samplem=None, sid_name="id"):
        if X is not None:
            import scipy.sparse as sp

            if not sp.issparse(X):
                X = np.asarray(X)
            # sparse X stays sparse: a 1M-cell x 20k-gene atlas is ~80 GB
            # dense; every consumer (pp.pca, pp.select_hvg, io) streams it
        self.X = X

        if obs is None:
            n = X.shape[0] if X is not None else 0
            obs = pd.DataFrame(index=pd.RangeIndex(n).astype(str))
        self.obs = obs

        if var is None:
            n = X.shape[1] if X is not None else 0
            var = pd.DataFrame(index=pd.RangeIndex(n).astype(str))
        self.var = var

        self.obsm = dict(obsm) if obsm else {}
        self.obsp = dict(obsp) if obsp else {}
        self.uns = dict(uns) if uns else {}
        # optional sample-level metadata (multianndata-style convenience:
        # one row per sample, indexed by the ids in obs[sid_name])
        self.samplem = samplem
        self.sid_name = sid_name
        self._validate()

    def _validate(self):
        n = self.n_obs
        if self.X is not None and self.X.shape[0] != n:
            raise ValueError(
                f"X has {self.X.shape[0]} rows but obs has {n} entries")
        for key, val in self.obsm.items():
            if val.shape[0] != n:
                raise ValueError(f"obsm[{key!r}] has {val.shape[0]} rows, expected {n}")
        for key, val in self.obsp.items():
            if val.shape[:2] != (n, n):
                raise ValueError(f"obsp[{key!r}] has shape {val.shape}, expected ({n}, {n})")

    @property
    def n_obs(self) -> int:
        return len(self.obs)

    @property
    def n_vars(self) -> int:
        return len(self.var)

    @property
    def shape(self):
        return (self.n_obs, self.n_vars)

    @property
    def obs_names(self) -> pd.Index:
        return self.obs.index

    @property
    def var_names(self) -> pd.Index:
        return self.var.index

    def __getitem__(self, mask):
        """Cell-axis subset (boolean mask or index array) -> new CellData.

        Pairwise obsp matrices are subset on both axes; graph caches in
        ``uns`` are dropped since they no longer describe the subset.
        """
        if isinstance(mask, pd.Series):
            mask = mask.to_numpy()
        mask = np.asarray(mask)
        obs = self.obs.iloc[mask] if mask.dtype != bool else self.obs[mask]
        obsm = {k: v[mask] for k, v in self.obsm.items()}
        obsp = {}
        for k, v in self.obsp.items():
            sub = v[mask]
            obsp[k] = sub[:, mask]
        uns = {k: v for k, v in self.uns.items() if not k.startswith("_cna_tpu")}
        return CellData(
            X=self.X[mask] if self.X is not None else None,
            obs=obs.copy(), var=self.var, obsm=obsm, obsp=obsp, uns=uns)

    def write(self, path) -> None:
        """Write to an .h5ad file (``data.io_h5ad.write_h5ad``; needs
        h5py)."""
        from .io_h5ad import write_h5ad

        write_h5ad(self, path)

    def __repr__(self):
        parts = [f"CellData: {self.n_obs} cells x {self.n_vars} genes"]
        if len(self.obs.columns):
            parts.append(f"  obs: {list(self.obs.columns)}")
        if self.obsm:
            parts.append(f"  obsm: {list(self.obsm)}")
        if self.obsp:
            parts.append(f"  obsp: {list(self.obsp)}")
        return "\n".join(parts)
