from ._umap import umap_ncorr, umap_overlay
from ._strat import violinplot

__all__ = ["umap_ncorr", "umap_overlay", "violinplot"]
