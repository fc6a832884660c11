"""Preprocessing: HVG selection, PCA, kNN search, graph construction and
the UMAP layout on the device."""
from .hvg import select_hvg
from .pca import pca, pca_array
from .knn import knn_search
from .ivf import ivf_knn
from .neighbors import neighbors, fuzzy_connectivities
from .umap import umap

__all__ = ["select_hvg", "pca", "pca_array", "knn_search", "ivf_knn",
           "neighbors", "fuzzy_connectivities", "umap"]
