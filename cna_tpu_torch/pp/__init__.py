"""Preprocessing: PCA, kNN search, and graph construction on the device."""
from .pca import pca, pca_array
from .knn import knn_search
from .ivf import ivf_knn
from .neighbors import neighbors, fuzzy_connectivities

__all__ = ["pca", "pca_array", "knn_search", "ivf_knn", "neighbors",
           "fuzzy_connectivities"]
