"""Compute kernels of the CNA pipeline: plain PyTorch ops, plus the
hand-written CUDA kernels for exact kNN (``ops.knn``), IVF fine-block
scoring (``ops.ivf``), the k-means assignment (``ops.kmeans``), the
diffusion step's gather SpMM (``ops.spmm``) and the banded diffusion SpMM
(``ops.spmm_banded``), built at first use."""
from . import (fdr, ftest, ivf, kmeans, knn, linalg, moments, permutations,
               spmm, spmm_banded)
from ._build import launch_counts, reset_launch_counts

__all__ = ["fdr", "ftest", "ivf", "kmeans", "knn", "linalg", "moments",
           "permutations", "spmm", "spmm_banded", "launch_counts",
           "reset_launch_counts"]
