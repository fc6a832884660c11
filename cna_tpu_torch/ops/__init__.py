"""Compute kernels of the CNA pipeline: plain PyTorch ops, plus the
hand-written CUDA kernels for exact kNN (``ops.knn``) and IVF fine-block
scoring (``ops.ivf``), built at first use."""
from . import fdr, ftest, ivf, knn, linalg, moments, permutations, spmm
from ._build import launch_counts, reset_launch_counts

__all__ = ["fdr", "ftest", "ivf", "knn", "linalg", "moments", "permutations",
           "spmm", "launch_counts", "reset_launch_counts"]
