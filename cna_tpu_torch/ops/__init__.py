"""Compute kernels of the CNA pipeline: plain PyTorch ops, plus the
hand-written CUDA kernel for exact kNN (``ops.knn``, built at first use)."""
from . import fdr, ftest, knn, linalg, moments, permutations, spmm
from ._build import launch_counts, reset_launch_counts

__all__ = ["fdr", "ftest", "knn", "linalg", "moments", "permutations",
           "spmm", "launch_counts", "reset_launch_counts"]
