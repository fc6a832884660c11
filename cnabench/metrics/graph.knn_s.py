"""graph.knn_s: mean seconds per graph build of the program's `knn`
phase (the exact kernel, or the IVF build and search with its `ivf_*`
phases)."""

from cnabench.metrics import mean_phase


def read(run):
    return mean_phase(run, "graph_build", "knn")
