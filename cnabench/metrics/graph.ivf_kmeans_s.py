"""graph.ivf_kmeans_s: mean seconds per graph build of the program's
`ivf_kmeans` span (the IVF index's k-means fit and assignment)."""

from cnabench.metrics import mean_phase


def read(run):
    return mean_phase(run, "graph_build", "ivf_kmeans")
