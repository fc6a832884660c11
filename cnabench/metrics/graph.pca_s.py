"""graph.pca_s: mean seconds per graph build of the program's `pca` span
(the whole of `pp.pca`: the copy of X to the card, the covariance, the
host eigendecomposition, the projection and the scores' pull)."""

from cnabench.metrics import mean_phase


def read(run):
    return mean_phase(run, "graph_build", "pca")
