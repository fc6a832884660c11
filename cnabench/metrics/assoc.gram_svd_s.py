"""assoc.gram_svd_s: mean seconds per association of the program's
`gram_svd` span (inside `residualize`: the standardization of the
residualized NAM, its S x S Gram and eigendecomposition, and the
neighbourhood loadings V).  A program without the span gives nothing to
read."""

from cnabench.metrics import mean_phase


def read(run):
    return mean_phase(run, "association", "gram_svd")
