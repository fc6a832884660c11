"""assoc.residualize_s: mean seconds per association of the program's
`residualize` span (covariate and batch residualization, the Gram SVD of
the residualized NAM)."""

from cnabench.metrics import mean_phase


def read(run):
    return mean_phase(run, "association", "residualize")
