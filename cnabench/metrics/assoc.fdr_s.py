"""assoc.fdr_s: mean seconds per association of the program's `fdr` span
inside `test` (the threshold grid with its host read, the null
coefficients and their tail counts or histogram)."""

from cnabench.metrics import mean_phase


def read(run):
    return mean_phase(run, "association", "fdr")
