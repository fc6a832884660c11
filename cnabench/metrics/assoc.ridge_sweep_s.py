"""assoc.ridge_sweep_s: mean seconds per association of the program's
`ridge_sweep` span (the cumulative ridge residualization over the batch
dummies and covariates, with its stopping rule).  Jobs without batches
open no such span."""

from cnabench.metrics import mean_phase


def read(run):
    return mean_phase(run, "association", "ridge_sweep")
