"""assoc.null_s: mean seconds per association of the program's `null`
span inside `test` (the nulls' copy or permutation, the null min-p
F-tests)."""

from cnabench.metrics import mean_phase


def read(run):
    return mean_phase(run, "association", "null")
