"""assoc.test_s: mean seconds per association of the program's `test`
phase (null F-tests, null coefficients and FDR, the host pulls)."""

from cnabench.metrics import mean_phase


def read(run):
    return mean_phase(run, "association", "test")
