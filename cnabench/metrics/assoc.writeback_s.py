"""assoc.writeback_s: mean seconds per association of the program's
`writeback` span (the per-cell coefficients and FDRs written into
`obs`)."""

from cnabench.metrics import mean_phase


def read(run):
    return mean_phase(run, "association", "writeback")
