"""assoc.batch_qc_s: mean seconds per association of the program's
`batch_qc` span (the batch-kurtosis QC of the NAM's neighbourhoods: the
per-batch means, their kurtosis, its read to the host, the gather of the
kept columns).  Jobs without batches open no such span."""

from cnabench.metrics import mean_phase


def read(run):
    return mean_phase(run, "association", "batch_qc")
