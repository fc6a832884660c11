"""assoc.nam_s: mean seconds per association of the program's `nam`
phase (diffusion and the NAM's reindexing)."""

from cnabench.metrics import mean_phase


def read(run):
    return mean_phase(run, "association", "nam")
