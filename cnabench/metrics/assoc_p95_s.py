"""assoc_p95_s: the 95th percentile (linear interpolation) of the
seconds of every association of the window."""

import numpy as np


def read(run):
    if run.job != "association" or not run.walls:
        return None
    return float(np.percentile(np.asarray(run.walls), 95))
