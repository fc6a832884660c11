"""kmeans_assign_roofline: percent of its roofline that `kmeans_assign`
reached in the traced jobs (roofline/kmeans_assign.py, peaks.json)."""

from cnabench.metrics import roofline_share


def read(run):
    return roofline_share(run, "kmeans_assign")
