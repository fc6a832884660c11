"""knn_exact_roofline: percent of its roofline that `knn_exact` reached
in the traced jobs (roofline/knn_exact.py, peaks.json)."""

from cnabench.metrics import roofline_share


def read(run):
    return roofline_share(run, "knn_exact")
