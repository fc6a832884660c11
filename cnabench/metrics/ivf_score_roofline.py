"""ivf_score_roofline: percent of its roofline that `ivf_score` reached
in the traced jobs (roofline/ivf_score.py, peaks.json)."""

from cnabench.metrics import roofline_share


def read(run):
    return roofline_share(run, "ivf_score")
