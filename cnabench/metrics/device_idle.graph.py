"""device_idle.graph: percent of the traced window of graph builds in
which no kernel, copy or memset ran on the card."""

from cnabench.metrics import idle_share


def read(run):
    return idle_share(run, "graph_build")
