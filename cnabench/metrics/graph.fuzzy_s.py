"""graph.fuzzy_s: mean seconds per graph build of the program's
`fuzzy_graph` phase (smooth kNN distances, the fuzzy union, the
symmetric ELL pack)."""

from cnabench.metrics import mean_phase


def read(run):
    return mean_phase(run, "graph_build", "fuzzy_graph")
