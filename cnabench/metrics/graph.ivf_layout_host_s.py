"""graph.ivf_layout_host_s: mean seconds per graph build of the program's
`ivf_layout_host` span (the kd order of the clusters and the block layout
of the IVF index, on the host)."""

from cnabench.metrics import mean_phase


def read(run):
    return mean_phase(run, "graph_build", "ivf_layout_host")
