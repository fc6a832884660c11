"""graph.host_reads: tensors pulled to the host per graph build
(`host_reads`, counted by the program's `utils.transfer` in every span):
on a card each read waits for the queue to drain."""

from cnabench import counters


def read(run):
    return counters.per_job(run, "graph_build", "host_reads")
