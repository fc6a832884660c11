"""device_idle.assoc: percent of the traced window of association jobs in
which no kernel, copy or memset ran on the card."""

from cnabench.metrics import idle_share


def read(run):
    return idle_share(run, "association")
