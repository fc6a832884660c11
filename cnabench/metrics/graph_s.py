"""graph_s: seconds of the window over the graph builds (pp.pca then
pp.neighbors) completed in it."""


def read(run):
    if run.job != "graph_build" or not run.walls:
        return None
    return run.window_s / len(run.walls)
