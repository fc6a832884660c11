"""assoc_s: seconds of the window over the associations completed in it
(the window runs until the first job that ends after the deadline)."""


def read(run):
    if run.job != "association" or not run.walls:
        return None
    return run.window_s / len(run.walls)
