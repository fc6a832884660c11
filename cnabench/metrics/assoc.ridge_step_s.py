"""assoc.ridge_step_s: the window's seconds of the program's `ridge_sweep`
spans over the ridge steps they counted (`ridges`): what one step of the
sweep costs (a projector, its product with the NAM, the batch kurtosis and
its median), apart from how many steps the stopping rule takes."""

from cnabench import counters


def read(run):
    if run.job != "association":
        return None
    spans = counters.spans("ridge_sweep") or ()
    seconds = sum(p["seconds"] for p in spans)
    steps = sum(p.get("ridges", 0) for p in spans)
    if not seconds or not steps:
        return None
    return seconds / steps
