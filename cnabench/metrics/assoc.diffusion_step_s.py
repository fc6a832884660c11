"""assoc.diffusion_step_s: the window's seconds of the program's
`diffusion` spans over the diffusion steps they counted (`steps`): what
one step of the adaptive diffusion costs, apart from how many steps the
stopping rule takes."""

from cnabench import counters


def read(run):
    if run.job != "association":
        return None
    spans = counters.spans("diffusion") or ()
    seconds = sum(p["seconds"] for p in spans)
    steps = sum(p.get("steps", 0) for p in spans)
    if not seconds or not steps:
        return None
    return seconds / steps
