"""diffusion_step_roofline: percent of its bytes roofline that the
association's diffusion steps reached in the traced jobs
(roofline/diffusion_step.py, peaks.json)."""

from cnabench.metrics import roofline_share


def read(run):
    return roofline_share(run, "diffusion_step")
