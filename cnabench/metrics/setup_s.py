"""setup_s: seconds from the start of the process to the start of the
window: imports, the card, the inputs, the kernel build where it is
needed, and the warm-up jobs."""


def read(run):
    return run.setup_s
