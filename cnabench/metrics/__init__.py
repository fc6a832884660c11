"""One reader a metric: ``metrics/<metric name>.py`` defines
``read(run)``, which returns the metric's value from a finished run, or
None where the run has nothing to read (the harness then leaves the
metric out of the line).

``run`` holds: ``job`` (the traffic's job kind), ``setup_s``,
``window_s``, ``walls`` (each job's seconds), ``phases`` (each job's
``utils.profiling`` phase seconds, traced runs only), ``trace`` (the
summary of the device trace of a few steady jobs, traced runs only:
``busy_s``, ``window_s``, ``kernel_s``), ``launches`` (per kernel, the
roofline thunks and CUDA events of its launches in that traced
sub-window) and
``device_name``.
"""

from __future__ import annotations

import importlib.util
from pathlib import Path

HERE = Path(__file__).resolve().parent


def load(name: str):
    path = HERE / f"{name}.py"
    if not path.exists():
        raise FileNotFoundError(f"no reader for metric {name!r} ({path})")
    spec = importlib.util.spec_from_file_location(
        "cnabench.metrics." + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def mean_phase(run, job, phase):
    """Mean seconds of ``phase`` per job, for jobs of kind ``job``."""
    if run.job != job or not run.phases:
        return None
    vals = [p.get(phase, 0.0) for p in run.phases]
    if not any(vals):
        return None
    return sum(vals) / len(vals)


def idle_share(run, job):
    if run.job != job or run.trace is None:
        return None
    t = run.trace
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])


def roofline_share(run, kernel):
    from .. import roofline

    if run.trace is None or not run.launches.get(kernel):
        return None
    return roofline.share(run.launches[kernel], run.device_name)
