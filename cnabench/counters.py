"""Reading the program's span records (``cna_tpu_torch.utils.profiling``).

A traced run records the program's spans through its window and retires
the profiler before the metrics are read; ``last_session()`` returns it.
A program without counters, or without ``last_session``, gives nothing
to read: the readers then return None and the line leaves the metric
out.
"""

from __future__ import annotations


def spans(phase=None):
    """The window's span records (of name ``phase`` where given), or
    None where the program keeps no retired session."""
    try:
        from cna_tpu_torch.utils.profiling import last_session
    except ImportError:
        return None
    prof = last_session()
    if prof is None:
        return None
    return [p for p in prof.phases if phase is None or p["phase"] == phase]


def total(counter, phase=None):
    """The window's total of ``counter`` over every span (of name
    ``phase`` where given), or None where no span counted it."""
    vals = [p[counter] for p in spans(phase) or () if counter in p]
    return sum(vals) if vals else None


def per_job(run, job, counter):
    """The window's total of ``counter`` over its job count, for jobs of
    kind ``job``."""
    if run.job != job or not run.walls:
        return None
    n = total(counter)
    return None if n is None else n / len(run.walls)
