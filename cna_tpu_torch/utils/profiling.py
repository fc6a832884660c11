"""Per-phase wall-clock profiling.

``PhaseProfiler`` collects wall-clock time plus derived throughput
(cells/s, permutations/s) for each pipeline phase.  PyTorch returns
before the card finishes, so on cuda a phase synchronizes the device at
its end: the time is the phase's work, not its enqueue.  ``trace()``
records a ``torch.profiler`` trace (CPU and CUDA activity) into
``trace_dir``; phases inside it appear as named ranges.

Usage:
    prof = enable_profiling()
    with prof.phase("diffusion", cells=n_cells):
        ...
    prof.report()
"""

from __future__ import annotations

import contextlib
import time

import torch


# names of the phases open now, outermost first, whether or not the
# profiler records them (``utils.checks.FloatChecks`` names them)
_OPEN_PHASES: list[str] = []


def open_phases() -> tuple:
    return tuple(_OPEN_PHASES)


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


class PhaseProfiler:
    """Per-phase wall-clock collection with optional profiler ranges."""

    def __init__(self, enabled: bool = True, trace_dir: str | None = None):
        self.enabled = enabled
        self.trace_dir = trace_dir
        self.phases: list[dict] = []
        self._tracing = False

    @contextlib.contextmanager
    def phase(self, name: str, **counters):
        """Time a pipeline phase; counters (e.g. cells=N) derive rates."""
        _OPEN_PHASES.append(name)
        try:
            if not self.enabled:
                yield
                return
            ctx = (torch.profiler.record_function(name)
                   if self._tracing else contextlib.nullcontext())
            t0 = time.perf_counter()
            with ctx:
                yield
                _sync()
            dt = time.perf_counter() - t0
        finally:
            _OPEN_PHASES.pop()
        rec = {"phase": name, "seconds": dt}
        for key, val in counters.items():
            rec[key] = val
            rec[f"{key}_per_s"] = val / dt if dt > 0 else float("inf")
        self.phases.append(rec)

    @contextlib.contextmanager
    def trace(self):
        """Record a torch.profiler trace into ``trace_dir`` (chrome format)."""
        if not self.enabled or self.trace_dir is None:
            yield
            return
        import os

        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        os.makedirs(self.trace_dir, exist_ok=True)
        with profile(activities=acts) as prof:
            self._tracing = True
            try:
                yield
            finally:
                self._tracing = False
        prof.export_chrome_trace(os.path.join(self.trace_dir, "trace.json"))

    def report(self, out=print):
        total = sum(p["seconds"] for p in self.phases)
        for p in self.phases:
            rates = "  ".join(
                f"{k[:-6]}/s={p[k]:.3g}" for k in p if k.endswith("_per_s"))
            out(f"  {p['phase']:<24s} {p['seconds']*1000:9.1f} ms  {rates}")
        out(f"  {'TOTAL':<24s} {total*1000:9.1f} ms")
        return self.phases


_GLOBAL = PhaseProfiler(enabled=False)


def global_profiler() -> PhaseProfiler:
    return _GLOBAL


def enable_profiling(trace_dir: str | None = None) -> PhaseProfiler:
    global _GLOBAL
    _GLOBAL = PhaseProfiler(enabled=True, trace_dir=trace_dir)
    return _GLOBAL


def disable_profiling() -> None:
    """Stop recording phases (the state before ``enable_profiling``)."""
    global _GLOBAL
    _GLOBAL = PhaseProfiler(enabled=False)
