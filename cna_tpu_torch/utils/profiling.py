"""Spans and counters of the pipeline's phases.

``PhaseProfiler.phase(name, **counts)`` opens a span.  Its record holds
the name, the counts given, ``id``, ``parent`` (the id of the span open
around it, or None), ``root`` (the id of the outermost span: every span
of one job shares it), ``host_seconds`` (the host's clock from open to
close) and ``seconds``.

On cuda a span records a timing event on the current stream when it
opens and another when it closes, and never synchronizes the card.
``seconds`` is the interval between the two events on the card's own
timeline: from when the card has finished the work queued before the
span to when it has finished the span's own work.  A span that opens on
an idle card therefore reads its work, not its enqueue; one that opens
behind queued work starts when that work ends, so no time is counted
twice.  Without a card ``seconds`` is ``host_seconds``.  The events are
resolved when ``phases`` is read or the profiler is disabled, waiting
only on one that has not completed.

``count(name, n)`` adds ``n`` to counter ``name`` of the innermost open
span (``host_reads``: the tensors ``utils.transfer`` pulls to the host;
``steps``: the diffusion's steps; ``u``: an IVF search's probe count;
``mem_peak``: on the card, the allocator's peak bytes of the process when
an association closes).
``trace()`` records a ``torch.profiler`` trace (CPU and CUDA activity)
into ``trace_dir``; spans inside it appear as named ranges.

Usage:
    prof = enable_profiling()
    with prof.phase("diffusion", cells=n_cells):
        ...
        count("steps", n)
    prof.phases
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


def _on_card() -> bool:
    return torch.cuda.is_available() and torch.cuda.is_initialized()


class PhaseProfiler:
    """Spans with counters, timed on the card's timeline where there is
    one, with optional profiler ranges."""

    def __init__(self, enabled: bool = True, trace_dir: str | None = None):
        self.enabled = enabled
        self.trace_dir = trace_dir
        self._records: list[dict] = []
        self._open: list[dict] = []     # records of the open spans
        self._pending: list[tuple] = []  # (record, start, end) unresolved
        self._free_events: list = []
        self._next_id = 0
        self._tracing = False

    @property
    def phases(self) -> list[dict]:
        """The records of the closed spans, in the order they closed."""
        self._resolve()
        return self._records

    def _event(self):
        ev = (self._free_events.pop() if self._free_events
              else torch.cuda.Event(enable_timing=True))
        ev.record()
        return ev

    def _resolve(self) -> None:
        for rec, start, end in self._pending:
            if not end.query():
                end.synchronize()
            rec["seconds"] = start.elapsed_time(end) / 1e3
            self._free_events += (start, end)
        self._pending.clear()

    @contextlib.contextmanager
    def phase(self, name: str, **counts):
        """Record a span of the pipeline; ``counts`` (e.g. cells=N) start
        its counters."""
        _OPEN_PHASES.append(name)
        try:
            if not self.enabled:
                yield
                return
            parent = self._open[-1] if self._open else None
            rec = {"phase": name, "id": self._next_id,
                   "parent": None if parent is None else parent["id"],
                   "root": self._next_id if parent is None else parent["root"],
                   **counts}
            self._next_id += 1
            ctx = (torch.profiler.record_function(name)
                   if self._tracing else contextlib.nullcontext())
            self._open.append(rec)
            try:
                with ctx:
                    start = self._event() if _on_card() else None
                    t0 = time.perf_counter()
                    yield
                    rec["host_seconds"] = time.perf_counter() - t0
                    if start is None:
                        rec["seconds"] = rec["host_seconds"]
                    else:
                        self._pending.append((rec, start, self._event()))
            finally:
                self._open.pop()
            self._records.append(rec)
        finally:
            _OPEN_PHASES.pop()

    def count(self, name: str, n=1) -> None:
        """Add ``n`` to counter ``name`` of the innermost open span."""
        if self._open:
            rec = self._open[-1]
            rec[name] = rec.get(name, 0) + n

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


_GLOBAL = PhaseProfiler(enabled=False)
_LAST: PhaseProfiler | None = None


def global_profiler() -> PhaseProfiler:
    return _GLOBAL


def count(name: str, n=1) -> None:
    """Add ``n`` to counter ``name`` of the global profiler's innermost
    open span (nothing while profiling is off)."""
    _GLOBAL.count(name, n)


def enable_profiling(trace_dir: str | None = None) -> PhaseProfiler:
    global _GLOBAL, _LAST
    _GLOBAL = PhaseProfiler(enabled=True, trace_dir=trace_dir)
    _LAST = None
    return _GLOBAL


def disable_profiling() -> None:
    """Stop recording phases (the state before ``enable_profiling``); the
    retired profiler, its events resolved, stays readable through
    ``last_session()``."""
    global _GLOBAL, _LAST
    if _GLOBAL.enabled:
        _GLOBAL._resolve()
        _LAST = _GLOBAL
    _GLOBAL = PhaseProfiler(enabled=False)


def last_session() -> PhaseProfiler | None:
    """The profiler the last ``disable_profiling()`` retired, until the
    next ``enable_profiling()``."""
    return _LAST
