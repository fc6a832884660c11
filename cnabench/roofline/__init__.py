"""Operations and bytes of each hand-written kernel, one module a kernel
(``roofline/<kernel>.py``), and the share of the roofline they give.

A kernel module names the program's functions that launch it
(``TARGETS``: (module, attribute) pairs, wrapped only while a traced
window runs) and ``count(args, kwargs)``, which returns a thunk that gives
the launch's (operations, bytes) once the trace has closed, so that
counting adds no work inside the traced window.  The wrapper records a
CUDA event on the launching stream before and after each call, so the
time read is that of exactly the launches whose work is counted.

The share is the least time the card could take (the larger of the
operations at the peak rate and the bytes at the peak bandwidth, from
``peaks.json``) over the device time of the launches.  The peak is the
card's dense bf16/fp16 rate, whatever type a kernel runs in today, so the
share reads the same work the same way under any implementation.
"""

from __future__ import annotations

import contextlib
import importlib
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent


def load(kernel: str):
    path = HERE / f"{kernel}.py"
    spec = importlib.util.spec_from_file_location(
        f"cnabench.roofline.{kernel}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def peaks(device_name: str):
    """(operations/s, bytes/s) of the card, or None where the table does
    not name it."""
    table = json.loads((HERE.parent / "peaks.json").read_text())
    for key, row in table["cards"].items():
        if key in device_name:
            return float(row["flops_per_s"]), float(row["bytes_per_s"])
    return None


@contextlib.contextmanager
def counting(kernel_names):
    """Wrap every target of the named kernels; yields {kernel: [(thunk,
    start event, stop event)]} (events None off the card)."""
    thunks = {k: [] for k in kernel_names}
    undo = []
    try:
        for k in kernel_names:
            mod = load(k)
            for modname, attr in mod.TARGETS:
                owner = importlib.import_module(modname)
                orig = getattr(owner, attr)

                def wrapped(*a, _orig=orig, _mod=mod, _k=k, **kw):
                    import torch

                    ev = (None, None)
                    if torch.cuda.is_available() \
                            and torch.cuda.is_initialized():
                        ev = tuple(torch.cuda.Event(enable_timing=True)
                                   for _ in range(2))
                        ev[0].record()
                    out = _orig(*a, **kw)
                    if ev[1] is not None:
                        ev[1].record()
                    thunks[_k].append((_mod.count(a, kw),) + ev)
                    return out

                setattr(owner, attr, wrapped)
                undo.append((owner, attr, orig))
        yield thunks
    finally:
        for owner, attr, orig in reversed(undo):
            setattr(owner, attr, orig)


def seconds(launches):
    """Device seconds of the launches (0 where they have no events)."""
    return sum(a.elapsed_time(b) * 1e-3 for _, a, b in launches
               if a is not None)


def share(launches, device_name):
    """Percent of the roofline, or None where nothing ran on a card or the
    card's peaks are unknown."""
    pk = peaks(device_name)
    secs = seconds(launches)
    if not launches or secs <= 0 or pk is None:
        return None
    flops = nbytes = 0.0
    for thunk, _, _ in launches:
        f, b = thunk()
        flops += f
        nbytes += b
    return 100.0 * max(flops / pk[0], nbytes / pk[1]) / secs
