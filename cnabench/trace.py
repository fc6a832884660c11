"""Reading a ``torch.profiler`` chrome trace: device busy time, kernel
time by name, and what the host was doing while the device idled."""

from __future__ import annotations

import json
import re

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "python_function",
             "cuda_runtime", "cuda_driver")


def load(path):
    with open(path) as f:
        return json.load(f).get("traceEvents", [])


def _spans(events, cats):
    return [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)), e)
            for e in events
            if e.get("ph") == "X" and e.get("cat") in cats]


def _merge(spans):
    out = []
    for lo, hi, _ in sorted(spans, key=lambda s: s[0]):
        if out and lo <= out[-1][1]:
            out[-1][1] = max(out[-1][1], hi)
        else:
            out.append([lo, hi])
    return out


def short_name(name: str) -> str:
    """A kernel's name without its return type, anonymous namespace and
    arguments."""
    name = re.sub(r"^void ", "", name).replace("(anonymous namespace)::", "")
    depth, out = 0, []
    for ch in name:
        if ch == "(" and depth == 0:
            break
        depth += ch == "<"
        depth -= ch == ">"
        out.append(ch)
    return "".join(out)[:120]


def summarize(events):
    """dict(busy_s, kernel_s {short name: seconds}, device_ops top 10,
    idle_gaps top 10 by host activity, span_s the device-visible span)."""
    dev = _spans(events, DEVICE_CATS)
    busy = _merge(dev)
    busy_s = sum(hi - lo for lo, hi in busy) * 1e-6
    kernel_s = {}
    for lo, hi, e in dev:
        key = short_name(e.get("name", "?"))
        if e.get("cat") != "kernel":
            key = e.get("cat")
        kernel_s[key] = kernel_s.get(key, 0.0) + (hi - lo) * 1e-6
    host = _spans(events, HOST_CATS)
    gaps = {}
    for (_, a), (b, _) in zip(busy, busy[1:]):
        mid = (a + b) / 2
        inner = [s for s in host if s[0] <= mid <= s[1]]
        name = (min(inner, key=lambda s: s[1] - s[0])[2].get("name", "?")
                if inner else "host idle")
        gaps[name] = gaps.get(name, 0.0) + (b - a) * 1e-6
    top = sorted(kernel_s.items(), key=lambda kv: -kv[1])[:10]
    top_gaps = sorted(gaps.items(), key=lambda kv: -kv[1])[:10]
    return dict(busy_s=busy_s, kernel_s=kernel_s,
                device_ops=[[k, v] for k, v in top],
                idle_gaps=[[k, v] for k, v in top_gaps])
