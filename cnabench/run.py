"""Run one cell of the benchmark once and print its result line.

    python3 -m cnabench.run --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout.  The cell (``BENCHMARK.json``'s
``workloads``) names a configuration (``cnabench/configs/<config>.json``)
and a traffic mix (``cnabench/traffic/<mix>.json``, whose ``job`` names a
kind, ``cnabench/kinds/<job>.py``).  Set-up makes the inputs from ``--seed`` and warms
up; the window then runs jobs back to back, one client, until the first
job that ends after ``--seconds``.  With ``--trace 0`` the line carries the
cell's end-to-end metrics; with ``--trace 1`` the program's phases are
recorded through the window and a few steady jobs run under
``torch.profiler``, and the line carries the per-layer metrics, read by
``cnabench/metrics/<metric>.py``.  After the window the kept answers are
judged against the reference (``cnabench.judge``) and held to
``cnabench/limits/<workload>.json``: ``correct``, and the numbers with
their limits as the line's last key and the last lines of standard error.

Exits non-zero without a result where there is no CUDA card (or fewer than
the cell asks for), and where ``jax``, ``jaxlib``, ``flax`` or
``cna_tpu`` is loaded once the window has closed.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import warnings  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "cna_tpu")


def _environment():
    """Fixed cache directories inside the checkout, and no JAX from any
    library that would load it by itself."""
    os.environ["TRITON_CACHE_DIR"] = str(HERE / "_cache" / "triton")
    os.environ["TORCHINDUCTOR_CACHE_DIR"] = str(HERE / "_cache" / "inductor")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def forbidden_modules():
    """Loaded modules whose top-level name is a JAX one or the JAX
    package's (whole names: ``cna_tpu_torch`` is not ``cna_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def load_json(path):
    return json.loads(Path(path).read_text())


def cell_files(bench, workload):
    """(cell, config, traffic, limits) of ``workload``."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(ROOT / configs[cell["config"]]["file"])
    traffic = load_json(HERE / "traffic" / f"{cell['traffic']}.json")
    limits = load_json(HERE / "limits" / f"{workload}.json")
    return cell, config, traffic, limits


def cell_metrics(bench, workload, trace):
    """The metric entries this cell reports in a run of ``trace``."""
    entries = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in entries
            if "workloads" not in m or workload in m["workloads"]]


def hold(numbers, limits):
    """[(name, value, op, limit, ok)] of every limited number."""
    rows = []
    for name, lim in limits["numbers"].items():
        val = numbers.get(name)
        if "max" in lim:
            op, bound = "<=", lim["max"]
            ok = val is not None and val == val and val <= bound
        else:
            op, bound = ">=", lim["min"]
            ok = val is not None and val == val and val >= bound
        rows.append((name, val, op, bound, ok))
    return rows


class Run:
    """What the metric readers read (``cnabench.metrics``)."""

    def __init__(self, job, device_name):
        self.job = job
        self.device_name = device_name
        self.setup_s = None
        self.window_s = None
        self.walls = []
        self.phases = []
        self.trace = None
        self.launches = {}


def _err(*parts):
    print(*parts, file=sys.stderr, flush=True)


def run_cell(bench, workload, seed, seconds, trace, device="cuda",
             config_overrides=None, traffic_overrides=None):
    """Set up, run the window, judge.  Returns (result dict, checks
    rows, every number the judge read).  ``*_overrides`` resize a cell
    for tests on the CPU."""
    import torch

    import cna_tpu_torch as ct
    from cna_tpu_torch.utils import profiling

    from . import kinds, roofline
    from . import metrics as readers
    from . import trace as trace_mod

    cell, config, traffic, limits = cell_files(bench, workload)
    config.update(config_overrides or {})
    traffic.update(traffic_overrides or {})
    ct.config.set_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    on_card = torch.device(device).type == "cuda"
    name = torch.cuda.get_device_name(0) if on_card else "cpu"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    kind = kinds.load(traffic["job"])(config, traffic, seed, device)
    t_setup = time.perf_counter()
    kind.setup(ct)
    if trace and on_card:
        # the profiler's first session initializes CUPTI: do it here
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]):
            torch.ones(1, device=device).add_(1)
            sync()
    sync()
    run = Run(kind.name, name)
    run.setup_s = time.perf_counter() - T_START
    _err(f"# setup_s {run.setup_s:.3f}: imports and the card "
         f"{t_setup - T_START:.3f}, {kind.name} set-up "
         f"{time.perf_counter() - t_setup:.3f} "
         f"({json.dumps(kind.setup_seconds)})")

    prof = None
    tmp = None
    if trace:
        tmp = tempfile.mkdtemp(prefix="cnabench-trace-")
        prof = profiling.enable_profiling(trace_dir=tmp)
    t_from, t_jobs = traffic["trace_from"], traffic["trace_jobs"]
    kernels = [m["name"][: -len("_roofline")]
               for m in cell_metrics(bench, workload, True)
               if m["name"].endswith("_roofline")]
    t0 = time.perf_counter()
    deadline = t0 + seconds
    i = 0
    traced = None
    while True:
        if trace and i == t_from:
            traced = _Traced(prof, kernels, roofline)
        n_ph = len(prof.phases) if prof else 0
        tj = time.perf_counter()
        answer = kind.run(i)
        sync()
        te = time.perf_counter()
        run.walls.append(te - tj)
        if prof:
            ph = {}
            for p in prof.phases[n_ph:]:
                ph[p["phase"]] = ph.get(p["phase"], 0.0) + p["seconds"]
            run.phases.append(ph)
        kind.keep(i, answer)
        del answer
        i += 1
        if traced is not None and i == t_from + t_jobs:
            traced.close()
        if te >= deadline and (not trace or i >= t_from + t_jobs):
            break
    run.window_s = te - t0
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    if trace:
        profiling.disable_profiling()
        events = trace_mod.load(Path(tmp) / "trace.json")
        run.trace = trace_mod.summarize(events)
        run.trace["window_s"] = traced.seconds
        run.launches = traced.thunks
        for f in Path(tmp).iterdir():
            f.unlink()
        Path(tmp).rmdir()
    metrics = {}
    for m in cell_metrics(bench, workload, trace):
        val = readers.load(m["name"]).read(run)
        if val is not None:
            metrics[m["name"]] = {"value": float(val), "unit": m["unit"]}
    run.launches = {}

    t_judge = time.perf_counter()
    out = kind.collect()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    numbers, info = kind.judge(out, device)
    rows = hold(numbers, limits)
    correct = all(r[4] for r in rows)
    device_rec = {"platform": "gpu" if on_card else "cpu", "kind": name,
                  "count": cell["chips"], "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": len(run.walls),
              "failed": 0 if correct else len(info.get("jobs",
                                                       info.get("builds",
                                                                []))),
              "metrics": metrics, "device": device_rec}
    if trace:
        device_rec["busy_s"] = run.trace["busy_s"]
        device_rec["window_s"] = run.trace["window_s"]
        result["breakdown"] = {"device_ops": run.trace["device_ops"],
                               "idle_gaps": run.trace["idle_gaps"]}
    _err("# info", json.dumps({"numbers": numbers, **info,
                               "judge_s": time.perf_counter() - t_judge,
                               "window_jobs": len(run.walls),
                               "walls": wall_summary(run.walls)},
                              default=str))
    result["checks"] = {r[0]: {"value": r[1], "limit": r[3], "op": r[2]}
                        for r in rows}
    return result, rows, numbers


def wall_summary(walls):
    """Quartiles of the window's job seconds, and the mean of its first
    and last thirds: whether a run's jobs drift or stay level."""
    if len(walls) < 4:
        return None
    third = max(1, len(walls) // 3)
    return {"quartiles": statistics.quantiles(walls, n=4),
            "first_third": statistics.fmean(walls[:third]),
            "last_third": statistics.fmean(walls[-third:])}


class _Traced:
    """The traced sub-window: the program's profiler trace and the
    roofline counters, from its first job to its last."""

    def __init__(self, prof, kernels, roofline):
        self._trace = prof.trace()
        self._count = roofline.counting(kernels)
        self.thunks = self._count.__enter__()
        self._trace.__enter__()
        self.t0 = time.perf_counter()
        self.seconds = None

    def close(self):
        self.seconds = time.perf_counter() - self.t0
        self._trace.__exit__(None, None, None)
        self._count.__exit__(None, None, None)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _environment()
    bench = load_json(ROOT / "BENCHMARK.json")
    cell, _, _, _ = cell_files(bench, args.workload)

    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        _err(f"cnabench: the cell needs {cell['chips']} CUDA card(s); "
             f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 3
    warnings.filterwarnings("ignore")
    result, rows, _ = run_cell(bench, args.workload, args.seed,
                               args.seconds, bool(args.trace))
    found = forbidden_modules()
    if found:
        _err(f"cnabench: modules that must not load were loaded: {found}")
        return 4
    for name, val, op, bound, ok in rows:
        _err(f"check {name} {val!r} {op} {bound!r} "
             f"{'ok' if ok else 'FAILED'}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
